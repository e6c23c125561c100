"""The port's dry-run grid as one Markdown table row a cell.

Reads the records ``python -m repro_torch.launch.dryrun --all --mesh both
--probe full --out DIR`` writes and prints, for every assigned cell
(``repro_torch.configs.cells``), its single-mesh record: a rank's
parameter, optimizer and decode-state GiB, the estimated peak (a lower
bound where the sLSTM's steps were scaled) and whether it fits one
card's 80 GB (yes, no, or unknown where a lower bound fits), FLOPs and
eager op bytes a device, the collectives (calls by kind, bytes in JAX's
form), the trace seconds, and whether the multi-pod mesh's record is
ok.  A cell without a record, or
whose record failed, prints its error.

    PYTHONPATH=src python tools/dryrun_table.py DIR
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs import cells
from repro_torch.launch.dryrun import JAX_KINDS, report_name

GIB = 2 ** 30


def _load(d: Path, arch, shape, mesh):
    path = d / report_name(arch, shape, mesh, "full")
    return json.loads(path.read_text()) if path.exists() else None


def _calls(rec) -> str:
    c = rec["collectives"]
    short = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS",
             "all-to-all": "A2A"}
    return " ".join(f"{short[k]} {c['_count_' + k]}"
                    for k in JAX_KINDS.values() if "_count_" + k in c) or "-"


def row(d: Path, arch: str, shape: str) -> str:
    rec = _load(d, arch, shape, "single")
    multi = _load(d, arch, shape, "multi")
    multi_ok = "no record" if multi is None else (
        "ok" if multi.get("ok") else "FAIL")
    if rec is None or not rec.get("ok"):
        why = "no record" if rec is None else rec.get("error", "")[:120]
        return f"| {arch} | {shape} | failed: {why} |" + " |" * 10 + \
            f" {multi_ok} |"
    peak = f"{rec['peak_memory_in_bytes'] / GIB:.2f}"
    if rec.get("peak_is_lower_bound"):
        peak = f">= {peak} (sLSTM scaled)"
    fits = {True: "yes", False: "no", None: "unknown"}[rec["fits_card"]]
    return (f"| {arch} | {shape} | {rec['params_bytes'] / GIB:.3f} | "
            f"{rec['opt_bytes'] / GIB:.3f} | {rec['state_bytes'] / GIB:.3f} | "
            f"{peak} | {fits} | {rec['flops_per_device']:.3e} | "
            f"{rec['bytes_per_device']:.3e} | {_calls(rec)} | "
            f"{rec['collectives']['total_bytes']:.3e} | "
            f"{rec['trace_s']:.1f} | {multi_ok} |")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dir")
    args = ap.parse_args()
    d = Path(args.dir)
    print("| arch | shape | params GiB | opt GiB | state GiB | est. peak GiB "
          "| fits 80 GB | FLOPs/dev | bytes/dev | collectives | coll. bytes "
          "| trace s | multi-pod |")
    print("|" + "---|" * 13)
    for arch, shape in cells():
        print(row(d, arch, shape))


if __name__ == "__main__":
    main()
