"""The dry-run's sLSTM extrapolation against whole traces, at smoke widths.

xlstm's long train and prefill cells are traced with each sLSTM loop cut
to ``dryrun.SLSTM_STEPS`` steps and their counts extrapolated to the
sequence (``dryrun._extrapolate``).  For xlstm-1.3b's smoke config at one
unit (an sLSTM and an mLSTM layer), batch 2, this traces each step whole
at each sequence length given and prints, beside it, the extrapolation
from the two probes: FLOPs and bytes (exact: linear in the steps) and the
peak of the live storages, which the extrapolation can only
underestimate (a lower bound).

    PYTHONPATH=src python tools/slstm_peak_check.py [--seqs 32 64 128 256]
"""
from __future__ import annotations

import argparse

from repro_torch.configs import OptimConfig, ShapeConfig, smoke_config
from repro_torch.launch import dryrun


def whole_and_extrapolated(kind: str, S: int):
    """(the whole trace's counts, the extrapolation's) of xlstm's smoke
    ``kind`` ("train" or "prefill") step at S tokens."""
    cfg = smoke_config("xlstm-1.3b").replace(num_layers=2)      # one unit
    shape = ShapeConfig("t", S, 2, kind)

    def trace(limit):
        if kind == "train":
            return dryrun.trace_train(cfg, OptimConfig(), shape,
                                      slstm=limit).counts
        return dryrun.trace_prefill(cfg, shape, slstm=limit).counts
    s1, s2 = dryrun.SLSTM_STEPS
    return trace(None), dryrun._extrapolate(trace(s1), trace(s2), s1, s2, S)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seqs", type=int, nargs="+", default=[32, 64, 128, 256])
    args = ap.parse_args()
    print("kind | S | FLOPs extrapolated / whole | bytes | peak (temp) "
          "whole | extrapolated | extrapolated / whole")
    for kind in ("train", "prefill"):
        for S in args.seqs:
            whole, got = whole_and_extrapolated(kind, S)
            print(f"{kind} | {S} | {got.flops / whole.flops:.6f} | "
                  f"{got.bytes / whole.bytes:.6f} | {whole.temp:.0f} | "
                  f"{got.temp:.0f} | {got.temp / whole.temp:.4f}",
                  flush=True)


if __name__ == "__main__":
    main()
