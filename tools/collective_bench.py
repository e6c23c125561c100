#!/usr/bin/env python3
"""Time the collectives of decode over ranks two ways, with every rank on
one card over gloo: gloo on the CUDA tensor (gloo waits for the stream and
stages it through the host itself), and the tensor staged by the caller (a
copy to host memory, gloo on the CPU tensor, a copy back).

    PYTHONPATH=src python3 tools/collective_bench.py [--ranks 4] [--threads 1]

For each size (bytes a rank) it prints the median ms a call of
``all_reduce`` (SUM) and ``all_gather`` by rank 0, the card idle, and with
a (2048, 4096) x (4096, 4096) bfloat16 product queued on each rank before
each call (a decode layer's work, roughly).  Needs a card; ``--device
cpu`` runs the gloo-on-CPU path alone (no staging to compare)."""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SIZES = (2 << 10, 64 << 10, 256 << 10, 1 << 20)
CALLS = 40


def _one(op, t, group, staged):
    x = t.cpu() if staged else t
    if op == "all_reduce":
        dist.all_reduce(x, group=group)
        if staged:
            t.copy_(x)
        return t
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return torch.cat(out).to(t.device) if staged else out


def bench(mesh, threads):
    if threads:
        torch.set_num_threads(threads)
    dev = mesh.device
    a = torch.randn(2048, 4096, device=dev, dtype=torch.bfloat16)
    b = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
    rows = []
    modes = [False] + ([True] if dev.type == "cuda" else [])
    for size in SIZES:
        t = torch.ones(size // 4, device=dev)
        for op in ("all_reduce", "all_gather"):
            for busy in (False, True):
                for staged in modes:
                    times = []
                    for i in range(CALLS + 5):
                        if busy:
                            a @ b
                        dist.barrier()
                        t0 = time.perf_counter()
                        _one(op, t, mesh.group, staged)
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
                        if i >= 5:
                            times.append((time.perf_counter() - t0) * 1e3)
                    rows.append((size, op, busy, staged,
                                 float(np.median(times))))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--threads", type=int, default=0,
                    help="intra-op threads a rank (0: PyTorch's default)")
    args = ap.parse_args(argv)
    from repro_torch.launch.mesh import spawn_ranks
    out = spawn_ranks(bench, args.ranks, args.threads, backend="gloo",
                      device=args.device, timeout=300)
    print(f"{args.ranks} ranks over gloo on {args.device}, "
          f"{args.threads or 'default'} intra-op threads a rank, "
          f"{torch.get_num_threads()} by default here; median ms a call "
          f"(rank 0; max over ranks in brackets), {CALLS} calls")
    for i, (size, op, busy, staged, ms) in enumerate(out[0]):
        worst = max(r[i][4] for r in out)
        print(f"  {size:>8d} B  {op:<10s} {'busy' if busy else 'idle'}  "
              f"{'staged by the caller' if staged else 'gloo on the tensor'}"
              f"  {ms:8.3f} ({worst:.3f})")


if __name__ == "__main__":
    main()
