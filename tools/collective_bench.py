#!/usr/bin/env python3
"""Time the collectives of decode over ranks two ways, with every rank on
one card over gloo: gloo on the CUDA tensor (gloo waits for the stream and
stages it through the host itself), and the tensor staged by the caller (a
copy to host memory, gloo on the CPU tensor, a copy back).

    PYTHONPATH=src python3 tools/collective_bench.py [--ranks 4] [--threads 1]
    PYTHONPATH=src python3 tools/collective_bench.py --kinds

For each size (bytes a rank) it prints the median ms a call of
``all_reduce`` (SUM) and ``all_gather`` by rank 0, the card idle, and with
a (2048, 4096) x (4096, 4096) bfloat16 product queued on each rank before
each call (a decode layer's work, roughly).  ``--kinds`` instead times the
four kinds training over ranks issues (``all_gather`` as a list, as
``all_gather_into_tensor`` and as an ``all_to_all_single`` of n copies,
``reduce_scatter`` as ``reduce_scatter_tensor`` and as an ``all_reduce``
and a cut, ``all_reduce``, ``all_to_all_single``) at 1, 16 and 64 MB a
rank on the tensor, and says which the backend refuses.  Needs a card; ``--device
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


KIND_SIZES = (1 << 20, 16 << 20, 64 << 20)
KIND_CALLS = 5


def _kind(op, t, group, n):
    if op == "all_gather":
        out = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(out, t, group=group)
    elif op == "all_gather_into_tensor":
        dist.all_gather_into_tensor(t.new_empty(n * t.numel()), t,
                                    group=group)
    elif op == "all_gather as all_to_all":
        x = t.expand(n, -1).contiguous()
        dist.all_to_all_single(torch.empty_like(x), x, group=group)
    elif op == "reduce_scatter_tensor":
        rs = getattr(dist, "reduce_scatter_single",
                     dist.reduce_scatter_tensor)
        rs(t.new_empty(t.numel() // n), t, group=group)
    elif op == "all_reduce+cut":
        x = t.clone()
        dist.all_reduce(x, group=group)
        x.narrow(0, 0, t.numel() // n).clone()
    elif op == "all_reduce":
        dist.all_reduce(t, group=group)
    else:
        dist.all_to_all_single(torch.empty_like(t), t, group=group)


def bench_kinds(mesh, threads):
    """[(bytes a rank, op, median ms or the error)] on rank ``mesh.rank``."""
    if threads:
        torch.set_num_threads(threads)
    n = dist.get_world_size(mesh.group)
    rows = []
    for size in KIND_SIZES:
        t = torch.ones(size // 4, device=mesh.device)
        for op in ("all_gather", "all_gather_into_tensor",
                   "all_gather as all_to_all", "reduce_scatter_tensor",
                   "all_reduce+cut", "all_reduce", "all_to_all"):
            times = []
            try:
                for i in range(KIND_CALLS + 1):
                    dist.barrier()
                    t0 = time.perf_counter()
                    _kind(op, t, mesh.group, n)
                    if t.device.type == "cuda":
                        torch.cuda.synchronize(t.device)
                    if i:
                        times.append((time.perf_counter() - t0) * 1e3)
                rows.append((size, op, float(np.median(times))))
            except RuntimeError as e:       # what the backend refuses
                rows.append((size, op, f"refused: {str(e)[:120]}"))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--threads", type=int, default=0,
                    help="intra-op threads a rank (0: PyTorch's default)")
    ap.add_argument("--kinds", action="store_true",
                    help="time training's four kinds of collective")
    args = ap.parse_args(argv)
    from repro_torch.launch.mesh import spawn_ranks
    if args.kinds:
        out = spawn_ranks(bench_kinds, args.ranks, args.threads,
                          backend="gloo", device=args.device, timeout=300)
        print(f"{args.ranks} ranks over gloo on {args.device}: median ms a "
              f"call of {KIND_CALLS} after one (rank 0; max over ranks in "
              f"brackets)")
        for i, (size, op, ms) in enumerate(out[0]):
            if isinstance(ms, str):
                print(f"  {size:>9d} B  {op:<22s} {ms}")
                continue
            worst = max(r[i][2] for r in out)
            print(f"  {size:>9d} B  {op:<22s} {ms:9.3f} ({worst:.3f}) = "
                  f"{size / ms / 1e6:.3f} GB/s a rank")
        return
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
