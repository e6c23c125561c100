"""Backend dispatch for HashMem probes (the JAX package's ``core/probe.py``).

Four backends, each on the store's (P, S, 2) pool:

  * ``"perf"`` and ``"area"``: on a pool on the card the CUDA kernel runs, or
    the call raises; on a pool on the CPU the plain version runs;
  * ``"bitserial"``: the same, on the store's bit-plane lane, which only a
    table built with ``backend="bitserial"`` keeps;
  * ``"ref"``: the plain version, on either device (an explicit backend, as
    in JAX, not a fallback).

The (Q, C) page schedule may hold -1 holes anywhere.
"""
from __future__ import annotations

import torch

from repro_torch.core.layout import PageStore, from_bits
from repro_torch.kernels import ops


def probe_lanes(store: PageStore, queries: torch.Tensor, pages: torch.Tensor,
                backend: str) -> torch.Tensor:
    """(Q, 4) int32 lanes [value, found, page, slot] from one backend.
    ``queries`` are int32 bits, ``pages`` int32."""
    pool = store.pool
    if backend == "ref":
        return ops.probe_ref(pool, queries, pages)
    if backend == "perf":
        return ops.probe_perf(pool, queries, pages)
    if backend == "area":
        return ops.probe_area(pool, queries, pages)
    if backend == "bitserial":
        if store.planes is None:
            raise ValueError("bitserial backend requires planes "
                             "(backend='bitserial' at build)")
        return ops.probe_bitserial(store.planes, pool, queries, pages,
                                   store.key_bits)
    raise ValueError(f"unknown probe backend {backend!r}")


def probe_pages(store: PageStore, queries: torch.Tensor, pages: torch.Tensor,
                backend: str):
    """Dispatch a resolved probe (RLU command stream) to a compare backend.
    Returns (values (Q,) int64 uint32-values, found (Q,) bool)."""
    out = probe_lanes(store, queries, pages, backend)
    return from_bits(out[:, 0]), out[:, 1] != 0
