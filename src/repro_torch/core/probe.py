"""Backend dispatch for HashMem probes (the JAX package's ``core/probe.py``).

This slice ports two backends:

  * ``"perf"``: on a pool on the card the CUDA kernel runs, or the call
    raises; on a pool on the CPU the plain version runs;
  * ``"ref"``: the plain version, on either device (an explicit backend, as
    in JAX, not a fallback).

``"area"`` and ``"bitserial"`` are not ported yet (ROADMAP Queue 2 items 2
and 3).  The (Q, C) page schedule may hold -1 holes anywhere.
"""
from __future__ import annotations

import torch

from repro_torch.core.layout import from_bits
from repro_torch.kernels import ops

_BACKENDS = {"perf": ops.probe_perf, "ref": ops.probe_ref}


def probe_lanes(pool: torch.Tensor, queries: torch.Tensor,
                pages: torch.Tensor, backend: str) -> torch.Tensor:
    """(Q, 4) int32 lanes [value, found, page, slot] from one backend.
    ``queries`` are int32 bits, ``pages`` int32."""
    if backend not in _BACKENDS:
        raise NotImplementedError(
            f"probe backend {backend!r} is not ported (ROADMAP Queue 2)")
    return _BACKENDS[backend](pool, queries, pages)


def probe_pages(hm, queries: torch.Tensor, pages: torch.Tensor,
                backend: str):
    """Dispatch a resolved probe (RLU command stream) to a compare backend.
    Returns (values (Q,) int64 uint32-values, found (Q,) bool)."""
    out = probe_lanes(hm.store.pool, queries, pages, backend)
    return from_bits(out[:, 0]), out[:, 1] != 0
