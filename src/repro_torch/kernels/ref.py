"""Plain PyTorch version of the HashMem probe (the JAX package's
``kernels/ref.probe_pages_ref``).

Contract, shared with the CUDA kernel in ``probe_perf.py``::

    probe_pages_ref(pool (P,S,2) int32 [lane 0 = key, lane 1 = value],
                    queries (Q,) int32, pages (Q,C) int32 [-1 = skip])
        -> out (Q,4) int32 lanes [value, found, page, slot]

All words are uint32 bits.  The first match in chain order wins, then the
lowest slot; a query with no match gets [0, 0, 0, 0].  A page id past the end
of the pool reads the last row, as JAX's clamped gather does.

It gathers every (query, chain step) row at once, so it works in chunks of
queries that keep the (Qc, C, S, 2) gather near 1 GiB.  The tests, the CPU
path and the kernel check on the card use it.
"""
from __future__ import annotations

import torch

GATHER_BYTES = 1 << 30


def probe_pages_ref(pool: torch.Tensor, queries: torch.Tensor,
                    pages: torch.Tensor) -> torch.Tensor:
    qn, C = pages.shape
    P, S, _ = pool.shape
    out = torch.zeros((qn, 4), dtype=torch.int32, device=pool.device)
    chunk = max(1, GATHER_BYTES // max(1, C * S * 8))
    for lo in range(0, qn, chunk):
        hi = min(qn, lo + chunk)
        n = hi - lo
        pg = pages[lo:hi].long()
        rows = pool[pg.clamp(0, P - 1)].reshape(n, C * S, 2)   # (Qc, C*S, 2)
        match = (rows[..., 0] == queries[lo:hi, None]) \
            & (pg >= 0).repeat_interleave(S, dim=1)
        found = match.any(dim=1)
        idx = match.to(torch.uint8).argmax(dim=1)             # first match
        val = rows[torch.arange(n, device=pool.device), idx, 1]
        page = pg.gather(1, (idx // S)[:, None])[:, 0]
        lanes = torch.stack([val, torch.ones_like(val), page.to(torch.int32),
                             (idx % S).to(torch.int32)], dim=1)
        out[lo:hi] = torch.where(found[:, None], lanes, 0)
    return out
