"""Plain PyTorch versions of the HashMem probes (the JAX package's
``kernels/ref.probe_pages_ref`` and ``probe_bitplanes_ref``).

Contract, shared with the CUDA kernels in ``probe_perf.py`` and
``probe_area.py`` (``probe_bitplanes_ref`` and ``probe_bitserial.py`` take
the bit-planes beside the pool)::

    probe_pages_ref(pool (P,S,2) int32 [lane 0 = key, lane 1 = value],
                    queries (Q,) int32, pages (Q,C) int32 [-1 = skip])
        -> out (Q,4) int32 lanes [value, found, page, slot]

All words are uint32 bits.  The first match in chain order wins, then the
lowest slot; a query with no match gets [0, 0, 0, 0].  A page id past the end
of the pool reads the last row, as JAX's clamped gather does.

Each gathers every (query, chain step) row at once, so it works in chunks
of queries that keep the gather near 1 GiB.  The tests, the CPU path and the
kernel checks on the card use them.
"""
from __future__ import annotations

import torch

GATHER_BYTES = 1 << 30
MASK32 = 0xFFFFFFFF


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


def probe_bitplanes_ref(planes: torch.Tensor, pool: torch.Tensor,
                        queries: torch.Tensor, pages: torch.Tensor,
                        key_bits: int) -> torch.Tensor:
    """The bit-serial compare on the (P, b, W) int32 bit-planes: a slot
    matches when its low ``key_bits`` key bits equal the query's (all 32
    bits for b = 32).  The first matching word in chain order holds the
    first match; its lowest set bit is the slot.  The value comes from the
    pool's value lane.  Same (Q, 4) lanes as ``probe_pages_ref``."""
    qn, C = pages.shape
    P, b, W = planes.shape
    if b != key_bits or pool.shape[1] != 32 * W:
        raise ValueError(f"planes {tuple(planes.shape)} do not fit pool "
                         f"{tuple(pool.shape)} at key_bits={key_bits}")
    dev = pool.device
    out = torch.zeros((qn, 4), dtype=torch.int32, device=dev)
    j = torch.arange(b, device=dev)
    i = torch.arange(32, device=dev)
    chunk = max(1, GATHER_BYTES // max(1, C * b * W * 4))
    for lo in range(0, qn, chunk):
        hi = min(qn, lo + chunk)
        n = hi - lo
        pg = pages[lo:hi].long()
        safe = pg.clamp(0, P - 1)
        rows = planes[safe]                                   # (Qc, C, b, W)
        qwords = -((queries[lo:hi, None].long() >> j) & 1)    # 0 or all ones
        mism = torch.zeros((n, C, W), dtype=torch.int64, device=dev)
        for k in range(b):
            mism |= rows[:, :, k, :].long() ^ qwords[:, k, None, None]
        match = (~mism & MASK32) * (pg >= 0)[:, :, None]      # (Qc, C, W)
        flat = match.reshape(n, C * W)
        found = (flat != 0).any(dim=1)
        idx = (flat != 0).to(torch.uint8).argmax(dim=1)        # first word
        word = flat[torch.arange(n, device=dev), idx]
        low = word & -word                                    # lowest set bit
        bit = (((low - 1)[:, None] >> i) & 1).sum(dim=1)
        c = idx // W
        slot = torch.where(found, (idx % W) * 32 + bit, 0)
        val = pool[safe[torch.arange(n, device=dev), c], slot, 1]
        page = pg.gather(1, c[:, None])[:, 0]
        lanes = torch.stack([val, torch.ones_like(val), page.to(torch.int32),
                             slot.to(torch.int32)], dim=1)
        out[lo:hi] = torch.where(found[:, None], lanes, 0)
    return out
