"""Paged KV cache managed by a HashMem page table (the JAX package's
``core/paged_kv.py``): the paper's virtualization layer (§2.4-2.5) applied
to serving.

  * a KV "page" holds ``page_tokens`` tokens of one sequence: the
    bucket-per-page mapping (logical bucket = (seq, block index));
  * the page table is a ``repro_torch.core.hashmap.HashMem``: key =
    seq_id * MAX_BLOCKS + block, value = physical page id.  Allocation is
    ``pim_malloc`` from per-arena free lists; freeing a sequence writes
    tombstones (paper deletion semantics, a ``hashmap.delete`` whose find
    launches the ``probe_perf`` kernel on a ``perf`` table on the card) and
    recycles the physical pages.

The cache functions work on tensors of one device: ``append``,
``prefill_pages`` and ``paged_decode_attention`` (the gather path).  Unlike
JAX's functional ``.at[].set``, ``append`` and ``prefill_pages`` write the
pools IN PLACE and return them: at Qwen3-8B's widths the pools are 19 GB,
and a copy a step would double that.  Where two rows of a batch write one
(page, offset) -- an idle decode slot keeps its stale block table and
appends into pages recycled to another sequence -- every duplicate writes
the value of the LAST row in batch order, which is where JAX's scatter
lands on the CPU, so the result does not depend on the order the device
applies the writes in.  Page ids must lie in the pool (the allocator's);
JAX would drop an out-of-range write.

Pool layout (grouped), as JAX's: the flat page pool is sharded jointly
over ALL mesh axes.  Rank (batch group g, channel m) of a
``launch.mesh.ModelMesh`` owns physical pages [flat*pps, (flat+1)*pps),
flat = g*Dm + m, and holds only those (``pages_per_shard`` = pps pages a
pool).  Sequence b belongs to batch group g(b); its logical page j lives on
channel j mod Dm.  The channel-parallel variants run on such a rank:
``append_sharded`` writes a token on the rank that owns its page, and
``decode_attention_sharded`` attends over the rank's pages and combines the
channels' partial softmax with a log-sum-exp (JAX's ``pmax`` of the maxima,
then ``psum`` of the rescaled numerators and denominators; the port
gathers every channel's (m, l, acc) in one ``all_gather`` and reduces on
each rank, one collective where two all-reduces cost twice the latency):
the paper's §2.5 parallel probing of pages spread over channels, as
flash-decoding.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.layout import resolve_device

NEG_INF = -1e30
F32 = torch.float32


# ---------------------------------------------------------------------------
# Pools
# ---------------------------------------------------------------------------

def init_pool(num_pages: int, page_tokens: int, kv_heads: int, head_dim: int,
              dtype=torch.bfloat16, device=None):
    dev = resolve_device(device)
    shape = (num_pages, page_tokens, kv_heads, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def _write_rows(rows: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                keep: torch.Tensor | None = None):
    """``rows[idx] = src`` in place for the entries ``keep`` marks (all by
    default; the rest are dropped, as JAX drops out-of-range writes), every
    duplicate index writing the value of its last kept occurrence in
    ``idx`` (JAX's CPU scatter order).  An (n, n) compare on the device,
    with no host sync: dropped entries rewrite row 0's current value unless
    a kept one writes row 0."""
    n = idx.shape[0]
    if keep is None:
        keep = torch.ones(n, dtype=torch.bool, device=idx.device)
    idx = torch.where(keep, idx, 0)
    order = torch.arange(n, device=idx.device)
    writer = (idx[:, None] == idx[None, :]) & keep[None, :]
    last = torch.where(writer, order[None, :], -1).amax(1)
    new = src[last.clamp(min=0)].to(rows.dtype)
    lost = (last < 0).view(-1, *([1] * (new.dim() - 1)))
    rows[idx] = torch.where(lost, rows[idx], new)


# ---------------------------------------------------------------------------
# Local (single-device) paths
# ---------------------------------------------------------------------------

@torch.no_grad()
def append(k_pool, v_pool, block_table, pos, k_new, v_new):
    """Write one new token per sequence into its tail page, in place (a
    cache write: no autograd graph).
    block_table (B, n_pages), pos (B,), k_new/v_new (B, 1, K, hd).  A
    ``pos`` past the table (a sliding-window arch, whose table spans window
    + one page, decoding beyond it) writes nothing, as in JAX."""
    P, pt = k_pool.shape[:2]
    pos = pos.to(torch.int64)
    j = pos // pt
    keep = j < block_table.shape[1]    # JAX drops a write past the table
    page = block_table.gather(1, torch.where(keep, j, 0)[:, None])[:, 0]
    idx = page.to(torch.int64) * pt + pos % pt
    _write_rows(k_pool.view(P * pt, *k_pool.shape[2:]), idx, k_new[:, 0],
                keep)
    _write_rows(v_pool.view(P * pt, *v_pool.shape[2:]), idx, v_new[:, 0],
                keep)
    return k_pool, v_pool


def _partial_decode(q, k, v, positions, pos, window):
    """Partial attention.  q (B,K,G,hd); k/v (B,T,K,hd); positions (B,T)
    absolute token positions (-1 = invalid).  Returns (m, l, acc) for the
    log-sum-exp combine."""
    hd = q.shape[-1]
    s = q.to(F32) @ k.to(F32).permute(0, 2, 3, 1) * (hd ** -0.5)  # (B,K,G,T)
    valid = (positions >= 0) & (positions <= pos[:, None])
    if window:
        valid &= positions > (pos[:, None] - window)
    valid = valid[:, None, None]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = p @ v.to(F32).permute(0, 2, 1, 3)                      # (B,K,G,hd)
    return m, l, acc


def paged_decode_attention(q, k_pool, v_pool, block_table, pos, cfg):
    """Single-device decode attention (gather path): q (B,1,H,hd) against
    every page of each row's block table, positions past ``pos`` masked."""
    B, _, H, hd = q.shape
    K = k_pool.shape[2]
    G = H // K
    pt = k_pool.shape[1]
    qg = q.reshape(B, K, G, hd)
    n_pages = block_table.shape[1]
    bt = block_table.to(torch.int64)
    k = k_pool[bt].reshape(B, n_pages * pt, K, hd)
    v = v_pool[bt].reshape(B, n_pages * pt, K, hd)
    positions = torch.arange(n_pages * pt, device=q.device)[None, :] \
        .expand(B, -1)
    m, l, acc = _partial_decode(qg, k, v, positions, pos.to(torch.int64),
                                cfg.sliding_window)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Channel-parallel (on a rank of a ModelMesh: JAX's shard_map body)
# ---------------------------------------------------------------------------

@torch.no_grad()
def append_sharded(k_pool, v_pool, block_table, pos, k_new, v_new, mesh,
                   batch_axes, channel_axes, pages_per_shard: int):
    """Owner-channel append, in place: the local pools hold this rank's
    ``pages_per_shard`` pages; block_table (B_loc, n_pages) holds global
    page ids.  A row whose page another rank owns, or whose ``pos`` lies
    past the table, writes nothing."""
    P, pt = k_pool.shape[:2]
    me_flat = mesh.index(tuple(batch_axes) + tuple(channel_axes))
    pos = pos.to(torch.int64)
    j = pos // pt
    keep = j < block_table.shape[1]
    page = block_table.gather(1, torch.where(keep, j, 0)[:, None])[:, 0]
    page = page.to(torch.int64)
    keep &= (page // pages_per_shard) == me_flat
    idx = (page % pages_per_shard) * pt + pos % pt
    _write_rows(k_pool.view(P * pt, *k_pool.shape[2:]), idx, k_new[:, 0],
                keep)
    _write_rows(v_pool.view(P * pt, *v_pool.shape[2:]), idx, v_new[:, 0],
                keep)
    return k_pool, v_pool


def decode_attention_sharded(q, k_pool, v_pool, block_table, pos, cfg, mesh,
                             batch_axes, channel_axes, pages_per_shard: int):
    """q (B_loc,1,H,hd) the local batch, every head; the pools this rank's
    page slice; block_table (B_loc, n_pages) global page ids.  The rank
    reads its logical pages j = me_m (mod Dm), masks those it does not own,
    and the channels' (m, l, acc) combine over ``channel_axes``."""
    B, _, H, hd = q.shape
    K = k_pool.shape[2]
    G = H // K
    pt = k_pool.shape[1]
    qg = q.reshape(B, K, G, hd)
    n_pages = block_table.shape[1]
    Dm = mesh.size(channel_axes)
    me_m = mesh.index(channel_axes)
    me_flat = mesh.index(tuple(batch_axes) + tuple(channel_axes))
    nl = max(n_pages // Dm, 1)
    dev = q.device
    # logical pages j = me_m (mod Dm)
    local_bt = block_table[:, :nl * Dm].reshape(B, nl, Dm)[:, :, me_m] \
        .to(torch.int64)
    mine = (local_bt // pages_per_shard) == me_flat      # allocator guarantee
    slot = torch.where(mine, local_bt % pages_per_shard, 0)
    k = k_pool[slot].reshape(B, nl * pt, K, hd)
    v = v_pool[slot].reshape(B, nl * pt, K, hd)
    j_log = torch.arange(nl, device=dev) * Dm + me_m
    positions = j_log[:, None] * pt + torch.arange(pt, device=dev)[None, :]
    positions = torch.where(mine[:, :, None], positions[None], -1) \
        .reshape(B, nl * pt)
    m, l, acc = _partial_decode(qg, k, v, positions, pos.to(torch.int64),
                                cfg.sliding_window)
    # LSE combine across channels only (batch axes hold distinct sequences):
    # every channel's (m, l, acc) in one all_gather, then JAX's pmax and
    # psum on each rank, in channel order
    parts = mesh.all_gather(torch.cat([m[..., None], l[..., None], acc],
                                      dim=-1)[None], channel_axes)
    m, l, acc = parts[..., 0], parts[..., 1], parts[..., 2:]
    r = torch.exp(m - m.amax(0))
    num = (acc * r[..., None]).sum(0)
    den = (l * r).sum(0)
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


@torch.no_grad()
def prefill_pages(k_pool, v_pool, block_table, k, v):
    """Scatter prefill KV (B,S,K,hd) into pages, in place (no autograd
    graph).  S must be a
    multiple of page_tokens; block_table (B, >=S/pt)."""
    B, S, K, hd = k.shape
    pt = k_pool.shape[1]
    n = S // pt
    idx = block_table[:, :n].reshape(-1).to(torch.int64)
    _write_rows(k_pool, idx, k.reshape(B * n, pt, K, hd))
    _write_rows(v_pool, idx, v.reshape(B * n, pt, K, hd))
    return k_pool, v_pool


# ---------------------------------------------------------------------------
# Serving layer: the HashMem page-table manager (host side)
# ---------------------------------------------------------------------------

class PageTableManager:
    """Page table = HashMem; pim_malloc = per-owner free-list arenas.

    Keys are seq_id * max_blocks + block_idx (uint32); values are physical
    page ids.  ``block_table`` resolves the dense table by PROBING the
    hashmap through the table's backend (the CUDA kernels on the card).

    ``num_channels`` x ``num_groups`` arenas follow the JAX grouped layout:
    arena c owns physical ids [c*pps, (c+1)*pps), and ``alloc_seqs`` places
    logical page j of a sequence of group g in arena g*Dm + (j % Dm).  The
    table lives on ``device`` (None: the card; "cpu" runs the plain
    versions).
    """

    MAX_BLOCKS = 1 << 12
    CHAIN_CHECK_EVERY = 4   # frees between compact_chain_len device walks

    def __init__(self, total_pages: int, num_channels: int = 1,
                 num_groups: int = 1, hashmem_cfg=None, backend: str = "ref",
                 compact_chain_len: int | None = None, device=None):
        from repro_torch.configs import HashMemConfig
        from repro_torch.core import hashmap

        arenas = num_channels * num_groups
        assert total_pages % arenas == 0
        self.Dm = num_channels
        self.groups = num_groups
        self.pps = total_pages // arenas
        self.total_pages = total_pages
        cfg = hashmem_cfg or HashMemConfig(
            num_buckets=max(64, total_pages // 4), slots_per_page=128,
            overflow_pages=max(64, total_pages // 8), max_chain=8,
            backend=backend)
        if compact_chain_len is not None:
            cfg = dataclasses.replace(cfg, compact_chain_len=compact_chain_len)
        self.cfg = cfg
        self.hm = hashmap.create(cfg, device=device)
        self.free = [list(range(c * self.pps, (c + 1) * self.pps))[::-1]
                     for c in range(arenas)]
        self.owned: dict[int, list[int]] = {}
        self.grow_events = 0
        self.compact_events = 0
        self._tombstones = 0        # host-side count; avoids device syncs
        self._frees_since_chain_check = 0   # throttles the device chain walk

    def _key(self, seq_id: int, block: int) -> int:
        assert block < self.MAX_BLOCKS
        return seq_id * self.MAX_BLOCKS + block

    def _return_pages(self, pages):
        for p in pages:
            self.free[p // self.pps].append(p)

    def alloc_seq(self, seq_id: int, n_blocks: int, group: int = 0) -> np.ndarray:
        return self.alloc_seqs([(seq_id, n_blocks, group)])[seq_id]

    def alloc_seqs(self, reqs) -> dict:
        """Coalesced allocation: ``reqs`` is [(seq_id, n_blocks, group), ...];
        pages for ALL sequences are claimed from the arenas and their table
        entries land in ONE batched HashMem insert.  Returns {seq_id:
        (n_blocks,) int32 phys}."""
        from repro_torch.core import hashmap
        from repro_torch.core.hashing import validate_user_keys
        # the key-domain guard, before any page is claimed so a rejected
        # request leaks nothing; each request's largest key is its last block
        if reqs:
            validate_user_keys(
                np.asarray([self._key(s, max(n - 1, 0))
                            for s, n, _ in reqs], np.int64),
                where="page-table alloc")
        phys, keys, spans = [], [], []
        for seq_id, n_blocks, group in reqs:
            start = len(phys)
            for j in range(n_blocks):
                arena = self.free[group * self.Dm + j % self.Dm]
                if not arena:
                    self._return_pages(phys)        # no partial-alloc leak
                    raise MemoryError("pim_malloc: PR_ERROR (arena exhausted)")
                p = arena.pop()
                phys.append(p)
                keys.append(self._key(seq_id, j))
            spans.append((seq_id, start, len(phys)))
        if not phys:
            # zero-block sequences still get their (empty) entries
            out = {}
            for seq_id, _, _ in spans:
                self.owned.setdefault(seq_id, [])
                out[seq_id] = np.empty((0,), np.int32)
            return out
        k = np.asarray(keys, np.uint32)
        v = np.asarray(phys, np.uint32)
        if self.cfg.auto_grow:
            # arena exhaustion / chain overflow in the page table triggers a
            # resize instead of a dropped allocation
            before = self.hm.config.num_pages
            self.hm, ok = hashmap.insert_auto(self.hm, k, v)
            if self.hm.config.num_pages != before:   # arena REBUILT (an
                # extendible doubling keeps num_pages and every tombstone)
                self.grow_events += 1
                self.cfg = self.hm.config
                self._tombstones = 0                # the rebuild dropped them
        else:
            self.hm, ok = hashmap.insert(self.hm, k, v)
        if not bool(ok.all()):
            self._return_pages(phys)
            raise MemoryError("page-table insert failed (PR_ERROR)")
        out = {}
        for seq_id, a, b in spans:
            self.owned.setdefault(seq_id, []).extend(phys[a:b])
            out[seq_id] = np.asarray(phys[a:b], np.int32)
        return out

    def block_table(self, seq_ids, n_blocks: int) -> np.ndarray:
        """Resolve the (B, n_blocks) dense table by probing the HashMem."""
        from repro_torch.core import hashmap
        B = len(seq_ids)
        keys = np.asarray([[self._key(s, j) for j in range(n_blocks)]
                           for s in seq_ids], np.uint32).reshape(-1)
        vals, found = hashmap.probe(self.hm, keys)
        vals = torch.where(found, vals, 0)  # unallocated blocks -> page 0
        return vals.cpu().numpy().astype(np.int32).reshape(B, n_blocks)

    def free_seq(self, seq_id: int):
        """Tombstone the table entries (paper §2.5) and recycle pages."""
        self.free_seqs([seq_id])

    def free_seqs(self, seq_ids):
        """Coalesced free: every finished sequence's table entries are
        tombstoned in ONE batched HashMem delete."""
        from repro_torch.core import hashmap
        keys, pages = [], []
        for seq_id in seq_ids:
            own = self.owned.pop(seq_id, [])
            keys.extend(self._key(seq_id, j) for j in range(len(own)))
            pages.extend(own)
        if not pages:
            return
        self.hm, _ = hashmap.delete(self.hm, np.asarray(keys, np.uint32))
        # every owned key was inserted, so every delete tombstones one slot;
        # counting on the host avoids a device reduction and sync per free
        self._tombstones += len(keys)
        self._return_pages(pages)
        self.maybe_compact()

    def maybe_compact(self):
        """Reclaim tombstoned page-table slots on either of two triggers:
        tombstones exceed ``compact_tombstone_frac`` of capacity, or (with
        ``compact_chain_len`` > 0) a bucket chain exceeds that many pages
        while tombstones exist.  The chain walk syncs with the device, so
        it runs every ``CHAIN_CHECK_EVERY`` checks.  Called from every free
        and from the decode loop's step clock (``tick``)."""
        from repro_torch.core import hashmap
        cfg = self.hm.config
        trigger = hashmap.compact_due(self.hm, self._tombstones, chain=False)
        if (not trigger and cfg.compact_chain_len > 0
                and self._tombstones > 0):
            self._frees_since_chain_check += 1
            if self._frees_since_chain_check >= self.CHAIN_CHECK_EVERY:
                self._frees_since_chain_check = 0
                trigger = hashmap.compact_due(self.hm, self._tombstones,
                                              fraction=False)
        if trigger:
            self.hm = hashmap.compact(self.hm)
            self.compact_events += 1
            self._tombstones = 0
            self._frees_since_chain_check = 0

    def tick(self):
        """Step-clock maintenance: re-run the compaction triggers, so a
        sequence mix that stops freeing still gets its tombstones
        reclaimed.  The decode loop calls this once per step."""
        self.maybe_compact()

    def live_pages(self) -> int:
        return sum(len(v) for v in self.owned.values())
