"""HashMem structure in PyTorch: the chained, rebuild-mode subset of the JAX
package's ``core/hashmap.py`` (paper §2.4-2.5, §3).

  * bucket i owns page i; overflow pages are chained through ``page_next``;
  * ``free_top`` is the ``pim_malloc`` bump allocator over the overflow arena;
  * delete writes TOMBSTONE_KEY and never reuses the slot (paper §2.5);
  * probing resolves the page chain (the RLU command stream) and hands the
    page list to a backend (``core/probe.py``);
  * ``grow`` rebuilds into a larger arena and ``compact`` at the same size,
    re-bucketing every live entry (and re-packing the bit-planes of a
    bit-serial table); ``insert_auto`` grows when a batch would pass
    ``max_load_factor`` or when an element is refused.

Keys and values enter as uint32 (numpy arrays or tensors) and are carried as
int64 tensors holding [0, 2**32) (``hashing.as_u32``); the pool stores their
bits as int32.  A table with ``backend="bitserial"`` also keeps the
bit-plane lane (``layout.pack_bitplanes``) in step with its keys.  Every
function gives the same state and results as its JAX counterpart, bit for
bit, including the order of duplicate keys (stable sorts) and JAX's clamped
gathers and dropped scatters.  Like the JAX structure, every mutation
returns a new HashMem and leaves the old one as it was.

Entry points that make a table take ``device=None``, which means the card;
only ``device="cpu"`` runs on the CPU.  Operations on a table run on the
table's device.

Not ported yet (``create`` raises, naming the ROADMAP item): fingerprint
lane, displacement and stash (Queue 1 item 6), extendible resize (item 7).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs import HashMemConfig
from repro_torch.core import layout
from repro_torch.core.hashing import as_u32, hash_to_bucket
from repro_torch.core.layout import (EMPTY_BITS, TOMBSTONE_BITS, from_bits,
                                     resolve_device, to_bits)

I32 = torch.int32
I64 = torch.int64

LEAVES = ("pool", "page_next", "page_fill", "free_top", "bucket_head")


@dataclass
class HashMem:
    store: layout.PageStore       # interleaved pool + page bookkeeping
    bucket_head: torch.Tensor     # (num_buckets,) int32
    config: HashMemConfig

    @property
    def device(self) -> torch.device:
        return self.store.pool.device

    @property
    def key_pages(self) -> torch.Tensor:   # (num_pages, slots) int32 bits
        return self.store.key_pages

    @property
    def val_pages(self) -> torch.Tensor:   # (num_pages, slots) int32 bits
        return self.store.val_pages

    @property
    def planes(self):                      # (P, key_bits, S/32) int32 | None
        return self.store.planes

    @property
    def page_next(self) -> torch.Tensor:   # (num_pages,) int32, -1 terminal
        return self.store.page_next

    @property
    def page_fill(self) -> torch.Tensor:   # (num_pages,) int32 high-water
        return self.store.page_fill

    @property
    def free_top(self) -> torch.Tensor:    # () int32 pim_malloc bump pointer
        return self.store.free_top


def check_config(cfg: HashMemConfig):
    """Refuse what this port does not do yet, naming where it is planned."""
    if cfg.resize not in ("rebuild", "extendible"):
        raise ValueError(f"unknown resize mode {cfg.resize!r} "
                         f"(want 'rebuild' or 'extendible')")
    if cfg.resize == "extendible":
        raise NotImplementedError(
            "resize='extendible' is not ported yet (ROADMAP Queue 1 item 7)")
    if cfg.fingerprint_bits > 0 or cfg.displacement or cfg.stash_slots > 0:
        raise NotImplementedError(
            "fingerprint lane, displacement and stash are not ported yet "
            "(ROADMAP Queue 1 item 6)")
    if cfg.backend not in ("perf", "ref", "area", "bitserial"):
        raise ValueError(f"unknown probe backend {cfg.backend!r}")


def _keep_planes(cfg: HashMemConfig) -> bool:
    return cfg.backend == "bitserial"


def create(cfg: HashMemConfig, device=None) -> HashMem:
    """Empty HashMem: every bucket pre-owns its direct page (paper §2.4)."""
    check_config(cfg)
    dev = resolve_device(device)
    store = layout.empty_store(cfg.num_pages, cfg.slots_per_page,
                               cfg.key_bits, dev,
                               with_planes=_keep_planes(cfg))
    store.free_top = torch.tensor(cfg.num_buckets, dtype=I32, device=dev)
    return HashMem(store=store,
                   bucket_head=torch.arange(cfg.num_buckets, dtype=I32,
                                            device=dev),
                   config=cfg)


# ---------------------------------------------------------------------------
# State carried across packages: numpy leaves in the JAX HashMem's names
# ---------------------------------------------------------------------------

def leaf_names(cfg: HashMemConfig) -> tuple:
    """The leaves a table of this config carries: ``LEAVES``, and
    ``planes`` for a bit-serial table."""
    return LEAVES + ("planes",) if _keep_planes(cfg) else LEAVES


def to_numpy(hm: HashMem) -> dict:
    """``pool`` (P,S,2) uint32, ``page_next``/``page_fill``/``bucket_head``
    int32, ``free_top`` () int32 and, for a bit-serial table, ``planes``
    (P, key_bits, S/32) uint32, as the JAX HashMem holds them."""
    out = {
        "pool": hm.store.pool.cpu().numpy().view(np.uint32),
        "page_next": hm.page_next.cpu().numpy(),
        "page_fill": hm.page_fill.cpu().numpy(),
        "free_top": hm.free_top.cpu().numpy(),
        "bucket_head": hm.bucket_head.cpu().numpy(),
    }
    if hm.planes is not None:
        out["planes"] = hm.planes.cpu().numpy().view(np.uint32)
    return out


def from_numpy(cfg: HashMemConfig, leaves: dict, device=None) -> HashMem:
    """A HashMem from numpy leaves (e.g. ``np.asarray`` of a JAX table's)."""
    check_config(cfg)
    dev = resolve_device(device)
    want = {"pool": (cfg.num_pages, cfg.slots_per_page, 2),
            "page_next": (cfg.num_pages,), "page_fill": (cfg.num_pages,),
            "free_top": (), "bucket_head": (cfg.num_buckets,)}
    if _keep_planes(cfg):
        want["planes"] = (cfg.num_pages, cfg.key_bits,
                          layout.plane_words(cfg.slots_per_page))
    t = {}
    for name in leaf_names(cfg):
        a = np.asarray(leaves[name])
        if a.shape != want[name]:
            raise ValueError(f"leaf {name} has shape {a.shape}, the config "
                             f"needs {want[name]}")
        a = a.astype(np.uint32).view(np.int32) if name in ("pool", "planes") \
            else a.astype(np.int32)
        t[name] = torch.from_numpy(a).to(dev)
    store = layout.PageStore(pool=t["pool"], page_next=t["page_next"],
                             page_fill=t["page_fill"],
                             free_top=t["free_top"], key_bits=cfg.key_bits,
                             planes=t.get("planes"))
    return HashMem(store=store, bucket_head=t["bucket_head"], config=cfg)


# ---------------------------------------------------------------------------
# Bulk build (vectorized; the paper populates the dataset before probing)
# ---------------------------------------------------------------------------

def build(cfg: HashMemConfig, keys, vals, device=None) -> HashMem:
    """Vectorized bulk load of N key/value pairs.

    Buckets receive ceil(count/slots) pages; overflow pages are allocated
    contiguously from the arena in bucket order.  Duplicate keys are all
    stored; probe returns the first match in chain order.
    """
    dev = resolve_device(device)
    k = as_u32(keys, dev)
    b = hash_to_bucket(k, cfg.num_buckets, cfg.hash_fn, cfg.salt)
    return build_with_buckets(cfg, k, vals, b, dev)


def build_with_buckets(cfg: HashMemConfig, keys, vals, b,
                       device=None) -> HashMem:
    """Bulk load with caller-supplied bucket ids."""
    check_config(cfg)
    dev = resolve_device(device)
    return _scatter_build(cfg, as_u32(keys, dev), as_u32(vals, dev),
                          torch.as_tensor(b, device=dev), valid=None)


def _segment_rank(bs: torch.Tensor, num_buckets: int):
    """Rank of each entry inside its run of equal ids in the sorted ``bs``
    (what ``searchsorted(bs, bs, side="left")`` gives), and the per-bucket
    counts.  Ids >= num_buckets share one trailing run."""
    bc = bs.clamp(max=num_buckets)
    counts = torch.bincount(bc, minlength=num_buckets + 1)
    start = (torch.cumsum(counts, 0) - counts)[bc]
    rank = torch.arange(bs.numel(), device=bs.device) - start
    return rank, counts[:num_buckets]


def _scatter_build(cfg: HashMemConfig, keys: torch.Tensor, vals: torch.Tensor,
                   b: torch.Tensor, valid) -> HashMem:
    """Shared sort/rank/segment bulk loader.  Entries with ``valid=False``
    (or bucket id >= num_buckets) are dropped; relative order of surviving
    entries within a bucket follows their input order (stable sort)."""
    S, nb, P = cfg.slots_per_page, cfg.num_buckets, cfg.num_pages
    dev = keys.device
    b = b.to(I64)
    if valid is not None:
        b = torch.where(valid, b, nb)                         # sorts to the end
    order = torch.argsort(b, stable=True)
    bs, ks, vs = b[order], to_bits(keys)[order], to_bits(vals)[order]
    dropped = bs >= nb

    rank, counts = _segment_rank(bs, nb)
    depth = rank // S
    slot = rank % S
    n_over = ((counts + S - 1) // S - 1).clamp(min=0)        # overflow pages/bucket
    over_off = torch.cumsum(n_over, 0) - n_over               # exclusive prefix

    ob = bs.clamp(max=nb - 1)                                 # safe gather
    page = torch.where(depth == 0, bs, nb + over_off[ob] + depth - 1)
    page = torch.where(dropped, P, page)                      # OOB -> dropped

    store = layout.empty_store(P, S, cfg.key_bits, dev)     # planes packed below
    keep = page < P
    store.pool[page[keep], slot[keep]] = torch.stack([ks, vs], dim=-1)[keep]
    store.page_fill.scatter_reduce_(0, page[keep], (slot + 1)[keep].to(I32),
                                    reduce="amax")

    # chain links: first element landing on a depth>=1 page links prev -> page
    is_link = (depth >= 1) & (slot == 0) & ~dropped
    prev_page = torch.where(depth == 1, bs, nb + over_off[ob] + depth - 2)
    link_idx = torch.where(is_link, prev_page, P)
    lk = link_idx < P
    store.page_next[link_idx[lk]] = page[lk].to(I32)
    store.free_top = (nb + n_over.sum()).to(I32)
    if _keep_planes(cfg):
        store.planes = layout.pack_bitplanes(store.key_pages, cfg.key_bits)
    return HashMem(store=store,
                   bucket_head=torch.arange(nb, dtype=I32, device=dev),
                   config=cfg)


def _fit_report(counts, cfg: HashMemConfig) -> dict:
    """Shared fit check: would per-bucket `counts` fit the chain/arena bounds?"""
    pages = np.maximum((counts + cfg.slots_per_page - 1) // cfg.slots_per_page, 0)
    return {
        "max_chain_needed": int(pages.max(initial=0)),
        "overflow_pages_needed": int(np.maximum(pages - 1, 0).sum()),
        "fits": bool(pages.max(initial=0) <= cfg.max_chain
                     and np.maximum(pages - 1, 0).sum() <= cfg.overflow_pages),
    }


def build_check(cfg: HashMemConfig, keys) -> dict:
    """Pre-flight (host-side) checks that the arena/chain bounds suffice."""
    b = hash_to_bucket(as_u32(keys, "cpu"), cfg.num_buckets, cfg.hash_fn,
                       cfg.salt).numpy()
    counts = np.bincount(b, minlength=cfg.num_buckets)
    rep = _fit_report(counts, cfg)
    rep["load_factor"] = float(counts.sum() / (cfg.num_pages * cfg.slots_per_page))
    rep["bucket_counts"] = counts
    return rep


# ---------------------------------------------------------------------------
# RLU command-stream resolution (paper §2.3: RLU locates subarray rows)
# ---------------------------------------------------------------------------

def _next(hm: HashMem, page: torch.Tensor) -> torch.Tensor:
    """page_next of each page, -1 for a -1 page.  A page id past the pool
    reads the last entry, as JAX's clamped gather does."""
    nxt = hm.page_next[page.to(I64).clamp(0, hm.config.num_pages - 1)]
    return torch.where(page >= 0, nxt, -1)


def resolve_pages(hm: HashMem, queries) -> torch.Tensor:
    """queries (Q,) uint32 -> (Q, max_chain) int32 page ids, -1 padded."""
    cfg = hm.config
    q = as_u32(queries, hm.device)
    b = hash_to_bucket(q, cfg.num_buckets, cfg.hash_fn, cfg.salt)
    return resolve_pages_by_bucket(hm, b)


def resolve_pages_by_bucket(hm: HashMem, b) -> torch.Tensor:
    page = hm.bucket_head[torch.as_tensor(b, device=hm.device).to(I64)]
    cols = [page]
    for _ in range(hm.config.max_chain - 1):
        page = _next(hm, page)
        cols.append(page)
    return torch.stack(cols, dim=1).to(I32)


def chain_lengths(hm: HashMem) -> torch.Tensor:
    """(num_buckets,) int32 chain lengths via a bounded vectorized walk,
    one step past ``max_chain`` so an over-long chain shows as
    max_chain + 1."""
    p = hm.bucket_head
    clen = (p >= 0).to(I32)
    for _ in range(hm.config.max_chain):
        p = _next(hm, p)
        clen = clen + (p >= 0).to(I32)
    return clen


def max_chain_len(hm: HashMem) -> int:
    """Longest bucket chain, in pages (the per-probe RLU command depth)."""
    return int(chain_lengths(hm).max())


# ---------------------------------------------------------------------------
# Probe / insert / delete
# ---------------------------------------------------------------------------

def probe(hm: HashMem, queries, backend=None):
    """Batched probe.  Returns (values (Q,) int64 uint32-values,
    found (Q,) bool)."""
    cfg = hm.config
    q = as_u32(queries, hm.device)
    b = hash_to_bucket(q, cfg.num_buckets, cfg.hash_fn, cfg.salt)
    return probe_with_buckets(hm, q, b, backend)


def probe_with_buckets(hm: HashMem, queries, b, backend=None):
    """``probe`` with caller-supplied bucket ids."""
    from repro_torch.core.probe import probe_pages
    q = to_bits(as_u32(queries, hm.device))
    pages = resolve_pages_by_bucket(hm, b)
    return probe_pages(hm, q, pages, backend or hm.config.backend)


def _chain_tails(hm: HashMem, b: torch.Tensor):
    """Per-key chain tail page, tail fill and chain length (bounded walk)."""
    last = hm.config.num_pages - 1
    tail = hm.bucket_head[b]
    clen = torch.ones_like(tail)
    for _ in range(hm.config.max_chain - 1):
        nxt = hm.page_next[tail.to(I64).clamp(0, last)]
        has = nxt >= 0
        tail = torch.where(has, nxt, tail)
        clen = clen + has.to(I32)
    return tail, hm.page_fill[tail.to(I64).clamp(0, last)], clen


def insert(hm: HashMem, keys, vals, valid=None):
    """Vectorized batched insert: appends the whole batch at the existing
    chain tails in one shot.  Equivalent to repeated single inserts in batch
    order.  Returns (new_hm, ok (B,) bool).

    ``ok=False`` means the element was not stored: the overflow arena is
    exhausted, or appending would push its chain past ``max_chain``.
    ``valid`` (optional (B,) bool) marks padding: invalid elements write
    nothing, claim no arena pages and report ok=False.
    """
    cfg = hm.config
    k = as_u32(keys, hm.device)
    b = hash_to_bucket(k, cfg.num_buckets, cfg.hash_fn, cfg.salt)
    return insert_with_buckets(hm, k, vals, b, valid)


def insert_with_buckets(hm: HashMem, keys, vals, b, valid=None):
    """``insert`` with caller-supplied bucket ids."""
    dev = hm.device
    if valid is not None:
        valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    return _insert_chained(hm, as_u32(keys, dev), as_u32(vals, dev),
                           torch.as_tensor(b, device=dev), valid)


def _insert_chained(hm: HashMem, keys: torch.Tensor, vals: torch.Tensor,
                    b: torch.Tensor, valid=None):
    """Chain-append insert at the buckets' existing tails: one fused
    key/value pool write, the fill high-water max and the chain-link set."""
    cfg = hm.config
    S, nb, P = cfg.slots_per_page, cfg.num_buckets, cfg.num_pages
    b = b.to(I64)
    if valid is not None:
        b = torch.where(valid, b, nb)                # pads sort to the end

    # clamped gather: dropped entries read bucket 0's tail, never used
    tail, fill, clen = _chain_tails(hm, b.clamp(max=nb - 1))

    # stable sort by bucket keeps intra-bucket batch order (duplicate keys
    # land in insertion order, matching sequential semantics)
    order = torch.argsort(b, stable=True)
    bs, ks, vs = b[order], to_bits(keys)[order], to_bits(vals)[order]
    tails, fills, clens = (tail[order].to(I64), fill[order].to(I64),
                           clen[order].to(I64))
    dropped = bs >= nb

    rank, _ = _segment_rank(bs, nb)
    pos = fills + rank                               # position past the tail start
    depth = pos // S                                 # 0 = existing tail page
    slot = pos % S

    # pim_malloc: every chain-admissible page start claims the next arena
    # page, in sorted (bucket) order -- one cumsum, no per-bucket arrays
    ok_chain = (clens + depth <= cfg.max_chain) & ~dropped    # RLU depth bound
    is_new_page = ok_chain & (depth >= 1) & (slot == 0)
    page_idx = torch.cumsum(is_new_page.to(I64), 0) - 1       # shared along page
    free_top = hm.free_top.to(I64)
    new_id = free_top + page_idx
    n_fit = torch.minimum((P - free_top).clamp(min=0), is_new_page.sum())
    ok = torch.where(depth == 0, ~dropped, ok_chain & (new_id < P))
    page = torch.where(depth == 0, tails, new_id)
    wp = torch.where(ok, page, P)                    # OOB drop if !ok

    store = hm.store.write_slots(wp, slot, ks, vs)   # fused k+v scatter
    keep = wp < P
    store.page_fill = store.page_fill.clone().scatter_reduce_(
        0, wp[keep], (slot + 1)[keep].to(I32), reduce="amax")

    # chain links: first element on each newly allocated page links prev -> page
    is_link = ok & (depth >= 1) & (slot == 0)
    prev = torch.where(depth == 1, tails, page - 1)
    link_idx = torch.where(is_link, prev, P)
    lk = (link_idx >= 0) & (link_idx < P)
    store.page_next = store.page_next.clone()
    store.page_next[link_idx[lk]] = page[lk].to(I32)
    store.free_top = (free_top + n_fit).to(I32)

    ok_orig = torch.empty_like(ok)
    ok_orig[order] = ok                              # inverse permutation
    return HashMem(store=store, bucket_head=hm.bucket_head,
                   config=cfg), ok_orig


def delete(hm: HashMem, keys):
    """Batched tombstone delete (paper §2.5).  Returns (new_hm, found).
    Each query tombstones the FIRST chain-order match of its key; duplicate
    queries in one batch resolve to the same slot (one removal).  Only the
    key lane of the row is rewritten."""
    cfg = hm.config
    q = as_u32(keys, hm.device)
    b = hash_to_bucket(q, cfg.num_buckets, cfg.hash_fn, cfg.salt)
    return delete_with_buckets(hm, q, b)


def delete_with_buckets(hm: HashMem, keys, b):
    """``delete`` with caller-supplied bucket ids.

    The JAX package finds the first match with a full 32-bit key compare
    over a (Q, C, S) gather, whatever the table's backend.  The port takes
    the [page, slot] lanes of the same full-key row compare instead: the
    ``perf`` kernel on the card, the plain version on the CPU or for a
    ``ref`` table.  They hold the same first match in chain order, lowest
    slot, without the gather.  The table's own backend is not used: the
    bit-serial compare matches on the low ``key_bits`` bits only and would
    tombstone another key."""
    from repro_torch.core.probe import probe_lanes
    cfg = hm.config
    q = to_bits(as_u32(keys, hm.device))
    pages = resolve_pages_by_bucket(hm, b)
    out = probe_lanes(hm.store, q, pages,
                      "ref" if cfg.backend == "ref" else "perf")
    found = out[:, 1] != 0
    pg, s = out[:, 2].to(I64), out[:, 3].to(I64)
    wp = torch.where(found, pg, cfg.num_pages)                  # OOB drop
    store = hm.store.write_keys(wp, s, torch.full_like(q, TOMBSTONE_BITS),
                                plane_pages=_dedup_plane_pages(hm, found,
                                                               pg, s))
    return HashMem(store=store, bucket_head=hm.bucket_head,
                   config=cfg), found


def _dedup_plane_pages(hm: HashMem, found, pg, s):
    """Page ids for the bit-plane update of a tombstone batch: duplicate
    queries target one (page, slot), and only its first is kept, so that
    the update sets each bit once; None when the table keeps no planes."""
    cfg = hm.config
    if hm.planes is None or found.numel() == 0:
        return None
    flat = torch.where(found, pg * cfg.slots_per_page + s, -1)
    o = torch.argsort(flat, stable=True)
    fs = flat[o]
    first = torch.ones_like(found)
    first[1:] = fs[1:] != fs[:-1]
    uniq = torch.empty_like(found)
    uniq[o] = first
    return torch.where(found & uniq, pg, cfg.num_pages)


def insert_scan(hm: HashMem, keys, vals):
    """Sequential per-element insert (paper §3.1 Listing 1), the JAX
    package's ``lax.scan`` as a Python loop.

    The reference the vectorized ``insert`` is tested against.  Unlike
    ``insert``, it does not enforce the ``max_chain`` bound.  Returns
    (new_hm, ok (B,) bool)."""
    cfg = hm.config
    S, P = cfg.slots_per_page, cfg.num_pages
    k = as_u32(keys, hm.device)
    v = as_u32(vals, hm.device)
    bs = hash_to_bucket(k, cfg.num_buckets, cfg.hash_fn, cfg.salt).tolist()
    kb, vb = to_bits(k), to_bits(v)
    st = hm.store
    pool, page_next, page_fill = (st.pool.clone(), st.page_next.clone(),
                                  st.page_fill.clone())
    planes = None if st.planes is None else st.planes.clone()
    free_top = int(st.free_top)
    oks = []
    for i, b in enumerate(bs):
        last = int(hm.bucket_head[b])               # walk to the chain tail
        for _ in range(cfg.max_chain - 1):          # (gathers clamp, as JAX's)
            nxt = int(page_next[min(max(last, 0), P - 1)])
            last = nxt if nxt >= 0 else last
        fill = int(page_fill[min(last, P - 1)])
        need_new = fill >= S
        ok = free_top < P if need_new else True
        oks.append(ok)
        if not ok:
            continue
        tp, ts = (free_top, 0) if need_new else (last, fill)
        if tp < P:                                  # a write past the pool drops
            pool[tp, ts, layout.KEY_LANE] = kb[i]
            pool[tp, ts, layout.VAL_LANE] = vb[i]
            if planes is not None:
                _write_key_bits(planes, tp, ts, int(k[i]), cfg.key_bits)
            page_fill[tp] = ts + 1
        if need_new:
            if last < P:
                page_next[last] = free_top
            free_top += 1
    store = dataclasses.replace(
        st, pool=pool, planes=planes, page_next=page_next,
        page_fill=page_fill,
        free_top=torch.tensor(free_top, dtype=I32, device=hm.device))
    return (HashMem(store=store, bucket_head=hm.bucket_head, config=cfg),
            torch.tensor(oks, dtype=torch.bool, device=hm.device))


def _write_key_bits(planes: torch.Tensor, page: int, slot: int, key: int,
                    key_bits: int):
    """Bit-plane upkeep for one (page, slot) write, in place: bit
    ``slot % 32`` of word ``slot // 32`` of each plane j takes bit j of
    ``key``."""
    word, bit = slot // 32, slot % 32
    kbits = torch.tensor([(key >> j) & 1 for j in range(key_bits)],
                         dtype=I64, device=planes.device)
    old = from_bits(planes[page, :, word])
    planes[page, :, word] = to_bits((old & ~(1 << bit)) | (kbits << bit))


# ---------------------------------------------------------------------------
# Dynamic resizing (grow / compact / auto-grow policy)
# ---------------------------------------------------------------------------

def _rebuild(hm: HashMem, new_cfg: HashMemConfig) -> HashMem:
    """Re-bucket every live entry into a fresh arena under ``new_cfg``.

    Flat (page-major) slot order IS chain order per bucket (page ids
    increase along every chain), and the build's stable sort keeps it, so
    same-key duplicates keep their relative order: probe and delete
    semantics survive the rebuild."""
    flat = hm.store.pool.reshape(-1, 2)
    kbits = flat[:, layout.KEY_LANE]
    live = (kbits != EMPTY_BITS) & (kbits != TOMBSTONE_BITS)
    keys = from_bits(kbits)
    b = hash_to_bucket(keys, new_cfg.num_buckets, new_cfg.hash_fn,
                       new_cfg.salt)
    return _scatter_build(new_cfg, keys, from_bits(flat[:, layout.VAL_LANE]),
                          b, valid=live)


def grow(hm: HashMem, factor=None) -> HashMem:
    """Rehash into a ``factor``x larger arena (default
    config.growth_factor): num_buckets and overflow_pages both scale, all
    live entries are re-bucketed, chains and bit-planes are rebuilt.
    Tombstones are dropped (grow subsumes compact)."""
    cfg = hm.config
    f = factor or cfg.growth_factor
    new_cfg = dataclasses.replace(cfg, num_buckets=cfg.num_buckets * f,
                                  overflow_pages=cfg.overflow_pages * f)
    return _rebuild(hm, new_cfg)


def compact(hm: HashMem) -> HashMem:
    """Reclaim tombstoned slots and overflow pages by rebuilding at the
    same config.  After compact: stats()['tombstones'] == 0 and every chain
    is the minimum length for its live population."""
    return _rebuild(hm, hm.config)


def rebuild_check(hm: HashMem, new_cfg: HashMemConfig) -> dict:
    """Host-side pre-flight: would the live entries fit under new_cfg?"""
    kp = hm.key_pages.reshape(-1)
    lk = from_bits(kp[(kp != EMPTY_BITS) & (kp != TOMBSTONE_BITS)])
    b = hash_to_bucket(lk, new_cfg.num_buckets, new_cfg.hash_fn,
                       new_cfg.salt)
    counts = torch.bincount(b, minlength=new_cfg.num_buckets).cpu().numpy()
    return _fit_report(counts, new_cfg)


def compact_due(hm: HashMem, tombstones: int, *, fraction: bool = True,
                chain: bool = True) -> bool:
    """The compaction trigger policy: with tombstones present, compact when
    they exceed ``compact_tombstone_frac`` of capacity (``fraction``) or,
    with ``compact_chain_len`` > 0, when any bucket chain exceeds that many
    pages (``chain``: a device walk and a host sync)."""
    cfg = hm.config
    if tombstones <= 0:
        return False
    if fraction and tombstones > \
            cfg.compact_tombstone_frac * cfg.num_pages * cfg.slots_per_page:
        return True
    return chain and cfg.compact_chain_len > 0 and \
        max_chain_len(hm) > cfg.compact_chain_len


def insert_auto(hm: HashMem, keys, vals, max_grows: int = 8,
                events=None):
    """Host-level insert with auto-grow.  Grows proactively while the batch
    would pass config.max_load_factor, and reactively while any element is
    refused; the two loops draw on SEPARATE ``max_grows`` budgets, so a
    proactive doubling never starves the repair of a refused batch.
    ``events`` (optional dict) counts each grow under "rebuilds".  Returns
    (new_hm, ok (B,) bool): all True unless growth ran out or is off."""
    k = as_u32(keys, hm.device)
    v = as_u32(vals, hm.device)
    n = k.numel()
    cfg = hm.config
    if cfg.auto_grow:
        proactive = 0
        live = int(live_count(hm))
        while live + n > cfg.max_load_factor * \
                cfg.num_pages * cfg.slots_per_page and proactive < max_grows:
            hm = grow(hm)
            cfg = hm.config
            proactive += 1
            if events is not None:
                events["rebuilds"] = events.get("rebuilds", 0) + 1

    ok = torch.zeros(n, dtype=torch.bool, device=hm.device)
    remaining = torch.arange(n, device=hm.device)
    reactive = 0
    while remaining.numel():
        hm, ok_r = insert(hm, k[remaining], v[remaining])
        ok[remaining[ok_r]] = True
        remaining = remaining[~ok_r]
        if remaining.numel() == 0 or not hm.config.auto_grow \
                or reactive >= max_grows:
            break
        hm = grow(hm)
        reactive += 1
        if events is not None:
            events["rebuilds"] = events.get("rebuilds", 0) + 1
    return hm, ok


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------

def _live_mask(hm: HashMem) -> torch.Tensor:
    kp = hm.key_pages
    return (kp != EMPTY_BITS) & (kp != TOMBSTONE_BITS)


def live_count(hm: HashMem) -> torch.Tensor:
    """() int32 number of live (non-empty, non-tombstone) entries."""
    return _live_mask(hm).sum().to(I32)


def load_factor(hm: HashMem) -> torch.Tensor:
    """Live entries / total slot capacity, as a float32 scalar."""
    cap = hm.config.num_pages * hm.config.slots_per_page
    return live_count(hm).to(torch.float32) / cap


def stats(hm: HashMem) -> dict:
    cfg = hm.config
    live = int(live_count(hm))
    chain_len = chain_lengths(hm).cpu().numpy()
    cap = cfg.num_pages * cfg.slots_per_page
    return {
        "live_entries": live,
        "tombstones": int((hm.key_pages == TOMBSTONE_BITS).sum()),
        "pages_used": int((hm.page_fill > 0).sum()),
        "free_pages": int(cfg.num_pages - int(hm.free_top)),
        "chain_lengths": chain_len,
        "max_chain": int(chain_len.max(initial=0)),
        "capacity": cap,
        "load_factor": float(live / cap),
        "num_buckets": cfg.num_buckets,
        "stash_live": 0,
        "stash_tombstones": 0,
        "stash_fill": 0,
    }
