"""HashMem structure in PyTorch: the JAX package's ``core/hashmap.py``
(paper §2.4-2.5, §3) with its fingerprint lane, displacement and stash
(Dash / IcebergHT) and both resize modes.

  * bucket i owns page i; overflow pages are chained through ``page_next``;
  * ``free_top`` is the ``pim_malloc`` bump allocator over the overflow arena;
  * delete writes TOMBSTONE_KEY and never reuses the slot (paper §2.5);
  * probing resolves the page chain (the RLU command stream) and hands the
    page list to a backend (``core/probe.py``);
  * ``grow`` rebuilds into a larger arena and ``compact`` at the same size,
    re-bucketing every live entry (and re-packing the bit-planes and the
    fingerprint lane); ``insert_auto`` grows when a batch would pass
    ``max_load_factor`` or when an element is refused.

With ``displacement`` an insert tries the H1 bucket's own page, then chains
at the second hash (``hash_to_bucket2``), then falls into the stash; a probe
searches the same order (``resolve_pages_displaced``, then the stash), so
the first match is still the oldest duplicate.  With ``fingerprint_bits``
the probe first drops every page whose fingerprint lane holds no slot with
the query's fingerprint (``_fp_filter``).  With ``resize="extendible"`` a
refused insert splits its bucket group (``split_group``) and doubles the
directory by pointer copy (``double_directory``) instead of rebuilding.

Keys and values enter as uint32 (numpy arrays or tensors) and are carried as
int64 tensors holding [0, 2**32) (``hashing.as_u32``); the pool stores their
bits as int32.  Every function gives the same state and results as its JAX
counterpart, bit for bit, including the order of duplicate keys (stable
sorts) and JAX's clamped gathers and dropped scatters.  Like the JAX
structure, every mutation returns a new HashMem and leaves the old one as
it was.

Entry points that make a table take ``device=None``, which means the card;
only ``device="cpu"`` runs on the CPU.  Operations on a table run on the
table's device.  The RLU layer's ``bucket_fn`` override is not ported yet
(ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs import HashMemConfig
from repro_torch.core import layout
from repro_torch.core.hashing import (EMPTY_KEY, TOMBSTONE_KEY, as_u32,
                                      bits_used, fingerprint, hash_to_bucket,
                                      hash_to_bucket2)
from repro_torch.core.layout import (EMPTY_BITS, TOMBSTONE_BITS, from_bits,
                                     resolve_device, to_bits)

I32 = torch.int32
I64 = torch.int64

LEAVES = ("pool", "page_next", "page_fill", "free_top", "bucket_head")
U32_LEAVES = ("pool", "planes", "fprints", "stash")

# (query, page) pairs the fingerprint pre-pass handles at a time: at the
# paper's 12 planes of 16 words, 768 MB of gathered lane rows.
FP_PAIRS = 1 << 20


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


def _check_resize(cfg: HashMemConfig):
    """Validate the resize knob; the global depth for extendible tables,
    None for rebuild.  Extendible resize needs a power-of-two directory (the
    bucket id IS the low-bits hash prefix) and excludes displacement and the
    stash (a displaced entry's home is H1 or H2, so one group's entries
    cannot be re-bucketed alone)."""
    if cfg.resize not in ("rebuild", "extendible"):
        raise ValueError(f"unknown resize mode {cfg.resize!r} "
                         f"(want 'rebuild' or 'extendible')")
    if cfg.resize != "extendible":
        return None
    if cfg.displacement or cfg.stash_slots:
        raise ValueError("resize='extendible' excludes displacement/stash "
                         "(split re-buckets one group in isolation; a "
                         "displaced entry's home is H1 OR H2)")
    return bits_used(cfg.num_buckets)


def check_config(cfg: HashMemConfig):
    """``_check_resize``, and a known probe backend; returns the global
    depth of an extendible table (None otherwise)."""
    gd = _check_resize(cfg)
    if cfg.backend not in ("perf", "ref", "area", "bitserial"):
        raise ValueError(f"unknown probe backend {cfg.backend!r}")
    return gd


def _keep_planes(cfg: HashMemConfig) -> bool:
    return cfg.backend == "bitserial"


def _full_key_backend(cfg: HashMemConfig) -> str:
    """The backend of every full 32-bit key compare outside ``probe``
    (delete, ``rows_activated_per_probe``): the ``perf`` kernel, or the
    plain version for a ``ref`` table.  Never the bit-serial compare, which
    matches on the low ``key_bits`` bits only."""
    return "ref" if cfg.backend == "ref" else "perf"


def create(cfg: HashMemConfig, device=None) -> HashMem:
    """Empty HashMem: every bucket pre-owns its direct page (paper §2.4)."""
    gd = check_config(cfg)
    dev = resolve_device(device)
    store = layout.empty_store(cfg.num_pages, cfg.slots_per_page,
                               cfg.key_bits, dev,
                               with_planes=_keep_planes(cfg),
                               fp_bits=cfg.fingerprint_bits,
                               stash_slots=cfg.stash_slots, local_depth=gd)
    store.free_top = torch.tensor(cfg.num_buckets, dtype=I32, device=dev)
    return HashMem(store=store,
                   bucket_head=torch.arange(cfg.num_buckets, dtype=I32,
                                            device=dev),
                   config=cfg)


# ---------------------------------------------------------------------------
# State carried across packages: numpy leaves in the JAX HashMem's names
# ---------------------------------------------------------------------------

def leaf_names(cfg: HashMemConfig) -> tuple:
    """The leaves a table of this config carries: ``LEAVES``, ``planes``
    for a bit-serial table, ``fprints`` with fingerprints, ``stash`` and
    ``stash_fill`` with a stash, ``local_depth`` for an extendible table."""
    return LEAVES + (("planes",) if _keep_planes(cfg) else ()) \
        + (("fprints",) if cfg.fingerprint_bits > 0 else ()) \
        + (("stash", "stash_fill") if cfg.stash_slots > 0 else ()) \
        + (("local_depth",) if cfg.resize == "extendible" else ())


def to_numpy(hm: HashMem) -> dict:
    """The table's leaves (``leaf_names``) as the JAX HashMem holds them:
    ``pool``, ``planes``, ``fprints`` and ``stash`` uint32, the rest
    int32."""
    out = {}
    for name in leaf_names(hm.config):
        t = hm.bucket_head if name == "bucket_head" else getattr(hm.store,
                                                                 name)
        a = t.cpu().numpy()
        out[name] = a.view(np.uint32) if name in U32_LEAVES else a
    return out


def from_numpy(cfg: HashMemConfig, leaves: dict, device=None) -> HashMem:
    """A HashMem from numpy leaves (e.g. ``np.asarray`` of a JAX table's)."""
    check_config(cfg)
    dev = resolve_device(device)
    P, S = cfg.num_pages, cfg.slots_per_page
    want = {"pool": (P, S, 2), "page_next": (P,), "page_fill": (P,),
            "free_top": (), "bucket_head": (cfg.num_buckets,),
            "planes": (P, cfg.key_bits, S // 32),
            "fprints": (P, cfg.fingerprint_bits, S // 32),
            "stash": (cfg.stash_slots, 2), "stash_fill": (),
            "local_depth": (P,)}
    t = {}
    for name in leaf_names(cfg):
        a = np.asarray(leaves[name])
        if a.shape != want[name]:
            raise ValueError(f"leaf {name} has shape {a.shape}, the config "
                             f"needs {want[name]}")
        a = a.astype(np.uint32).view(np.int32) if name in U32_LEAVES \
            else a.astype(np.int32)
        t[name] = torch.from_numpy(a).to(dev)
    bucket_head = t.pop("bucket_head")
    store = layout.PageStore(key_bits=cfg.key_bits,
                             fp_bits=cfg.fingerprint_bits, **t)
    return HashMem(store=store, bucket_head=bucket_head, config=cfg)


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
    """Bulk load with caller-supplied bucket ids.

    Under ``cfg.displacement`` the load is replayed through the displaced
    insert, and EMPTY_KEY pads are dropped (the chained loader stores
    whatever it is given)."""
    check_config(cfg)
    dev = resolve_device(device)
    k, v = as_u32(keys, dev), as_u32(vals, dev)
    b = torch.as_tensor(b, device=dev)
    if cfg.displacement:
        hm, _ = _insert_displaced(create(cfg, dev), k, v, b,
                                  valid=k != EMPTY_KEY)
        return hm
    return _scatter_build(cfg, k, v, b, valid=None)


def _segment_rank(bs: torch.Tensor, num_buckets: int):
    """Rank of each entry inside its run of equal ids in the sorted ``bs``
    (what ``searchsorted(bs, bs, side="left")`` gives), and the per-bucket
    counts.  Ids >= num_buckets share one trailing run."""
    bc = bs.clamp(max=num_buckets)
    # scatter-add, not bincount, whose output size waits for the device
    counts = torch.zeros(num_buckets + 1, dtype=I64,
                         device=bs.device).scatter_add_(
        0, bc, torch.ones_like(bc))
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

    # planes and fingerprints are packed below; an extendible table leaves
    # a (re)build with a flat directory, every group at the global depth
    store = layout.empty_store(P, S, cfg.key_bits, dev,
                               stash_slots=cfg.stash_slots,
                               local_depth=_check_resize(cfg))
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
    if cfg.fingerprint_bits > 0:
        store.fprints = layout.pack_fprints(store.key_pages,
                                            cfg.fingerprint_bits)
        store.fp_bits = cfg.fingerprint_bits
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

def resolve_pages_displaced(hm: HashMem, queries, b1=None) -> torch.Tensor:
    """Displaced page schedule (Q, max_chain + 1) int32: [H1 direct page] +
    [H2 chain], -1 padded.

    The order is the displaced insert's placement order (H1 direct, then
    the H2 chain, then the stash, which the caller searches), so the first
    match is still the oldest duplicate.  Where b1 == b2 the H2 chain's head
    repeats the direct page and is blanked to -1 (only column 1 can repeat
    it: overflow pages sit above num_buckets)."""
    cfg = hm.config
    q = as_u32(queries, hm.device)
    if b1 is None:
        b1 = hash_to_bucket(q, cfg.num_buckets, cfg.hash_fn, cfg.salt)
    b2 = hash_to_bucket2(q, cfg.num_buckets, cfg.hash_fn, cfg.salt)
    b1 = torch.as_tensor(b1, device=hm.device).to(I64)
    direct = hm.bucket_head[b1][:, None]                       # (Q, 1)
    chain = resolve_pages_by_bucket(hm, b2)                    # (Q, C)
    head = torch.where(chain[:, :1] == direct, -1, chain[:, :1])
    return torch.cat([direct, head, chain[:, 1:]], dim=1).to(I32)


def _fp_filter(store: layout.PageStore, queries, pages) -> torch.Tensor:
    """Fingerprint pre-pass: blank (to -1) every page of the (Q, C)
    schedule whose fingerprint lane holds no slot with the query's
    fingerprint.  True matches are never dropped (the lane is exact per
    slot); a false positive costs one row activation, rejected by the full
    key compare.

    JAX gathers the (Q, C, fp_bits, W) lane rows at once, 69 GB for the
    paper's 10M probes at C = 9, fp_bits = 12.  Here only the schedule's
    valid (query, page) pairs are gathered, ``FP_PAIRS`` at a time: each
    pair's planes are XORed with the query's fingerprint bits and ORed
    together by halving the plane axis; a word with a zero bit holds a
    match.  The same pages survive."""
    fb, P = store.fp_bits, store.num_pages
    qn, C = pages.shape
    flat = pages.reshape(-1)
    out = torch.full_like(flat, -1)
    qfp = fingerprint(as_u32(queries, pages.device), fb)
    j = torch.arange(fb, device=pages.device)
    pairs = torch.nonzero(flat >= 0).squeeze(1)
    for lo in range(0, pairs.numel(), FP_PAIRS):
        idx = pairs[lo:lo + FP_PAIRS]
        pg = flat[idx].to(I64).clamp(max=P - 1)      # JAX's clamped gather
        mism = store.fprints.index_select(0, pg)      # (pairs, fb, W)
        mism ^= (-((qfp[idx // C, None] >> j) & 1)).to(I32)[:, :, None]
        while mism.shape[1] > 1:        # OR over planes: bit set = differs
            h = mism.shape[1] // 2
            rest = mism[:, 2 * h:]
            mism = mism[:, :h] | mism[:, h:2 * h]
            if rest.shape[1]:
                mism[:, :1] |= rest
        hit = (mism[:, 0] != -1).any(dim=1)
        out[idx] = torch.where(hit, flat[idx], -1)
    return out.view(qn, C)


def _stash_first(stash: torch.Tensor, qbits: torch.Tensor):
    """(hit (Q,) bool, idx (Q,) int64): whether the stash holds each query
    (int32 bits), and the oldest slot that does (0 on a miss).

    JAX compares every query with the whole stash, (Q, T) at once, and
    argmax picks the lowest matching slot.  Here the stash keys are sorted
    stably and each query is looked up with ``searchsorted``: the first of
    equal keys in that order is the lowest slot, so the result is the
    same."""
    keys = stash[:, layout.KEY_LANE]
    order = torch.argsort(keys, stable=True)
    sk = keys[order].contiguous()
    pos = torch.searchsorted(sk, qbits.contiguous()).clamp(max=len(sk) - 1)
    hit = sk[pos] == qbits
    return hit, torch.where(hit, order[pos], 0)


def stash_probe(store: layout.PageStore, queries):
    """(values (Q,) int64, found (Q,) bool) against the stash only: the
    whole stash is compared, with zero row activations (the stash is
    register-resident by design)."""
    q = to_bits(as_u32(queries, store.pool.device))
    hit, idx = _stash_first(store.stash, q)
    sv = from_bits(store.stash[idx, layout.VAL_LANE])
    return torch.where(hit, sv, 0), hit


def _schedule(hm: HashMem, q: torch.Tensor, b) -> torch.Tensor:
    """The probe's page schedule: displaced or chained."""
    if hm.config.displacement:
        return resolve_pages_displaced(hm, q, b)
    return resolve_pages_by_bucket(hm, b)


def probe(hm: HashMem, queries, backend=None):
    """Batched probe.  Returns (values (Q,) int64 uint32-values,
    found (Q,) bool)."""
    cfg = hm.config
    q = as_u32(queries, hm.device)
    b = hash_to_bucket(q, cfg.num_buckets, cfg.hash_fn, cfg.salt)
    return probe_with_buckets(hm, q, b, backend)


def probe_with_buckets(hm: HashMem, queries, b, backend=None):
    """``probe`` with caller-supplied H1 bucket ids.

    Resolve the page schedule (displaced or chained), drop the pages the
    fingerprint lane rules out, hand the rest to the backend, then fold in
    the stash, where a pool match wins (stash entries are the newest
    duplicates of their key).  Each step runs in a ``record_function``
    range (``probe.schedule``, ``probe.fp_filter``, ``probe.kernel``,
    ``probe.stash``) that a ``torch.profiler`` trace attributes device time
    to."""
    from repro_torch.core.probe import probe_pages
    q = as_u32(queries, hm.device)
    with record_function("probe.schedule"):
        pages = _schedule(hm, q, b)
    if hm.store.fprints is not None:
        with record_function("probe.fp_filter"):
            pages = _fp_filter(hm.store, q, pages)
    with record_function("probe.kernel"):
        vals, found = probe_pages(hm, to_bits(q), pages,
                                  backend or hm.config.backend)
    if hm.store.stash is not None:
        with record_function("probe.stash"):
            sv, sf = stash_probe(hm.store, q)
            vals = torch.where(found, vals, sv)
            found = found | sf
    return vals, found


def rows_activated_per_probe(hm: HashMem, queries,
                             use_fingerprints: bool = True,
                             b=None) -> torch.Tensor:
    """Mean DRAM-row activations one probe of this batch costs (the paper's
    unit of probe work), as a float32 scalar: a hit activates every
    unfiltered page up to and including its first match, a miss every
    unfiltered page of its schedule; the stash counts zero.

    JAX gathers the (Q, C, S) key rows (184 GB for the paper's 10M probes).
    Here the full-key compare's ``page`` lane gives the first-match column:
    the first column holding the matched page id (an earlier column with
    the same id would have matched first)."""
    from repro_torch.core.probe import probe_lanes
    cfg = hm.config
    q = as_u32(queries, hm.device)
    if b is None:
        b = hash_to_bucket(q, cfg.num_buckets, cfg.hash_fn, cfg.salt)
    pages = _schedule(hm, q, b)
    if use_fingerprints and hm.store.fprints is not None:
        pages = _fp_filter(hm.store, q, pages)
    out = probe_lanes(hm.store, to_bits(q), pages, _full_key_backend(cfg))
    valid = pages >= 0
    first = ((pages == out[:, 2:3]) & valid).to(torch.uint8).argmax(dim=1)
    upto = torch.arange(pages.shape[1], device=hm.device)[None, :] \
        <= first[:, None]
    acts = torch.where(out[:, 1] != 0, (valid & upto).sum(dim=1),
                       valid.sum(dim=1))
    # JAX's mean: the float32 sum times the float32 reciprocal of the count
    one = torch.ones((), dtype=torch.float32, device=hm.device)
    return acts.sum().to(torch.float32) * (one / q.numel())


def _with_spare(lane: torch.Tensor) -> torch.Tensor:
    """A copy of a (P,) page lane with one spare entry at P, for scatters
    whose dropped updates go there."""
    return torch.cat([lane, lane.new_zeros(1)])


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
    """``insert`` with caller-supplied bucket ids: the displaced path
    (H1 direct, H2 chain, stash) under ``config.displacement``, else the
    chained append."""
    dev = hm.device
    if valid is not None:
        valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    run = _insert_displaced if hm.config.displacement else _insert_chained
    return run(hm, as_u32(keys, dev), as_u32(vals, dev),
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
    if cfg.resize == "extendible" and hm.store.local_depth is not None:
        # fold each bucket id to its group id (the low local_depth bits):
        # the directory aliases of one group must form ONE sort segment
        # below, or two of them would append at the same tail slots.
        # Probe and delete need no fold: the aliases share the chain.
        heads = hm.bucket_head[b.clamp(max=nb - 1)].to(I64)
        mask = (1 << hm.store.local_depth[heads].to(I64)) - 1
        b = torch.where(b < nb, b & mask, b)

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
    # page_fill and page_next get one spare entry P that takes the dropped
    # updates (and a tail past the pool, which an overflowed build links),
    # so no data-dependent mask waits for the device
    fill = _with_spare(store.page_fill)
    store.page_fill = fill.scatter_reduce_(
        0, wp.clamp(max=P), (slot + 1).to(I32), reduce="amax")[:P]

    # chain links: first element on each newly allocated page links prev -> page
    is_link = ok & (depth >= 1) & (slot == 0)
    prev = torch.where(depth == 1, tails, page - 1)
    link_idx = torch.where(is_link, prev, P)
    lk = (link_idx >= 0) & (link_idx < P)
    nxt = _with_spare(store.page_next)
    nxt[torch.where(lk, link_idx, P)] = page.to(I32)
    store.page_next = nxt[:P]
    store.free_top = (free_top + n_fit).to(I32)

    ok_orig = torch.empty_like(ok)
    ok_orig[order] = ok                              # inverse permutation
    return HashMem(store=store, bucket_head=hm.bucket_head,
                   config=cfg), ok_orig


def _insert_displaced(hm: HashMem, keys: torch.Tensor, vals: torch.Tensor,
                      b1: torch.Tensor, valid=None):
    """IcebergHT-style displaced insert, in three rounds:

      1. the H1 direct page only: a fill-ranked append into the bucket's
         own row while it has room (no allocation, no links);
      2. the residue chains at H2 (``hash_to_bucket2``) through the chained
         append, the only round that allocates overflow pages;
      3. what both buckets refuse falls into the stash, bump-allocated in
         batch order (slots are not reused until a rebuild).

    A key's round is non-decreasing over its duplicates' lifetimes, and
    probes search direct -> H2 chain -> stash, so the first match is still
    the oldest duplicate."""
    cfg = hm.config
    S, nb, P = cfg.slots_per_page, cfg.num_buckets, cfg.num_pages
    valid_all = torch.ones_like(keys, dtype=torch.bool) if valid is None \
        else valid

    # -- round 1: H1 direct page, fill only --------------------------------
    b = torch.where(valid_all, b1.to(I64), nb)          # pads sort to the end
    order = torch.argsort(b, stable=True)
    bs = b[order]
    del b
    head = hm.bucket_head[bs.clamp(max=nb - 1)].to(I64)
    pos = hm.page_fill[head].to(I64) + _segment_rank(bs, nb)[0]
    ok1s = (pos < S) & (bs < nb)
    del bs
    wp = torch.where(ok1s, head, P)                     # OOB drop if !ok
    slot = pos.clamp(max=S - 1)
    del head, pos
    store = hm.store.write_slots(wp, slot, to_bits(keys)[order],
                                 to_bits(vals)[order])
    keep = wp < P
    store.page_fill = store.page_fill.clone().scatter_reduce_(
        0, wp[keep], (slot + 1)[keep].to(I32), reduce="amax")
    del wp, slot, keep
    ok1 = torch.empty_like(ok1s)
    ok1[order] = ok1s                                   # inverse permutation
    del order, ok1s
    hm1 = HashMem(store=store, bucket_head=hm.bucket_head, config=cfg)

    # -- round 2: chain the residue at H2 ----------------------------------
    # only the residue goes in: the entries JAX passes with valid=False sort
    # after it, write nothing and claim no page, so the state is the same
    res = torch.nonzero(valid_all & ~ok1).squeeze(1)
    b2 = hash_to_bucket2(keys[res], nb, cfg.hash_fn, cfg.salt)
    hm2, ok2_res = _insert_chained(hm1, keys[res], vals[res], b2)
    ok2 = torch.zeros_like(ok1)
    ok2[res] = ok2_res

    # -- round 3: the stash takes the rest, in batch (age) order -----------
    st = hm2.store
    if st.stash is None:
        return hm2, ok1 | ok2
    T = st.stash.shape[0]
    valid3 = valid_all & ~ok1 & ~ok2
    pos3 = st.stash_fill.to(I64) + torch.cumsum(valid3.to(I64), 0) \
        - valid3.to(I64)
    ok3 = valid3 & (pos3 < T)
    stash = st.stash.clone()
    stash[pos3[ok3]] = torch.stack([to_bits(keys), to_bits(vals)],
                                   dim=-1)[ok3]
    store = dataclasses.replace(
        st, stash=stash, stash_fill=(st.stash_fill + ok3.sum()).to(I32))
    return HashMem(store=store, bucket_head=hm2.bucket_head,
                   config=cfg), ok1 | ok2 | ok3


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
    """``delete`` with caller-supplied (H1) bucket ids.

    The JAX package finds the first match with a full 32-bit key compare
    over a (Q, C, S) gather of the schedule's rows, whatever the table's
    backend (18.4 GB for 1M deletes at the paper's size).  The port takes
    the [found, page, slot] lanes of the same full-key row compare instead
    (``_full_key_backend``): the first match in (column, slot) order, the
    one JAX's argmax picks.  A displaced table searches its displaced
    schedule, then the stash for queries with no pool match; a stash hit
    rewrites that stash key to TOMBSTONE."""
    from repro_torch.core.probe import probe_lanes
    cfg = hm.config
    q = to_bits(as_u32(keys, hm.device))
    pages = _schedule(hm, from_bits(q), b)
    out = probe_lanes(hm.store, q, pages, _full_key_backend(cfg))
    found = out[:, 1] != 0
    pg, s = out[:, 2].to(I64), out[:, 3].to(I64)
    wp = torch.where(found, pg, cfg.num_pages)                  # OOB drop
    store = hm.store.write_keys(wp, s, torch.full_like(q, TOMBSTONE_BITS),
                                plane_pages=_dedup_plane_pages(hm, found,
                                                               pg, s))
    if cfg.displacement and store.stash is not None:
        hit, idx = _stash_first(store.stash, q)
        hit &= ~found
        store.stash = store.stash.clone()
        store.stash[idx[hit], layout.KEY_LANE] = TOMBSTONE_BITS
        found = found | hit
    return HashMem(store=store, bucket_head=hm.bucket_head,
                   config=cfg), found


def _dedup_plane_pages(hm: HashMem, found, pg, s):
    """Page ids for the bit-plane and fingerprint updates of a tombstone
    batch: duplicate queries target one (page, slot), and only its first is
    kept, so that the update sets each bit once; None when the table keeps
    neither packed lane."""
    cfg = hm.config
    if (hm.planes is None and hm.store.fprints is None) \
            or found.numel() == 0:
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
    fprints = None if st.fprints is None else st.fprints.clone()
    fps = [] if fprints is None else fingerprint(k, st.fp_bits).tolist()
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
            if fprints is not None:
                _write_key_bits(fprints, tp, ts, fps[i], st.fp_bits)
            page_fill[tp] = ts + 1
        if need_new:
            if last < P:
                page_next[last] = free_top
            free_top += 1
    store = dataclasses.replace(
        st, pool=pool, planes=planes, fprints=fprints, page_next=page_next,
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
    if hm.config.displacement:
        return _rebuild_displaced(hm, new_cfg)
    flat = hm.store.pool.reshape(-1, 2)
    kbits = flat[:, layout.KEY_LANE]
    live = (kbits != EMPTY_BITS) & (kbits != TOMBSTONE_BITS)
    keys = from_bits(kbits)
    b = hash_to_bucket(keys, new_cfg.num_buckets, new_cfg.hash_fn,
                       new_cfg.salt)
    return _scatter_build(new_cfg, keys, from_bits(flat[:, layout.VAL_LANE]),
                          b, valid=live)


def _rebuild_displaced(hm: HashMem, new_cfg: HashMemConfig) -> HashMem:
    """Displaced rebuild: replay every live entry through the displaced
    insert, oldest placement class first.

    Flat order alone is not age order here (one key's H2 chain entries can
    sit below another key's H1 direct entries), but all duplicates of a
    key share (b1, b2); so each slot is classed as was-H1-direct (its page
    is its H1 bucket's own row) or was-chained, and class 0, then class 1,
    then the stash are replayed, each in flat order, which keeps per-key
    age order.  JAX replays every slot, the dead ones with valid=False;
    they sort after the live ones and write nothing, so only the live ones
    are replayed here."""
    cfg = hm.config
    flat = hm.store.pool.reshape(-1, 2)
    idx = torch.nonzero(_live(flat[:, layout.KEY_LANE])).squeeze(1)
    b_old = hash_to_bucket(from_bits(flat[idx, layout.KEY_LANE]),
                           cfg.num_buckets, cfg.hash_fn, cfg.salt)
    was_chained = (idx // cfg.slots_per_page != b_old).to(torch.uint8)
    del b_old
    idx = idx[torch.argsort(was_chained, stable=True)]
    del was_chained
    ks = from_bits(flat[idx, layout.KEY_LANE])
    vs = from_bits(flat[idx, layout.VAL_LANE])
    del idx
    if hm.store.stash is not None:
        st = hm.store.stash[_live(hm.store.stash[:, layout.KEY_LANE])]
        ks = torch.cat([ks, from_bits(st[:, layout.KEY_LANE])])
        vs = torch.cat([vs, from_bits(st[:, layout.VAL_LANE])])
    b1 = hash_to_bucket(ks, new_cfg.num_buckets, new_cfg.hash_fn,
                        new_cfg.salt)
    hm2, _ = _insert_displaced(create(new_cfg, hm.device), ks, vs, b1)
    return hm2


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
    proactive doubling never starves the repair of a refused batch.  Under
    resize="extendible" the reactive repair splits the refused groups
    (``insert_extendible``) instead of rebuilding.  ``events`` (optional
    dict) counts each grow under "rebuilds" (and splits and doublings under
    "splits" and "doublings").  Returns
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

    if cfg.resize == "extendible" and cfg.auto_grow:
        return insert_extendible(hm, k, v, max_grows=max_grows,
                                 events=events)

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
# Extendible resize (directory-based; Dash) -- resize="extendible"
# ---------------------------------------------------------------------------
#
# With num_buckets = 2^gd the bucket id is the low-gd-bits hash prefix and
# the bucket_head gather is the directory.  Extendible tables add a local
# depth per group (the ``local_depth`` lane, read at group-head pages):
# directory entries that share the low local_depth bits alias one chain.
#
#   * split_group: an overflowing group (local depth ld < global depth gd)
#     splits alone: its live entries are re-bucketed on hash bit ld into the
#     old head and one new page region, its aliases are repointed, and
#     every other group's pages, chains and directory entries are untouched.
#   * double_directory: at ld == gd the directory doubles by pointer copy;
#     num_buckets doubles while overflow_pages shrinks as much, so every
#     store array keeps its shape.
#   * grow()/compact() stay the fallback and reclaim path: a rebuild resets
#     the directory flat and reclaims the pages splits leaked.

def split_group(hm: HashMem, bucket: int):
    """Split the group owning ``bucket`` one level deeper (host level,
    shape-preserving).  Returns (hm, status):

      * "ok"          the split is done;
      * "need_double" local depth == global depth: double the directory;
      * "full"        the arena cannot supply the new pages;
      * "stuck"       a child would pass max_chain (its entries share hash
                      bits past this depth); only grow() helps.

    The old chain is cleared through ``write_slots`` (planes and
    fingerprints stay in step), its overflow pages are leaked until a
    rebuild, and its entries are re-inserted in chain order."""
    cfg = hm.config
    gd = bits_used(cfg.num_buckets)
    S = cfg.slots_per_page
    head0 = int(hm.bucket_head[int(bucket) % cfg.num_buckets])
    ld = int(hm.store.local_depth[head0])
    if ld >= gd:
        return hm, "need_double"
    c = int(bucket) & ((1 << ld) - 1)              # canonical group id

    # walk the chain on the host and pull its live entries in chain order
    pages = []
    page_next = hm.page_next.cpu().numpy()
    p = head0
    while p >= 0 and len(pages) <= cfg.max_chain:
        pages.append(p)
        p = int(page_next[p])
    flat = hm.store.pool[torch.as_tensor(pages, device=hm.device)]
    flat = flat.reshape(-1, 2).cpu().numpy().view(np.uint32)
    k, v = flat[:, 0], flat[:, 1]
    live = (k != np.uint32(EMPTY_KEY)) & (k != np.uint32(TOMBSTONE_KEY))
    lk = as_u32(k[live], hm.device)
    lv = as_u32(v[live], hm.device)
    hb = hash_to_bucket(lk, cfg.num_buckets, cfg.hash_fn, cfg.salt)

    # pre-flight: both children must fit before anything is written
    n_hi = int(((hb >> ld) & 1).sum())
    n_lo = lk.numel() - n_hi
    pg_lo, pg_hi = max(-(-n_lo // S), 1), max(-(-n_hi // S), 1)
    if pg_lo > cfg.max_chain or pg_hi > cfg.max_chain:
        return hm, "stuck"
    free_top = int(hm.free_top)
    if free_top + 1 + (pg_lo - 1) + (pg_hi - 1) > cfg.num_pages:
        return hm, "full"

    new_head = free_top
    L = len(pages)
    dev = hm.device
    store = hm.store.write_slots(
        torch.as_tensor(np.repeat(pages, S), device=dev),
        torch.as_tensor(np.tile(np.arange(S), L), device=dev),
        torch.full((L * S,), EMPTY_BITS, dtype=I32, device=dev),
        torch.zeros((L * S,), dtype=I32, device=dev))
    pg_arr = torch.as_tensor(pages, device=dev)
    store.page_fill = store.page_fill.clone()
    store.page_fill[pg_arr] = 0
    store.page_next = store.page_next.clone()
    store.page_next[pg_arr] = -1
    store.local_depth = store.local_depth.clone()
    store.local_depth[[head0, new_head]] = ld + 1
    store.free_top = torch.tensor(new_head + 1, dtype=I32, device=dev)

    # directory: the group's aliases are c + m * 2^ld; odd m (bit ld set)
    # takes the new head -- pointer writes only
    m = torch.arange(cfg.num_buckets >> ld, device=dev)
    bucket_head = hm.bucket_head.clone()
    bucket_head[c + (m << ld)] = torch.where(
        (m & 1) == 1, new_head, head0).to(I32)
    hm2 = HashMem(store=store, bucket_head=bucket_head, config=cfg)

    # re-insert: the insert's fold routes each entry to its depth-ld+1
    # child, keeping chain order
    if lk.numel():
        hm2, ok = insert_with_buckets(hm2, lk, lv, hb)
        if not bool(ok.all()):
            raise RuntimeError("split re-insert overflowed")
    return hm2, "ok"


def double_directory(hm: HashMem):
    """Double the bucket directory by pointer copy, with no data movement:
    num_buckets doubles and overflow_pages shrinks by the old directory
    size, so num_pages and every store array keep their shapes.  None when
    the overflow arena cannot cede num_buckets pages (the caller then falls
    back to grow())."""
    cfg = hm.config
    bits_used(cfg.num_buckets)                     # validate pow2
    if cfg.overflow_pages < cfg.num_buckets:
        return None
    cfg2 = dataclasses.replace(
        cfg, num_buckets=cfg.num_buckets * 2,
        overflow_pages=cfg.overflow_pages - cfg.num_buckets)
    return HashMem(store=hm.store,
                   bucket_head=torch.cat([hm.bucket_head, hm.bucket_head]),
                   config=cfg2)


def grow_extendible(hm: HashMem, bucket: int):
    """Make room in the group owning ``bucket``: split it, doubling the
    directory first when its local depth has reached the global depth, and
    fall back to a grow() rebuild only when the arena or the chain bound
    admits no split.  Returns (hm, how), how in {"split", "double",
    "rebuild"}; "double" means a split followed the doubling."""
    hm2, status = split_group(hm, bucket)
    if status == "ok":
        return hm2, "split"
    if status == "need_double":
        doubled = double_directory(hm)
        if doubled is not None:
            hm2, status = split_group(doubled, bucket)
            if status == "ok":
                return hm2, "double"
            hm = doubled                           # keep the wider directory
    return grow(hm), "rebuild"


def insert_extendible(hm: HashMem, keys, vals, max_splits: int = 256,
                      max_grows: int = 8, events=None):
    """Host-level insert loop for resize="extendible": refused elements
    split their groups (and double the directory) instead of rebuilding the
    table; grow() stays the bounded fallback.  Returns (new_hm, ok (B,)
    bool).  ``events`` (optional dict) counts "splits", "doublings" and
    "rebuilds"."""
    k = as_u32(keys, hm.device)
    v = as_u32(vals, hm.device)
    ok = np.zeros(k.numel(), bool)
    remaining = np.arange(k.numel())
    splits = grows = 0
    while remaining.size:
        rem = torch.as_tensor(remaining, device=hm.device)
        kr, vr = k[rem], v[rem]
        cfg = hm.config
        br = hash_to_bucket(kr, cfg.num_buckets, cfg.hash_fn, cfg.salt)
        hm, ok_r = insert_with_buckets(hm, kr, vr, br)
        ok_np = ok_r.cpu().numpy()
        ok[remaining[ok_np]] = True
        remaining = remaining[~ok_np]
        if remaining.size == 0 or splits >= max_splits or grows > max_grows:
            break
        # split every refused group once, then retry the residue; each
        # split deepens a group, so the loop ends
        for b0 in np.unique(br.cpu().numpy()[~ok_np]):
            if splits >= max_splits or grows > max_grows:
                break
            hm, how = grow_extendible(hm, int(b0))
            splits += 1
            if how == "rebuild":
                grows += 1
            if events is not None:
                key = {"split": "splits", "double": "doublings",
                       "rebuild": "rebuilds"}[how]
                events[key] = events.get(key, 0) + 1
                if how == "double":
                    events["splits"] = events.get("splits", 0) + 1
    return hm, torch.as_tensor(ok, device=hm.device)


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------

def _live(keys: torch.Tensor) -> torch.Tensor:
    return (keys != EMPTY_BITS) & (keys != TOMBSTONE_BITS)


def live_count(hm: HashMem) -> torch.Tensor:
    """() int32 number of live (non-empty, non-tombstone) entries, stash
    included."""
    n = _live(hm.key_pages).sum()
    if hm.store.stash is not None:
        n = n + _live(hm.store.stash[:, layout.KEY_LANE]).sum()
    return n.to(I32)


def load_factor(hm: HashMem) -> torch.Tensor:
    """Live entries / total slot capacity, as a float32 scalar."""
    cap = hm.config.num_pages * hm.config.slots_per_page
    return live_count(hm).to(torch.float32) / cap


def stats(hm: HashMem) -> dict:
    cfg = hm.config
    st = hm.store
    live = int(live_count(hm))
    chain_len = chain_lengths(hm).cpu().numpy()
    cap = cfg.num_pages * cfg.slots_per_page
    stash_live = stash_tomb = stash_fill = 0
    if st.stash is not None:
        sk = st.stash[:, layout.KEY_LANE]
        stash_live = int(_live(sk).sum())
        stash_tomb = int((sk == TOMBSTONE_BITS).sum())
        stash_fill = int(st.stash_fill)
    out = {
        "live_entries": live,
        "tombstones": int((hm.key_pages == TOMBSTONE_BITS).sum())
        + stash_tomb,
        "pages_used": int((hm.page_fill > 0).sum()),
        "free_pages": int(cfg.num_pages - int(hm.free_top)),
        "chain_lengths": chain_len,
        "max_chain": int(chain_len.max(initial=0)),
        "capacity": cap,
        "load_factor": float(live / cap),
        "num_buckets": cfg.num_buckets,
        "stash_live": stash_live,
        "stash_tombstones": stash_tomb,
        "stash_fill": stash_fill,
    }
    if st.local_depth is not None:
        # extendible telemetry: local depths at the heads the directory
        # points to
        depths = st.local_depth[hm.bucket_head.to(I64)]
        out |= {"global_depth": bits_used(cfg.num_buckets),
                "min_local_depth": int(depths.min()),
                "max_local_depth": int(depths.max())}
    return out
