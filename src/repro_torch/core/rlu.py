"""RLU: routing between requests and HashMem shards, the PyTorch port of the
JAX package's ``core/rlu.py`` (paper §6, "channel-level parallelism": future
work in the paper, implemented in both packages).

Buckets are partitioned over D shards the way the paper spreads pages
"across different channels and ranks ... to enable the parallel probing of
pages".  One global hash h(key) decides the routing; two routers are
supported (``shard_by``):

    "mod"       owner = h mod D,                  local bucket = (h div D) mod B
    "highbits"  owner = ((h >> 16) * D) >> 16,    local bucket = h mod B

"highbits" is the fastrange split over the hash's top 16 bits (any D); its
local bucket is the plain ``hash_to_bucket``, so a "highbits" shard is an
ordinary HashMem whose keys happen to route to it.  The serving engine uses
it.  Every hash is carried in int64 masked to 32 bits, as
``core/hashing.py`` does, so the routing is bit-equal to JAX's uint32 one.

The JAX package lays the D shards over a device mesh axis and routes each
phase with ``all_to_all`` inside one ``shard_map``.  The port runs on one
card, so it stacks the D shards there (``hashmap.stack``: one table whose
every leaf has a leading D axis, the form of JAX's stacked pytree), and the
all-to-all becomes a local permutation: ``_Route`` lays a batch of D
contiguous source blocks (as ``P(axis)`` lays it out) into the
``(D_dst, D_src, c)`` receive buffer and gathers the results back.  Each
destination's rows are its shard's batch in JAX's order (source block, then
position), so results, overflow masks and the order of duplicate keys are
JAX's.  A routed probe phase, and the find of a delete, is ONE kernel launch
for all D shards on the ``(D * P, S, 2)`` view of the stacked pool; a write
phase makes one copy of the stacked pool.

One divergence, on purpose: with an explicit ``cap`` below a batch's need,
JAX's unfused route loses the last in-capacity entry of an overflowing
destination (its pad overwrites slot ``c - 1``).  Here every entry with a
position below ``c`` keeps its slot; the entries past it are dropped and
return found=False / ok=False and value 0.  At every ``cap`` at or above
the need both agree bit for bit.

Entry points run on the stacked table's device: the card unless the caller
built it on the CPU.  ``owner_of_np`` and ``routing_cap`` are numpy.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap
from repro_torch.core.hashing import EMPTY_KEY, HASH_FNS, MASK32, as_u32

I64 = torch.int64

# Routing pad: below every sentinel, above every workload/tenant-folded key
# (kv_synth keeps raw keys < 0xFFFFFFF0 and tenancy.py reserves the top
# tenant id), so a padded slot probes/deletes nothing and an insert treats
# it as invalid -- shared with the serving engine's batch pad.
ROUTE_PAD = np.uint32(0xFFFFFFF0)

SHARD_ROUTERS = ("mod", "highbits")


def _keys(keys) -> torch.Tensor:
    """Keys as int64 uint32 values, on their tensor's device (numpy: the
    CPU)."""
    dev = keys.device if isinstance(keys, torch.Tensor) else "cpu"
    return as_u32(keys, dev)


def _global_hash(keys: torch.Tensor, cfg: HashMemConfig) -> torch.Tensor:
    return HASH_FNS[cfg.hash_fn](keys & MASK32, cfg.salt)


def _owner_from_hash(h: torch.Tensor, num_shards: int,
                     shard_by: str) -> torch.Tensor:
    """THE owner formula, shared by ``owner_of`` and
    ``owner_and_local_bucket`` so a router change cannot split routing
    between the build path and the per-phase calls."""
    if shard_by == "highbits":
        return (((h >> 16) * num_shards) & MASK32) >> 16
    if shard_by != "mod":
        raise ValueError(f"unknown router {shard_by!r}")
    return h % num_shards


def owner_of(keys, cfg: HashMemConfig, num_shards: int,
             shard_by: str = "mod") -> torch.Tensor:
    """(N,) keys -> (N,) int64 owner shard ids under the chosen router."""
    return _owner_from_hash(_global_hash(_keys(keys), cfg), num_shards,
                            shard_by)


def owner_of_np(keys, cfg: HashMemConfig, num_shards: int,
                shard_by: str = "mod") -> np.ndarray:
    """(N,) uint32 keys -> (N,) int32 owner shard ids under the chosen
    router, in numpy uint32 arithmetic (the same hash as
    ``core/hashing.py``), so a whole coalesced batch is partitioned without
    touching the device."""
    k = np.asarray(keys, np.uint32)
    if cfg.hash_fn == "murmur3_fmix":
        h = k ^ np.uint32(cfg.salt)
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    elif cfg.hash_fn == "mult_shift":
        h = (k * np.uint32(2654435761)) ^ np.uint32(cfg.salt)
    else:                                   # identity
        h = k
    if shard_by == "highbits":
        return (((h >> np.uint32(16)) * np.uint32(num_shards))
                >> np.uint32(16)).astype(np.int32)
    assert shard_by == "mod", shard_by
    return (h % np.uint32(num_shards)).astype(np.int32)


def owner_and_local_bucket(keys, cfg: HashMemConfig, num_shards: int,
                           shard_by: str = "mod"):
    """(owner, local bucket), int64 tensors on the keys' device."""
    h = _global_hash(_keys(keys), cfg)
    owner = _owner_from_hash(h, num_shards, shard_by)
    if shard_by == "highbits":
        return owner, h % cfg.num_buckets
    return owner, (h // num_shards) % cfg.num_buckets


def _local_bucket_fn(num_shards: int, shard_by: str = "mod"):
    """bucket_fn for hashmap.grow/insert on one shard: re-derive the local
    bucket from the global hash under the (possibly grown) shard config."""
    def fn(keys, cfg: HashMemConfig):
        return owner_and_local_bucket(keys, cfg, num_shards, shard_by)[1]
    return fn


def _check_stack(hm_stacked, num_shards: int):
    D = hm_stacked.bucket_head.shape[0] \
        if hm_stacked.bucket_head.dim() == 2 else 0
    if D != num_shards:
        raise ValueError(f"want a stacked table of {num_shards} shards, got "
                         f"bucket_head of shape "
                         f"{tuple(hm_stacked.bucket_head.shape)}")


# ---------------------------------------------------------------------------
# Sharded build and the host-level routed insert
# ---------------------------------------------------------------------------

def build_sharded(cfg: HashMemConfig, keys, vals, num_shards: int,
                  shard_by: str = "mod", device=None):
    """Build per-shard HashMems; returns them stacked (leading axis
    num_shards, shard i's leaves at index i).  ``cfg.num_buckets`` is the
    PER-SHARD bucket count.

    As in JAX, every shard's batch is the whole batch with its own keys
    first and every other key an EMPTY_KEY pad in bucket 0: a chained
    shard stores those pads (they never match a probe, but they take bucket
    0's slots and overflow pages), so this suits small tables; load a large
    one through ``insert_sharded``."""
    dev = hashmap.resolve_device(device)
    k, v = as_u32(keys, dev), as_u32(vals, dev)
    owner, local = owner_and_local_bucket(k, cfg, num_shards, shard_by)
    shards = []
    for d in range(num_shards):
        m = owner == d
        idx = torch.argsort((~m).to(torch.uint8), stable=True)
        mi = m[idx]
        shards.append(hashmap.build_with_buckets(
            cfg, torch.where(mi, k[idx], EMPTY_KEY),
            torch.where(mi, v[idx], 0), torch.where(mi, local[idx], 0), dev))
    return hashmap.stack(shards)


def insert_sharded(hm_stacked, keys, vals, cfg: HashMemConfig,
                   num_shards: int, max_grows: int = 4,
                   shard_by: str = "mod", max_splits: int = 256,
                   events: Optional[dict] = None):
    """Host-level routed insert into the stacked table.

    Keys are routed to their owner shard (the same global-hash split as
    build_sharded) and batch-inserted shard by shard.  When a shard refuses
    elements and cfg.auto_grow is set, the repair depends on ``cfg.resize``:

      * "rebuild": ALL shards grow by the same factor (the stack must stay
        shape-homogeneous) and the refused elements retry;
      * "extendible": the refused GROUPS on the refusing shards split
        (hashmap.split_group), a local, shape-preserving change; only a
        directory doubling is synchronized across all shards, and it moves
        no slot data.  A split the arena or chain bound refuses falls back
        to a synchronized grow() rebuild.

    Returns (hm_stacked', ok (N,) bool, cfg').  cfg' differs from cfg after
    growth or doubling: pass it to later calls.  ``events`` (optional dict)
    accumulates "splits"/"doublings"/"rebuilds" counts."""
    _check_stack(hm_stacked, num_shards)
    dev = hm_stacked.device
    keys, vals = as_u32(keys, dev), as_u32(vals, dev)
    n = keys.numel()
    owner_np = owner_of(keys, cfg, num_shards, shard_by).cpu().numpy()
    bfn = _local_bucket_fn(num_shards, shard_by)
    shards = hashmap.unstack(hm_stacked)
    extendible = cfg.resize == "extendible"

    def _bump(k):
        if events is not None:
            events[k] = events.get(k, 0) + 1

    ok = np.zeros((n,), bool)
    remaining = {d: np.nonzero(owner_np == d)[0] for d in range(num_shards)}
    grows = splits = 0
    while True:
        any_fail = False
        failed_buckets: dict = {}
        for d in range(num_shards):
            idx = remaining[d]
            if idx.size == 0:
                continue
            it = torch.as_tensor(idx, device=dev)
            kd, vd = keys[it], vals[it]
            bd = bfn(kd, shards[d].config)
            shards[d], ok_d = hashmap.insert_with_buckets(shards[d], kd, vd,
                                                          bd)
            ok_np = ok_d.cpu().numpy()
            ok[idx[ok_np]] = True
            remaining[d] = idx[~ok_np]
            if remaining[d].size:
                any_fail = True
                failed_buckets[d] = np.unique(bd.cpu().numpy()[~ok_np])
        if not any_fail or not cfg.auto_grow:
            break
        rebuild = not extendible
        if extendible and splits < max_splits:
            # split the refused groups in place: local, shape-preserving
            need_double = False
            progressed = False
            for d, bks in failed_buckets.items():
                for b0 in bks:
                    hm2, status = hashmap.split_group(shards[d], int(b0),
                                                      bucket_fn=bfn)
                    if status == "ok":
                        shards[d] = hm2
                        splits += 1
                        progressed = True
                        _bump("splits")
                    elif status == "need_double":
                        need_double = True
                    else:                         # "full" | "stuck"
                        rebuild = True
            if need_double and not rebuild:
                doubled = [hashmap.double_directory(s) for s in shards]
                if all(x is not None for x in doubled):
                    shards = doubled            # synchronized pointer copy
                    progressed = True
                    _bump("doublings")
                else:                           # arena can't cede pages
                    rebuild = True
            if not progressed and not rebuild:
                rebuild = True                  # nothing moved: escalate
        elif extendible:
            rebuild = True                      # split budget exhausted
        if rebuild:
            if grows >= max_grows:
                break
            # synchronized growth keeps every shard the same shape
            shards = [hashmap.grow(s, bucket_fn=bfn) for s in shards]
            grows += 1
            _bump("rebuilds")

    return (hashmap.stack(shards), torch.as_tensor(ok, device=dev),
            shards[0].config)


# ---------------------------------------------------------------------------
# Routing: the all-to-all as a permutation on one card
# ---------------------------------------------------------------------------

class _Route:
    """Owner routing of a (Q,) batch laid out as D contiguous source blocks
    of Q_local = Q / D entries.  Source block s sends its entries, in batch
    order (a stable sort, which keeps duplicate-key FIFO order end to end),
    to their owners: slot ``pos`` of row (d, s) of the ``(D_dst, D_src, c)``
    receive buffer, where ``pos`` counts the entries of block s routed to d
    before it.  Row d, read flat, is shard d's batch, as JAX's ``recv``
    after its all_to_all.

    ``drop_invalid=True`` (the fused tick) excludes entries equal to
    ``pad``: they are routed nowhere, take no capacity and gather back
    0/False, which lets the two-pass scheme set ``c`` to the measured
    maximum of valid entries.  An entry with ``pos >= c`` is dropped too
    (see the module docstring)."""

    def __init__(self, queries: torch.Tensor, owner: torch.Tensor,
                 num_shards: int, c: int, pad, drop_invalid: bool = False):
        D = num_shards
        qn = queries.numel()
        if qn % D:
            raise ValueError(f"a routed batch of {qn} does not split into "
                             f"{D} source blocks")
        self.num_shards, self.c, self.pad = D, c, int(pad)
        self.drop_invalid = drop_invalid
        self.queries = queries
        dev = queries.device
        owner = owner.to(I64)
        if drop_invalid:
            owner = torch.where(queries != int(pad), owner, D)
        src = torch.arange(qn, device=dev) // (qn // D)
        self.key = src * (D + 1) + owner        # (source, destination) run
        # the run ids are small: a 32-bit radix sort takes half the passes
        order = torch.argsort(self.key.to(torch.int32), stable=True)
        rank, self._counts = hashmap._segment_rank(self.key[order],
                                                   D * (D + 1))
        pos = torch.empty_like(rank)
        pos[order] = rank
        self.keep = (owner < D) & (pos < c)
        # flat receive-buffer slot of each entry; dropped ones: the spare
        self.slot = torch.where(self.keep, (owner * D + src) * c + pos,
                                D * D * c)
        self.shard = torch.arange(D, device=dev).repeat_interleave(D * c)

    def recv(self, x: Optional[torch.Tensor] = None, fill=None):
        """The (D * D * c,) receive buffer of ``x`` (default: the queries),
        unfilled slots ``fill`` (default: the pad), in shard-major order;
        ``self.shard`` holds each slot's shard."""
        x = self.queries if x is None else x
        fill = self.pad if fill is None else fill
        n = self.num_shards ** 2 * self.c
        buf = torch.full((n + 1,), fill, dtype=x.dtype, device=x.device)
        buf[self.slot] = x
        return buf[:n]

    @property
    def send(self) -> torch.Tensor:
        """(D_src, D_dst, c): each source block's send buffer, JAX's
        ``_Route.send`` of each shard."""
        D, c = self.num_shards, self.c
        return self.recv().view(D, D, c).transpose(0, 1)

    def counts(self) -> torch.Tensor:
        """(D_src, D_dst) int64: valid entries each source block routes to
        each destination -- the payload of the two-pass count exchange
        (drop_invalid only)."""
        assert self.drop_invalid
        D = self.num_shards
        return self._counts.view(D, D + 1)[:, :D]

    def gather_back(self, back: torch.Tensor) -> torch.Tensor:
        """(D * D * c,) results in receive-buffer order -> batch order; a
        dropped or invalid entry gets 0 (False)."""
        out = back[self.slot.clamp(max=back.numel() - 1)]
        return torch.where(self.keep, out, torch.zeros((), dtype=out.dtype,
                                                       device=out.device))


def _check_mesh(mesh, hm_stacked, axis: str) -> int:
    D = mesh.shape[axis]
    _check_stack(hm_stacked, D)
    if hm_stacked.device != mesh.device:
        raise ValueError(f"the stacked table is on {hm_stacked.device}, the "
                         f"mesh on {mesh.device}")
    return D


def _routed(q: torch.Tensor, D: int, cap, pad, cfg: HashMemConfig,
            shard_by: str, drop_invalid: bool = False):
    """(route, receive buffer, its local buckets): the routing of one phase
    -- one hash for owner and local bucket, stable sort, send scatter -- in
    one ``rlu.route`` range.  An unfilled slot's bucket is 0: a pad's
    result is never gathered back, a ROUTE_PAD delete matches nothing and
    a pad insert is invalid, so no bucket of a pad changes any result or
    leaf."""
    with record_function("rlu.route"):
        owner, lb = owner_and_local_bucket(q, cfg, D, shard_by)
        rt = _Route(q, owner, D, cap or q.numel() // D, pad, drop_invalid)
        return rt, rt.recv(), rt.recv(lb, 0)


def _probe_routed(hm_stacked, routed):
    rt, q, lb = routed
    v, f = hashmap.probe_with_buckets(hm_stacked, q, lb, sh=rt.shard)
    with record_function("rlu.gather_back"):
        return rt.gather_back(v), rt.gather_back(f)


def _delete_routed(hm_stacked, routed):
    rt, q, lb = routed
    # ROUTE_PAD never matches a stored row -> found=False, no write
    hm2, found = hashmap.delete_with_buckets(hm_stacked, q, lb, sh=rt.shard)
    with record_function("rlu.gather_back"):
        return hm2, rt.gather_back(found)


def _insert_routed(hm_stacked, routed, vals, valid):
    rt, k, lb = routed
    hm2, ok = hashmap.insert_with_buckets(hm_stacked, k, rt.recv(vals, 0),
                                          lb, valid=valid, sh=rt.shard)
    with record_function("rlu.gather_back"):
        return hm2, rt.gather_back(ok)


def probe_sharded(mesh, hm_stacked, queries, cfg: HashMemConfig,
                  axis: str = "model", cap: Optional[int] = None,
                  shard_by: str = "mod"):
    """Channel-parallel probe of (Q,) queries laid out as D source blocks.

    cap = per-(source, destination) routing capacity; None -> Q_local
    (always sufficient).  Returns (values (Q,) int64, found (Q,) bool) in
    query order.  One kernel launch probes all D shards."""
    D = _check_mesh(mesh, hm_stacked, axis)
    q = as_u32(queries, hm_stacked.device)
    return _probe_routed(hm_stacked, _routed(q, D, cap, EMPTY_KEY, cfg,
                                             shard_by))


def delete_sharded(mesh, hm_stacked, keys, cfg: HashMemConfig,
                   axis: str = "model", cap: Optional[int] = None,
                   shard_by: str = "mod"):
    """Channel-parallel batched tombstone delete: every key is routed to
    its owner shard, deleted there (one kernel launch finds all D shards'
    matches), and the found mask routed back.  Returns (hm_stacked', found
    (Q,)).  Mirrors ``hashmap.delete`` per owner shard (duplicate queries
    resolve to one removal)."""
    D = _check_mesh(mesh, hm_stacked, axis)
    q = as_u32(keys, hm_stacked.device)
    return _delete_routed(hm_stacked, _routed(q, D, cap, ROUTE_PAD, cfg,
                                              shard_by))


def insert_mesh(mesh, hm_stacked, keys, vals, cfg: HashMemConfig,
                axis: str = "model", cap: Optional[int] = None,
                shard_by: str = "mod"):
    """Channel-parallel FIXED-ARENA batched insert: keys and values are
    routed to their owner shards and appended by the vectorized mutation
    engine, each shard from its own arena.  Returns (hm_stacked', ok (Q,)).

    ok=False elements were refused (arena or chain bound): growth is the
    caller's host-level fallback (``insert_sharded``, which keeps all
    shards the same shape).  Keys equal to ROUTE_PAD are padding: never
    stored, always ok=False.  Duplicate keys keep batch order."""
    D = _check_mesh(mesh, hm_stacked, axis)
    dev = hm_stacked.device
    k, v = as_u32(keys, dev), as_u32(vals, dev)
    routed = _routed(k, D, cap, ROUTE_PAD, cfg, shard_by)
    return _insert_routed(hm_stacked, routed, v,
                          routed[1] != int(ROUTE_PAD))


# ---------------------------------------------------------------------------
# The fused tick: probe -> delete -> insert in one call
# ---------------------------------------------------------------------------

def routing_cap(keys, cfg: HashMemConfig, num_shards: int,
                shard_by: str = "mod", *, quantum: int = 8) -> int:
    """Pass 1 of the two-pass count+route scheme, host mirror: the max
    per-(src,dst) VALID-key count for a (Q,) batch laid out contiguously
    across ``num_shards`` source blocks (entries equal to ROUTE_PAD don't
    count -- the fused route drops them).

    The result is rounded up to a multiple of ``quantum`` (bounds the set
    of capacities to Q_local/quantum per batch shape) and clamped to
    [min(quantum, Q_local), Q_local].  The ORDER matters: the quantum floor
    applies first and the Q_local ceiling LAST, so a tiny batch (Q_local <
    quantum) caps at Q_local.  Rounding is UP, so the capacity can never
    truncate; on a skewed tick it tracks the measured max instead of the
    worst-case Q_local the unfused path pads to."""
    k = np.asarray(keys, np.uint32)
    q = k.shape[0]
    assert q % num_shards == 0, (q, num_shards)
    q_local = q // num_shards
    valid = k != ROUTE_PAD
    mx = 0
    if valid.any():
        owner = owner_of_np(k, cfg, num_shards, shard_by)
        src = np.arange(q) // q_local
        pair = (src * num_shards + owner)[valid]
        mx = int(np.bincount(pair, minlength=num_shards * num_shards).max())
    cap = max(quantum, -(-mx // quantum) * quantum)
    cap = min(cap, q_local)                 # ceiling wins over the floor
    assert cap <= q_local, (cap, q_local)
    return cap


def tick_mesh(mesh, hm_stacked, probe_q, del_q, ins_k, ins_v,
              cfg: HashMemConfig, axis: str = "model",
              caps=None, shard_by: str = "mod"):
    """A whole coalesced serving tick in one call: the stacked table is
    carried through probe -> delete -> insert on the card.

    ``caps``: per-phase (probe, delete, insert) per-(src,dst) routing
    capacities from the two-pass scheme -- compute each with
    ``routing_cap`` on the same batches; ``None`` (or a 0 entry) falls back
    to the worst-case Q_local.  Entries equal to ROUTE_PAD are padding in
    every phase: routed nowhere, never stored, results 0/False.

    Returns (hm_stacked', probe_vals, probe_found, del_found, ins_ok) with
    the semantics of ``probe_sharded`` (against the pre-tick table) ->
    ``delete_sharded`` -> ``insert_mesh`` (against the post-delete table)
    issued back to back."""
    caps = tuple(caps) if caps is not None else (None, None, None)
    assert len(caps) == 3, caps
    D = _check_mesh(mesh, hm_stacked, axis)
    dev = hm_stacked.device
    pq, dq = as_u32(probe_q, dev), as_u32(del_q, dev)
    ik, iv = as_u32(ins_k, dev), as_u32(ins_v, dev)
    pad = ROUTE_PAD
    rp, rd, ri = (_routed(x, D, c, pad, cfg, shard_by, drop_invalid=True)
                  for x, c in ((pq, caps[0]), (dq, caps[1]), (ik, caps[2])))
    # pass 1: the per-(src, dst) valid counts of the three phases,
    # exchanged: counts_in[d, s] is what source s sent shard d
    counts = torch.stack([r[0].counts() for r in (rp, rd, ri)], -1)
    counts_in = counts.transpose(0, 1)                 # (D_dst, D_src, 3)
    v, f = _probe_routed(hm_stacked, rp)
    hm2, dfound = _delete_routed(hm_stacked, rd)
    # insert validity from the count exchange: slot j of receive row
    # (d, s) holds a key iff j < counts_in[d, s] (the routed prefix is
    # dense)
    ci = ri[0].c
    valid = (torch.arange(ci, device=dev)[None, None, :]
             < counts_in[:, :, 2:3]).reshape(-1)
    hm3, iok = _insert_routed(hm2, ri, iv, valid)
    return hm3, v, f, dfound, iok


def probe_replicated(mesh, hm, queries, cfg: HashMemConfig,
                     axis: str = "data"):
    """Throughput mode: the table replicated, queries sharded over
    ``axis`` (pure data parallelism -- the paper's multi-rank replication
    counterpoint).  On one card every replica is the one table, so this is
    one probe of the whole batch: one kernel launch."""
    del mesh, axis
    return hashmap.probe(hm, queries, backend=cfg.backend)
