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
phase with ``all_to_all`` inside one ``shard_map``.  The port has both
forms, chosen by the mesh's type (``launch/mesh.py``):

  * a ``ServingMesh`` stacks the D shards on one device
    (``hashmap.stack``: one table whose every leaf has a leading D axis,
    the form of JAX's stacked pytree), and the all-to-all becomes a local
    permutation: ``_Route`` lays a batch of D contiguous source blocks (as
    ``P(axis)`` lays it out) into the ``(D_dst, D_src, c)`` receive buffer
    and gathers the results back.  A routed probe phase, and the find of a
    delete, is ONE kernel launch for all D shards on the ``(D * P, S, 2)``
    view of the stacked pool; a write phase makes one copy of the stacked
    pool;
  * a ``RankMesh`` holds one shard a rank (a stack of one on the rank's
    device) and runs the body JAX runs for one device: ``_Route`` of the
    rank's own source block forms the ``(D_dst, c)`` send buffer,
    ``all_to_all_single`` delivers it as the ``(D_src, c)`` receive
    buffer, the local phase runs on it (one kernel launch a probe phase
    and a delete's find, on each rank), and a second exchange brings the
    results back.  Each exchange runs in an ``rlu.exchange`` range.  Keys
    and values travel as int32 bits, masks as uint8.

Either way each destination's rows are its shard's batch in JAX's order
(source block, then position), so results, overflow masks and the order of
duplicate keys are JAX's.

One divergence, on purpose: with an explicit ``cap`` below a batch's need,
JAX's unfused route loses the last in-capacity entry of an overflowing
destination (its pad overwrites slot ``c - 1``).  Here every entry with a
position below ``c`` keeps its slot; the entries past it are dropped and
return found=False / ok=False and value 0.  At every ``cap`` at or above
the need both agree bit for bit.

Entry points run on the table's device: the card unless the caller built
it on the CPU.  ``owner_of_np`` and ``routing_cap`` are numpy.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap
from repro_torch.core.hashing import EMPTY_KEY, HASH_FNS, MASK32, as_u32
from repro_torch.core.layout import from_bits, to_bits
from repro_torch.launch.mesh import RankMesh

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

def _mine(mesh, num_shards: int) -> list:
    """The shards this process holds: all of them, or its rank's."""
    if isinstance(mesh, RankMesh):
        if mesh.num_shards != num_shards:
            raise ValueError(f"{num_shards} shards on a world of "
                             f"{mesh.num_shards} ranks")
        return [mesh.rank]
    return list(range(num_shards))


def _reduce(mesh, values: list, op: str) -> list:
    """Small ints reduced over the ranks ("max", "min" or "sum"; off a
    RankMesh the values themselves): the decisions every rank must make
    alike."""
    if not isinstance(mesh, RankMesh):
        return values
    import torch.distributed as dist
    t = torch.tensor(values, dtype=I64, device=mesh.device)
    dist.all_reduce(t, op={"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
                           "sum": dist.ReduceOp.SUM}[op], group=mesh.group)
    return [int(x) for x in t.tolist()]


def build_sharded(cfg: HashMemConfig, keys, vals, num_shards: int,
                  shard_by: str = "mod", device=None, mesh=None):
    """Build per-shard HashMems; returns them stacked (leading axis
    num_shards, shard i's leaves at index i).  ``cfg.num_buckets`` is the
    PER-SHARD bucket count.  On a ``RankMesh`` every rank takes the whole
    batch and builds its own shard only, a stack of one on its device.

    As in JAX, every shard's batch is the whole batch with its own keys
    first and every other key an EMPTY_KEY pad in bucket 0: a chained
    shard stores those pads (they never match a probe, but they take bucket
    0's slots and overflow pages), so this suits small tables; load a large
    one through ``insert_sharded``."""
    dev = mesh.device if isinstance(mesh, RankMesh) \
        else hashmap.resolve_device(device)
    k, v = as_u32(keys, dev), as_u32(vals, dev)
    owner, local = owner_and_local_bucket(k, cfg, num_shards, shard_by)
    shards = []
    for d in _mine(mesh, num_shards):
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
                   events: Optional[dict] = None, mesh=None):
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

    On a ``RankMesh`` (``mesh=``) every rank passes the whole batch and its
    own shard, a stack of one, and inserts what it owns; each decision
    that must be the same on every rank (whether any element was refused,
    what the splits did, whether every shard can double, whether to grow)
    is one ``all_reduce``, so the rank's shard ends equal to leaf ``rank``
    of the stacked result.

    Returns (hm_stacked', ok (N,) bool, cfg'); on a RankMesh ``ok`` is the
    whole batch's mask on every rank.  cfg' differs from cfg after growth
    or doubling: pass it to later calls.  ``events`` (optional dict)
    accumulates "splits"/"doublings"/"rebuilds" counts."""
    mine = _mine(mesh, num_shards)
    _check_stack(hm_stacked, len(mine))
    dev = hm_stacked.device
    keys, vals = as_u32(keys, dev), as_u32(vals, dev)
    n = keys.numel()
    owner_np = owner_of(keys, cfg, num_shards, shard_by).cpu().numpy()
    bfn = _local_bucket_fn(num_shards, shard_by)
    shards = dict(zip(mine, hashmap.unstack(hm_stacked)))
    extendible = cfg.resize == "extendible"

    def _bump(k, by=1):
        if events is not None and by:
            events[k] = events.get(k, 0) + by

    ok = np.zeros((n,), bool)
    remaining = {d: np.nonzero(owner_np == d)[0] for d in mine}
    grows = splits = 0
    while True:
        failed_buckets: dict = {}
        for d in mine:
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
                failed_buckets[d] = np.unique(bd.cpu().numpy()[~ok_np])
        any_fail, = _reduce(mesh, [bool(failed_buckets)], "max")
        if not any_fail or not cfg.auto_grow:
            break
        rebuild = not extendible
        if extendible and splits < max_splits:
            # split the refused groups in place: local, shape-preserving
            n_split = need_double = progressed = stuck = 0
            for d, bks in failed_buckets.items():
                for b0 in bks:
                    hm2, status = hashmap.split_group(shards[d], int(b0),
                                                      bucket_fn=bfn)
                    if status == "ok":
                        shards[d] = hm2
                        n_split += 1
                    elif status == "need_double":
                        need_double = 1
                    else:                         # "full" | "stuck"
                        stuck = 1
            n_split, = _reduce(mesh, [n_split], "sum")
            need_double, stuck = _reduce(mesh, [need_double, stuck], "max")
            splits += n_split
            _bump("splits", n_split)
            progressed = n_split > 0
            rebuild = bool(stuck)
            if need_double and not rebuild:
                doubled = {d: hashmap.double_directory(s)
                           for d, s in shards.items()}
                can, = _reduce(mesh, [all(x is not None
                                          for x in doubled.values())], "min")
                if can:
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
            shards = {d: hashmap.grow(s, bucket_fn=bfn)
                      for d, s in shards.items()}
            grows += 1
            _bump("rebuilds")

    ok_t = torch.as_tensor(ok, device=dev)
    if isinstance(mesh, RankMesh):
        import torch.distributed as dist
        ok8 = ok_t.to(torch.uint8)
        dist.all_reduce(ok8, op=dist.ReduceOp.MAX, group=mesh.group)
        ok_t = ok8 != 0
    return (hashmap.stack([shards[d] for d in mine]), ok_t,
            shards[mine[0]].config)


# ---------------------------------------------------------------------------
# Routing: the all-to-all as a permutation on one card
# ---------------------------------------------------------------------------

class _Route:
    """Owner routing of a (Q,) batch laid out as ``sources`` contiguous
    source blocks of Q / sources entries (default: D, the stacked mesh's
    whole batch; 1: one rank's own block).  Source block s sends its
    entries, in batch order (a stable sort, which keeps duplicate-key FIFO
    order end to end), to their owners: slot ``pos`` of row (d, s) of the
    ``(D_dst, sources, c)`` buffer, where ``pos`` counts the entries of
    block s routed to d before it.  On the stacked mesh row d, read flat,
    is shard d's batch, as JAX's ``recv`` after its all_to_all; for one
    block the buffer is the ``(D_dst, c)`` send buffer of JAX's per-shard
    ``_Route``.

    ``drop_invalid=True`` (the fused tick) excludes entries equal to
    ``pad``: they are routed nowhere, take no capacity and gather back
    0/False, which lets the two-pass scheme set ``c`` to the measured
    maximum of valid entries.  An entry with ``pos >= c`` is dropped too
    (see the module docstring)."""

    def __init__(self, queries: torch.Tensor, owner: torch.Tensor,
                 num_shards: int, c: int, pad, drop_invalid: bool = False,
                 sources: Optional[int] = None):
        D = num_shards
        S = D if sources is None else sources
        qn = queries.numel()
        if qn % S:
            raise ValueError(f"a routed batch of {qn} does not split into "
                             f"{S} source blocks")
        self.num_shards, self.sources, self.c = D, S, c
        self.pad = int(pad)
        self.drop_invalid = drop_invalid
        self.queries = queries
        dev = queries.device
        owner = owner.to(I64)
        if drop_invalid:
            owner = torch.where(queries != int(pad), owner, D)
        src = torch.arange(qn, device=dev) // (qn // S)
        self.key = src * (D + 1) + owner        # (source, destination) run
        # the run ids are small: a 32-bit radix sort takes half the passes
        order = torch.argsort(self.key.to(torch.int32), stable=True)
        rank, self._counts = hashmap._segment_rank(self.key[order],
                                                   S * (D + 1))
        pos = torch.empty_like(rank)
        pos[order] = rank
        self.keep = (owner < D) & (pos < c)
        # flat buffer slot of each entry; dropped ones: the spare
        self.slot = torch.where(self.keep, (owner * S + src) * c + pos,
                                D * S * c)
        self.shard = torch.arange(D, device=dev).repeat_interleave(S * c)

    def recv(self, x: Optional[torch.Tensor] = None, fill=None):
        """The (D * sources * c,) buffer of ``x`` (default: the queries),
        unfilled slots ``fill`` (default: the pad), in shard-major order;
        ``self.shard`` holds each slot's shard."""
        x = self.queries if x is None else x
        fill = self.pad if fill is None else fill
        n = self.num_shards * self.sources * self.c
        buf = torch.full((n + 1,), fill, dtype=x.dtype, device=x.device)
        buf[self.slot] = x
        return buf[:n]

    @property
    def send(self) -> torch.Tensor:
        """(sources, D_dst, c): each source block's send buffer, JAX's
        ``_Route.send`` of each shard."""
        return self.recv().view(self.num_shards, self.sources,
                                self.c).transpose(0, 1)

    def counts(self) -> torch.Tensor:
        """(sources, D_dst) int64: valid entries each source block routes
        to each destination -- the payload of the two-pass count exchange
        (drop_invalid only)."""
        assert self.drop_invalid
        D = self.num_shards
        return self._counts.view(self.sources, D + 1)[:, :D]

    def gather_back(self, back: torch.Tensor) -> torch.Tensor:
        """(D * sources * c,) results in buffer order -> batch order; a
        dropped or invalid entry gets 0 (False)."""
        out = back[self.slot.clamp(max=back.numel() - 1)]
        return torch.where(self.keep, out, torch.zeros((), dtype=out.dtype,
                                                       device=out.device))


def _check_mesh(mesh, hm, axis: str) -> int:
    """D, after checking that ``hm`` is the mesh's table: the stack of D
    shards on a ServingMesh, the rank's stack of one on a RankMesh, on the
    mesh's device."""
    D = mesh.shape[axis]
    _check_stack(hm, 1 if isinstance(mesh, RankMesh) else D)
    if hm.device != mesh.device:
        raise ValueError(f"the table is on {hm.device}, the mesh on "
                         f"{mesh.device}")
    return D


class _Phase(NamedTuple):
    """One routed phase as the table sees it: the batch of its shard(s)
    (the receive buffer), its local buckets, each entry's shard in the
    table, the routed values (insert), and ``back``, which takes the local
    results to batch order."""
    q: torch.Tensor
    lb: torch.Tensor
    sh: torch.Tensor
    vals: Optional[torch.Tensor]
    back: Callable


def _route(mesh, q: torch.Tensor, D: int, cap, pad, cfg: HashMemConfig,
           shard_by: str, drop_invalid: bool = False):
    """(route, local buckets) of one phase in one ``rlu.route`` range: one
    hash, the stable sort, the slots.  On a ServingMesh the batch is D
    source blocks and one hash gives owner and local bucket; on a RankMesh
    it is the rank's block, and the receiver hashes what it gets (None)."""
    with record_function("rlu.route"):
        if isinstance(mesh, RankMesh):
            owner = owner_of(q, cfg, D, shard_by)
            return _Route(q, owner, D, cap or q.numel(), pad, drop_invalid,
                          sources=1), None
        owner, lb = owner_and_local_bucket(q, cfg, D, shard_by)
        return _Route(q, owner, D, cap or q.numel() // D, pad,
                      drop_invalid), lb


def _exchange(mesh, x: torch.Tensor) -> torch.Tensor:
    """``all_to_all_single`` of a (D, ...) tensor over the rank mesh's
    group, in an ``rlu.exchange`` range: row d goes to rank d, and row s
    of the result came from rank s.  A failed collective raises."""
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty_like(x)
    t0 = time.perf_counter()
    with record_function("rlu.exchange"):
        dist.all_to_all_single(out, x, group=mesh.group)
    st = mesh.exchanges
    st["calls"] += 1
    st["bytes"] += x.numel() * x.element_size()
    st["seconds"] += time.perf_counter() - t0
    return out


def _gather_back(rt: _Route, x: torch.Tensor) -> torch.Tensor:
    with record_function("rlu.gather_back"):
        return rt.gather_back(x)


def _send_back(mesh, rt: _Route, x: torch.Tensor) -> torch.Tensor:
    """A rank's local results, (D_src * c,), back to their senders (masks
    as uint8, values as int32 bits), then into batch order."""
    D, c = rt.num_shards, rt.c
    if x.dtype == torch.bool:
        got = _exchange(mesh, x.to(torch.uint8).view(D, c)).reshape(-1) != 0
    else:
        got = from_bits(_exchange(mesh, to_bits(x).view(D, c)).reshape(-1))
    return _gather_back(rt, got)


def _deliver(mesh, routed, cfg: HashMemConfig, shard_by: str,
             vals: Optional[torch.Tensor] = None) -> _Phase:
    """The routed batch where its shard(s) live.  ServingMesh: the receive
    buffer of the stacked shards, an unfilled slot in bucket 0 (a pad's
    result is never gathered back, a ROUTE_PAD delete matches nothing and
    a pad insert is invalid, so no bucket of a pad changes any result or
    leaf).  RankMesh: the send buffer, keys and values as one (D, k, c)
    int32 exchange; the receiver hashes its (D_src * c,) batch."""
    rt, lb = routed
    D = rt.num_shards
    if not isinstance(mesh, RankMesh):
        with record_function("rlu.route"):
            return _Phase(rt.recv(), rt.recv(lb, 0), rt.shard,
                          None if vals is None else rt.recv(vals, 0),
                          lambda x: _gather_back(rt, x))
    with record_function("rlu.route"):
        send = [rt.recv()] + ([] if vals is None else [rt.recv(vals, 0)])
        buf = torch.stack([to_bits(x).view(D, rt.c) for x in send], 1)
    got = _exchange(mesh, buf)
    with record_function("rlu.route"):
        q = from_bits(got[:, 0]).reshape(-1)
        lb = owner_and_local_bucket(q, cfg, D, shard_by)[1]
        rv = None if vals is None else from_bits(got[:, 1]).reshape(-1)
    return _Phase(q, lb, torch.zeros_like(lb), rv,
                  lambda x: _send_back(mesh, rt, x))


def _probe_routed(hm, ph: _Phase):
    v, f = hashmap.probe_with_buckets(hm, ph.q, ph.lb, sh=ph.sh)
    return ph.back(v), ph.back(f)


def _delete_routed(hm, ph: _Phase):
    # ROUTE_PAD never matches a stored row -> found=False, no write
    hm2, found = hashmap.delete_with_buckets(hm, ph.q, ph.lb, sh=ph.sh)
    return hm2, ph.back(found)


def _insert_routed(hm, ph: _Phase, valid):
    hm2, ok = hashmap.insert_with_buckets(hm, ph.q, ph.vals, ph.lb,
                                          valid=valid, sh=ph.sh)
    return hm2, ph.back(ok)


def _phase(mesh, x, D, cap, pad, cfg, shard_by, vals=None) -> _Phase:
    return _deliver(mesh, _route(mesh, x, D, cap, pad, cfg, shard_by), cfg,
                    shard_by, vals)


def probe_sharded(mesh, hm_stacked, queries, cfg: HashMemConfig,
                  axis: str = "model", cap: Optional[int] = None,
                  shard_by: str = "mod"):
    """Channel-parallel probe of (Q,) queries laid out as D source blocks
    (on a RankMesh: the rank's own block, against its shard).

    cap = per-(source, destination) routing capacity; None -> Q_local
    (always sufficient).  Returns (values (Q,) int64, found (Q,) bool) in
    query order.  One kernel launch probes all D stacked shards, or the
    rank's shard."""
    D = _check_mesh(mesh, hm_stacked, axis)
    q = as_u32(queries, hm_stacked.device)
    return _probe_routed(hm_stacked, _phase(mesh, q, D, cap, EMPTY_KEY,
                                            cfg, shard_by))


def delete_sharded(mesh, hm_stacked, keys, cfg: HashMemConfig,
                   axis: str = "model", cap: Optional[int] = None,
                   shard_by: str = "mod"):
    """Channel-parallel batched tombstone delete: every key is routed to
    its owner shard, deleted there (one kernel launch finds all D stacked
    shards' matches, or the rank's), and the found mask routed back.
    Returns (hm_stacked', found (Q,)).  Mirrors ``hashmap.delete`` per
    owner shard (duplicate queries resolve to one removal)."""
    D = _check_mesh(mesh, hm_stacked, axis)
    q = as_u32(keys, hm_stacked.device)
    return _delete_routed(hm_stacked, _phase(mesh, q, D, cap, ROUTE_PAD,
                                             cfg, shard_by))


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
    ph = _phase(mesh, k, D, cap, ROUTE_PAD, cfg, shard_by, v)
    return _insert_routed(hm_stacked, ph, ph.q != int(ROUTE_PAD))


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
    """A whole coalesced serving tick in one call: the table (the stacked
    shards, or the rank's shard) is carried through probe -> delete ->
    insert on its device.

    ``caps``: per-phase (probe, delete, insert) per-(src,dst) routing
    capacities from the two-pass scheme -- compute each with
    ``routing_cap`` on the same (whole) batches; ``None`` (or a 0 entry)
    falls back to the worst-case Q_local.  Entries equal to ROUTE_PAD are
    padding in every phase: routed nowhere, never stored, results
    0/False.

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
    routes = [_route(mesh, x, D, c, ROUTE_PAD, cfg, shard_by,
                     drop_invalid=True)
              for x, c in ((pq, caps[0]), (dq, caps[1]), (ik, caps[2]))]
    # pass 1: the per-(src, dst) valid counts of the three phases,
    # exchanged: counts_in[..., s, :] is what source s sent this shard
    counts = torch.stack([rt.counts() for rt, _ in routes], -1)
    if isinstance(mesh, RankMesh):
        counts_in = _exchange(mesh, counts[0])             # (D_src, 3)
    else:
        counts_in = counts.transpose(0, 1)          # (D_dst, D_src, 3)
    rp, rd = (_deliver(mesh, r, cfg, shard_by) for r in routes[:2])
    v, f = _probe_routed(hm_stacked, rp)
    hm2, dfound = _delete_routed(hm_stacked, rd)
    # insert validity from the count exchange: slot j of a receive row
    # from source s holds a key iff j < its count (the routed prefix is
    # dense)
    ri = _deliver(mesh, routes[2], cfg, shard_by, iv)
    valid = (torch.arange(routes[2][0].c, device=dev)
             < counts_in[..., 2:3]).reshape(-1)
    hm3, iok = _insert_routed(hm2, ri, valid)
    return hm3, v, f, dfound, iok


def probe_replicated(mesh, hm, queries, cfg: HashMemConfig,
                     axis: str = "data"):
    """Throughput mode: the table replicated, queries sharded over
    ``axis`` (pure data parallelism -- the paper's multi-rank replication
    counterpoint).  On one card every replica is the one table, so this is
    one probe of the whole batch: one kernel launch.  On a RankMesh each
    rank probes its own block of queries against its replica (JAX's
    ``P(axis)`` out_specs): one launch a rank, no exchange."""
    del mesh, axis
    return hashmap.probe(hm, queries, backend=cfg.backend)
