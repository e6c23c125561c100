"""Continuous-batching request engine over HashMem shards.

The paper's throughput win is many bucket traversals in flight per device
call; this layer makes a *request stream* exploit that.  Requests (short
sessions of read/update/insert/delete/scan/rmw ops, typically YCSB-shaped —
see loadgen.py) occupy slots of a fixed pool; every engine **tick**

  1. admits pending requests into free slots (admission control: global
     pool occupancy, global queue bound, per-tenant slot/pending quotas);
  2. takes the next op from every active slot and **coalesces** the whole
     tick into fixed op phases — probe, then delete, then insert — executed
     by a pluggable shard backend:

       * host shards (default): ``num_shards`` independent HashMems; one
         ``hashmap`` call per phase per *touched* shard, keys partitioned
         on the host with ONE vectorized ``rlu.owner_of_np`` call per
         phase;
       * mesh shards (``mesh=``): one stacked HashMem of
         ``mesh.num_shards`` shards, ONE ``rlu.probe_sharded`` /
         ``rlu.delete_sharded`` / ``rlu.insert_mesh`` call per phase per
         tick no matter how many shards participate, or, by default, ONE
         ``rlu.tick_mesh`` call for the whole tick (``fused_tick``) — the
         paper's channel-level parallelism on the serving hot path.  Shard
         routing (hash-high-bits fastrange, rlu.py) happens INSIDE the RLU
         call, not in host dicts;

  3. scatters results back to the issuing requests, completes exhausted
     requests, frees their slots, and refills from the queue.

Phase order within a tick is fixed (probe -> delete -> insert), so

  * ``read`` observes the table as of the tick start;
  * ``update`` = tombstone-oldest + append (read-your-writes from the next
    tick on, exact semantics of the differential DictModel);
  * ``rmw`` reads the pre-tick value and writes in the same tick;
  * same-tick WRITE contention on one key is serialized by deferral: the
    first delete-phase op (delete/update/rmw) on a key claims it for the
    tick, later writers wait a tick — so a tick's delete batch never holds
    duplicate keys and the schedule is sequential-equivalent.

Multi-tick op pipelining (``pipeline_depth`` > 1)
-------------------------------------------------
With depth d, tick N+1's phases are ISSUED while up to d-1 earlier ticks'
results are still in flight: device calls chain functionally through the
shard tables (tick N+1's probe consumes the table returned by tick N's
insert), and the host materializes results — writebacks, hit counts,
tombstone accounting, and the insert-failure check — only when a tick is
*drained*.  The op->tick schedule is IDENTICAL to the unpipelined engine
(the gather rules don't change), so chained purity alone makes every
result equal to the unpipelined run — with ONE exception: an in-flight
insert may turn out to have been refused (PR_ERROR: arena/chain bound),
which is only discovered, and repaired through the grow path, when its
tick drains.  The **write-claim fence** guards exactly that window: every
in-flight tick holds a claim on its insert-phase keys (insert/update/rmw),
and a tick about to issue an op touching a claimed key first STALLS the
pipeline — drains all in-flight ticks, resolving any deferred growth —
then issues.  Ops on unclaimed keys never stall: a refused insert writes
nothing, so no other key's probe/delete can observe the difference, and
the drain-time re-insert commutes with everything issued in between.
Results and per-tick op counts are therefore exactly those of the
unpipelined schedule.  Growth and tick-clock compaction flush the
pipeline; ``stall_events`` counts fence stalls (hot-key write contention
degrades pipelining gracefully, it never breaks equivalence).

``coalesce=False`` runs the identical schedule but issues one HashMem call
per op — the per-request baseline the coalesced engine is measured
against.  Tenant ids are folded into the key space (tenancy.py),
so isolation is structural: no batched call can mix one tenant's writes
into another's keys.  Tenant stats are attributed exactly once per op at
gather time and once per probed key at writeback — ops routed to any shard
(including scans spanning shards) are never double-counted
(tests/test_tenancy.py pins this).

The PyTorch port of the JAX package's ``serving/engine.py``.  It differs in
form only:

  * the phases call ``repro_torch.core.hashmap.probe``, ``delete`` and
    ``insert`` directly on tables on the engine's device (``device=None``
    is the card; ``device="cpu"`` runs the plain PyTorch versions);
  * keys, values and pad masks cross to the card through pinned memory
    without a synchronise, and each phase's ``finalize`` makes ONE host copy
    of its outputs, at drain, never at issue: with ``pipeline_depth`` 2 the
    host gathers tick N+1 while the card still runs tick N;
  * ``profile_ticks`` opens a ``torch.profiler`` window, and a window that
    does not start is an error;
  * the mesh is one card (``launch/mesh.py``): its D shards are stacked
    there, and each routed probe phase is one kernel launch for all of
    them.
"""
from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap, rlu
from repro_torch.core.layout import resolve_device
from repro_torch.serving.metrics import MetricsCollector
from repro_torch.serving.tenancy import Tenant, TenantRegistry
from repro_torch.serving.tracing import NULL_TRACER, Tracer

# never generated by workloads (kv_synth keeps keys < 0xFFFFFFF0) and never
# inserted: probes/deletes padded with it report found=False and write
# nothing, so batches can be padded to power-of-two shapes (a bounded set
# of batch shapes) without perturbing the table.  Identical to the RLU
# routing pad.
PAD_KEY = rlu.ROUTE_PAD

OP_KINDS = ("read", "update", "insert", "delete", "scan", "rmw")

# ring bound for the two-pass routing telemetry log (exact totals live in
# ``route_cap_totals``; the log keeps the most recent launches for stats()
# without growing with run length)
ROUTE_CAP_LOG_MAX = 1024


@dataclass
class Request:
    """One client request: a short FIFO of ops executed one per tick.

    Ops are tuples: ("read", key) | ("update", key, val) |
    ("insert", key, val) | ("delete", key) | ("scan", start_key, n) |
    ("rmw", key, new_val).  Keys are RAW (tenant-relative); the engine
    folds the tenant id at issue time.
    """
    ops: list
    tenant: Optional[Tenant] = None
    rid: int = -1
    results: list = field(default_factory=list)
    submit_time: float = 0.0
    admit_tick: int = -1
    admit_time: float = 0.0
    cursor: int = 0
    killed: bool = False

    def done(self) -> bool:
        return self.cursor >= len(self.ops)


class SlotPool:
    """Slot lifecycle + pending queue (mechanics only; quota policy is a
    pluggable ``admit_ok`` predicate).  Shared by the KV engine and the
    decode loop in launch/serve.py."""

    def __init__(self, n_slots: int, max_pending: int = 0,
                 admit_ok: Optional[Callable] = None,
                 on_admit: Optional[Callable] = None):
        self.slots: list = [None] * n_slots
        self.pending: deque = deque()
        self.max_pending = max_pending
        self.admit_ok = admit_ok or (lambda item: True)
        # fires the moment an item lands in a slot — BEFORE the next
        # admit_ok check, so quota state stays exact within one refill batch
        self.on_admit = on_admit or (lambda slot, item: None)

    # -- queries -----------------------------------------------------------
    def occupancy(self) -> int:
        return sum(s is not None for s in self.slots)

    def active(self):
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    def idle(self) -> bool:
        return self.occupancy() == 0 and not self.pending

    # -- lifecycle ---------------------------------------------------------
    def submit(self, item) -> str:
        """Returns "admitted" | "queued" | "rejected"."""
        if self._place(item) >= 0:
            return "admitted"
        if self.max_pending and len(self.pending) >= self.max_pending:
            return "rejected"
        self.pending.append(item)
        return "queued"

    def _place(self, item) -> int:
        """Admit into a free slot if the quota allows; returns the slot
        index or -1.  The single admission path for submit AND refill."""
        if not self.admit_ok(item):
            return -1
        for i, s in enumerate(self.slots):
            if s is None:
                self.slots[i] = item
                self.on_admit(i, item)
                return i
        return -1

    def refill(self) -> list:
        """Admit from the queue into free slots (FIFO, skipping items whose
        quota check fails so one saturated tenant can't head-of-line-block
        the rest).  Returns the newly admitted [(slot, item)]."""
        admitted = []
        if not self.pending:
            return admitted
        blocked = []
        while self.pending and any(s is None for s in self.slots):
            item = self.pending.popleft()
            i = self._place(item)
            if i >= 0:
                admitted.append((i, item))
            else:
                blocked.append(item)     # quota-refused; a free slot existed
        self.pending.extendleft(reversed(blocked))   # keep FIFO order
        return admitted

    def release(self, slot: int):
        item = self.slots[slot]
        self.slots[slot] = None
        return item


def _pad_pow2(arr: np.ndarray, fill, min_n: int = 1) -> np.ndarray:
    """Pad to the next power of two, at least ``min_n``: bounds the set of
    batch shapes (ideally to ONE per op kind) and keeps the engine's
    batches equal to the JAX engine's, pads included."""
    n = len(arr)
    if n == 0:
        return arr
    m = max(min_n, 1)
    while m < n:
        m <<= 1
    if m == n:
        return arr
    return np.concatenate([arr, np.full(m - n, fill, arr.dtype)])


def _to_host(parts: list) -> list:
    """1-D device tensors -> numpy int64 arrays, in ONE host copy: the parts
    are concatenated on their device first."""
    flat = torch.cat([p.to(torch.int64) for p in parts]).cpu().numpy()
    return np.split(flat, np.cumsum([p.numel() for p in parts])[:-1])


# ---------------------------------------------------------------------------
# Host shards: where a coalesced phase actually executes
# ---------------------------------------------------------------------------

class _HostShards:
    """Shard backend: independent HashMems, one ``hashmap`` call per phase
    per touched shard.  Keys are partitioned with one vectorized
    ``rlu.owner_of_np`` call per phase (no per-op host hashing)."""

    is_mesh = False

    def __init__(self, eng: "ServingEngine", shards: list):
        self.eng = eng
        self.shards = shards
        self.num_shards = len(shards)

    @property
    def auto_grow(self) -> bool:
        return self.shards[0].config.auto_grow

    def owners(self, keys: np.ndarray) -> np.ndarray:
        return rlu.owner_of_np(keys, self.shards[0].config, self.num_shards,
                               self.eng.shard_by)

    # -- phases (return a zero-arg finalize; device work is issued NOW) ----
    def probe(self, keys: np.ndarray, pad: bool = True):
        owners = self.owners(keys)
        parts = []
        for s in np.unique(owners):
            idx = np.nonzero(owners == s)[0]
            q = self.eng._padded(keys[idx], PAD_KEY, pad)
            v, f = hashmap.probe(self.shards[s], self.eng._on_device(q))
            self.eng._record_call("probe")
            parts.append((idx, v, f))

        def finalize():
            vals = np.zeros(len(keys), np.uint32)
            found = np.zeros(len(keys), bool)
            host = _to_host([t[:len(idx)] for idx, v, f in parts
                             for t in (v, f)])
            for i, (idx, _, _) in enumerate(parts):
                vals[idx] = host[2 * i].astype(np.uint32)
                found[idx] = host[2 * i + 1] != 0
            return vals, found
        return finalize

    def delete(self, keys: np.ndarray, pad: bool = True):
        owners = self.owners(keys)
        parts = []
        for s in np.unique(owners):
            idx = np.nonzero(owners == s)[0]
            q = self.eng._padded(keys[idx], PAD_KEY, pad)
            self.shards[s], f = hashmap.delete(self.shards[s],
                                               self.eng._on_device(q))
            self.eng._record_call("delete")
            parts.append((int(s), idx, f))

        def finalize():
            found = np.zeros(len(keys), bool)
            tombs: dict = {}
            host = _to_host([f[:len(idx)] for _, idx, f in parts])
            for (s, idx, _), fs in zip(parts, host):
                found[idx] = fs != 0
                tombs[s] = tombs.get(s, 0) + int(fs.sum())
            return found, tombs
        return finalize

    def insert(self, keys: np.ndarray, vals: np.ndarray, pad: bool = True):
        """Fixed-arena attempt: ONE ``hashmap.insert`` per touched shard,
        padded with a valid mask (pads write nothing, claim no pages).
        PR_ERROR handling (growth) is deferred to the engine's drain."""
        owners = self.owners(keys)
        parts = []
        for s in np.unique(owners):
            idx = np.nonzero(owners == s)[0]
            n = len(idx)
            q = self.eng._padded(keys[idx], PAD_KEY, pad)
            v = self.eng._padded(vals[idx], np.uint32(0), pad)
            valid = np.zeros(len(q), bool)
            valid[:n] = True
            on = self.eng._on_device
            self.shards[s], ok = hashmap.insert(self.shards[s], on(q), on(v),
                                                on(valid))
            self.eng._record_call("insert")
            parts.append((idx, ok))

        def finalize():
            ok_all = np.zeros(len(keys), bool)
            host = _to_host([ok[:len(idx)] for idx, ok in parts])
            for (idx, _), oks in zip(parts, host):
                ok_all[idx] = oks != 0
            return ok_all
        return finalize

    @property
    def resize_mode(self) -> str:
        return self.shards[0].config.resize

    # -- slow paths --------------------------------------------------------
    def grow_insert(self, keys: np.ndarray, vals: np.ndarray):
        """Drain-time PR_ERROR fallback: host-level auto-grow insert of the
        refused elements.  Each host shard grows independently; returns
        (ok, [shard ids whose arena was REBUILT], events).  Rebuild
        detection is by num_pages — an extendible directory doubling
        changes num_buckets while every page (and tombstone) stays put, so
        it must NOT reset tombstone accounting or bump the rebuild epoch."""
        owners = self.owners(keys)
        ok_all = np.zeros(len(keys), bool)
        grown = []
        events: dict = {}
        for s in np.unique(owners):
            idx = np.nonzero(owners == s)[0]
            before = self.shards[s].config.num_pages
            self.shards[s], ok = hashmap.insert_auto(
                self.shards[s], keys[idx], vals[idx], events=events)
            ok_all[idx] = ok.cpu().numpy()
            if self.shards[s].config.num_pages != before:
                grown.append(int(s))
        return ok_all, grown, events

    def preload(self, keys: np.ndarray, vals: np.ndarray):
        """Bulk load; returns the shard ids whose arena was rebuilt so the
        engine can run the same grow bookkeeping as the drain path."""
        owners = self.owners(keys)
        grown = []
        for s in range(self.num_shards):
            m = owners == s
            if m.any():
                before = self.shards[s].config.num_pages
                self.shards[s], ok = hashmap.insert_auto(
                    self.shards[s], keys[m], vals[m])
                if not bool(ok.all()):
                    raise RuntimeError(f"preload overflowed shard {s}")
                if self.shards[s].config.num_pages != before:
                    grown.append(s)
        return grown

    def compact_shards(self, tombstones: list) -> list:
        out = []
        for s, hm in enumerate(self.shards):
            if hashmap.compact_due(hm, tombstones[s]):
                self.shards[s] = hashmap.compact(hm)
                out.append(s)
        return out

    def shard_list(self) -> list:
        return self.shards


class _MeshShards:
    """Mesh shard backend: ONE stacked HashMem of ``mesh.num_shards``
    shards on the engine's device, every coalesced phase ONE rlu call (and
    one kernel launch per probe phase).  Routing lives in the RLU layer
    (hash-high-bits fastrange); the host never partitions keys on the
    request path."""

    is_mesh = True

    def __init__(self, eng: "ServingEngine", mesh, axis: str,
                 cfg: HashMemConfig, tables: Optional[list] = None):
        from repro_torch.distributed.sharding import shard_stacked_hashmem
        self._place = lambda hm: shard_stacked_hashmem(mesh, hm, axis)
        self.eng = eng
        self.mesh = mesh
        self.axis = axis
        self.num_shards = mesh.shape[axis]
        self.cfg = cfg
        shards = list(tables) if tables is not None \
            else [hashmap.create(cfg, device=eng.device)
                  for _ in range(self.num_shards)]
        if len(shards) != self.num_shards:
            raise ValueError(f"{len(shards)} tables for a mesh of "
                             f"{self.num_shards} shards")
        self.hm_stacked = self._place(hashmap.stack(shards))

    @property
    def auto_grow(self) -> bool:
        return self.cfg.auto_grow

    def owners(self, keys: np.ndarray) -> np.ndarray:
        """Host mirror of the router -- used only for per-shard ACCOUNTING
        (tombstone attribution), never for request routing."""
        return rlu.owner_of_np(keys, self.cfg, self.num_shards,
                               self.eng.shard_by)

    def _tombstones(self, owners: np.ndarray, found: np.ndarray) -> dict:
        tombs: dict = {}
        for s in np.unique(owners[found]):
            tombs[int(s)] = int((owners[found] == s).sum())
        return tombs

    # -- phases ------------------------------------------------------------
    def probe(self, keys: np.ndarray, pad: bool = True):
        q = self.eng._padded(keys, PAD_KEY, pad)
        v, f = rlu.probe_sharded(self.mesh, self.hm_stacked,
                                 self.eng._on_device(q), self.cfg, self.axis,
                                 shard_by=self.eng.shard_by)
        self.eng._record_call("probe")

        def finalize():
            hv, hf = _to_host([v[:len(keys)], f[:len(keys)]])
            return hv.astype(np.uint32), hf != 0
        return finalize

    def tick_fused(self, pk, dk, ik, iv):
        """The whole tick's three phases in ONE rlu.tick_mesh call, routed
        at two-pass skew-aware capacities.  Empty phases ride along as
        (num_shards,) all-pad placeholders (their capacity is the quantum
        floor); returns one finalize per phase with the same contracts as
        probe/delete/insert, sharing ONE host copy at drain."""
        def prep(arr, fill):
            if len(arr) == 0:
                return np.full(self.num_shards, fill, np.uint32)
            return self.eng._padded(np.asarray(arr, np.uint32), fill)
        q_p, q_d, q_k = prep(pk, PAD_KEY), prep(dk, PAD_KEY), prep(ik, PAD_KEY)
        q_v = prep(iv, np.uint32(0)) if len(ik) else \
            np.zeros(self.num_shards, np.uint32)
        # pass 1 (host mirror of the count exchange): measured
        # per-(src,dst) maxima set the routing capacities for pass 2
        caps, meas = [], []
        with self.eng._phase_span("route", self.eng._cur_lane):
            for q in (q_p, q_d, q_k):
                caps.append(rlu.routing_cap(q, self.cfg, self.num_shards,
                                            self.eng.shard_by))
                meas.append(rlu.routing_cap(q, self.cfg, self.num_shards,
                                            self.eng.shard_by, quantum=1))
        on = self.eng._on_device
        self.hm_stacked, v, f, df, iok = rlu.tick_mesh(
            self.mesh, self.hm_stacked, on(q_p), on(q_d), on(q_k), on(q_v),
            self.cfg, self.axis, caps=tuple(caps),
            shard_by=self.eng.shard_by)
        self.eng._record_call("fused_tick")
        self.eng._record_route_caps(
            [len(q) // self.num_shards for q in (q_p, q_d, q_k)], caps, meas)
        owners_d = self.owners(dk) if len(dk) else np.zeros(0, np.int32)
        host: list = []

        def fetch():
            if not host:
                host.extend(_to_host([v[:len(pk)], f[:len(pk)],
                                      df[:len(dk)], iok[:len(ik)]]))
            return host

        def fin_probe():
            hv, hf = fetch()[:2]
            return hv.astype(np.uint32), hf != 0

        def fin_delete():
            found = fetch()[2] != 0
            return found, self._tombstones(owners_d, found)

        def fin_insert():
            return fetch()[3] != 0
        return fin_probe, fin_delete, fin_insert

    def delete(self, keys: np.ndarray, pad: bool = True):
        q = self.eng._padded(keys, PAD_KEY, pad)
        self.hm_stacked, f = rlu.delete_sharded(
            self.mesh, self.hm_stacked, self.eng._on_device(q), self.cfg,
            self.axis, shard_by=self.eng.shard_by)
        self.eng._record_call("delete")
        owners = self.owners(keys)

        def finalize():
            found = _to_host([f[:len(keys)]])[0] != 0
            return found, self._tombstones(owners, found)
        return finalize

    def insert(self, keys: np.ndarray, vals: np.ndarray, pad: bool = True):
        on = self.eng._on_device
        q = self.eng._padded(keys, PAD_KEY, pad)
        v = self.eng._padded(vals, np.uint32(0), pad)
        self.hm_stacked, ok = rlu.insert_mesh(
            self.mesh, self.hm_stacked, on(q), on(v), self.cfg, self.axis,
            shard_by=self.eng.shard_by)
        self.eng._record_call("insert")

        def finalize():
            return _to_host([ok[:len(keys)]])[0] != 0
        return finalize

    @property
    def resize_mode(self) -> str:
        return self.cfg.resize

    # -- slow paths --------------------------------------------------------
    def grow_insert(self, keys: np.ndarray, vals: np.ndarray):
        """Drain-time PR_ERROR fallback: the repair runs in
        rlu.insert_sharded -- extendible splits are per-shard local
        (shape-preserving) and directory doublings are synchronized pointer
        copies; only a full grow() REBUILD (detected by num_pages, which
        doubling preserves) rebuilds all shards and resets their tombstone
        epochs.  Returns (ok, [rebuilt shard ids] -- all or none here,
        events)."""
        before = self.cfg.num_pages
        events: dict = {}
        hm, ok, cfg2 = rlu.insert_sharded(
            self.hm_stacked, keys, vals, self.cfg, self.num_shards,
            shard_by=self.eng.shard_by, events=events)
        grew = cfg2.num_pages != before
        self.cfg = cfg2
        self.hm_stacked = self._place(hm)
        return (ok.cpu().numpy(),
                list(range(self.num_shards)) if grew else [], events)

    def preload(self, keys: np.ndarray, vals: np.ndarray):
        ok, grown, _ = self.grow_insert(keys, vals)
        if not ok.all():
            raise RuntimeError(f"preload overflowed: {int((~ok).sum())} "
                               f"pairs refused")
        return grown

    def compact_shards(self, tombstones: list) -> list:
        shards = self.shard_list()
        bfn = rlu._local_bucket_fn(self.num_shards, self.eng.shard_by)
        out = []
        for s, hm in enumerate(shards):
            if hashmap.compact_due(hm, tombstones[s]):
                shards[s] = hashmap.compact(hm, bucket_fn=bfn)
                out.append(s)
        if out:
            self.hm_stacked = self._place(hashmap.stack(shards))
        return out

    def shard_list(self) -> list:
        return hashmap.unstack(self.hm_stacked)


# ---------------------------------------------------------------------------
# In-flight tick bookkeeping (pipelining)
# ---------------------------------------------------------------------------

@dataclass
class _PhasePending:
    kind: str                 # "probe" | "delete" | "insert"
    entries: list
    finalize: Callable        # () -> phase result arrays, input order
    keys: np.ndarray
    vals: Optional[np.ndarray] = None


@dataclass
class _TickRecord:
    tick: int
    epochs: list              # per-shard grow/compact epochs at issue time
    phases: list              # [_PhasePending, ...]
    claims: set               # insert-phase keys (fence until drained)
    lane: int = 0             # trace track (tick % pipeline_depth)
    span: object = None       # open "tick" span token, closed at drain


class _PhaseTimer:
    """Context manager pairing one tracer span with one MetricsCollector
    ``record_phase`` sample (engine._phase_span)."""

    __slots__ = ("eng", "name", "lane", "args", "tok", "t0")

    def __init__(self, eng, name, lane, args):
        self.eng, self.name, self.lane, self.args = eng, name, lane, args

    def __enter__(self):
        tr = self.eng.tracer
        self.tok = tr.begin(self.name, self.lane, **self.args) \
            if tr.enabled else None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.eng.metrics.record_phase(self.name,
                                      time.perf_counter() - self.t0)
        self.eng.tracer.end(self.tok)
        return False


class ServingEngine:
    """Multi-tenant continuous-batching engine over HashMem shards.

    ``mesh=None`` (default): ``num_shards`` host-routed independent tables
    on ``device`` (None: the card; "cpu": the plain PyTorch versions).
    ``mesh=launch.mesh.make_serving_mesh(D)``: one stacked table of D
    shards on the mesh's device, which must be the engine's; every
    coalesced phase is ONE rlu call (``fused_tick``, the default on a
    coalesced mesh: ONE call a tick), and ``num_shards`` is the mesh's.
    Tables passed as ``tables`` must already be on the engine's device.
    Tables auto-grow (host shards independently; mesh shards synchronized)
    and are compacted by an engine-tick policy (tombstone fraction OR
    chain-length trigger, checked every ``compact_every`` ticks).

    ``pipeline_depth`` > 1 enables multi-tick op pipelining (module
    docstring): requires ``coalesce=True``.
    """

    def __init__(self, cfg: Optional[HashMemConfig] = None, *,
                 tables: Optional[list] = None, num_shards: int = 1,
                 max_slots: int = 16, max_pending: int = 0,
                 tenants: Optional[TenantRegistry] = None,
                 metrics: Optional[MetricsCollector] = None,
                 coalesce: bool = True, pad_pow2: bool = True,
                 compact_every: int = 64,
                 mesh=None, mesh_axis: str = "model",
                 shard_by: str = "highbits", pipeline_depth: int = 1,
                 record_schedule: bool = False,
                 fused_tick: Optional[bool] = None,
                 trace=None, device=None):
        assert shard_by in rlu.SHARD_ROUTERS, shard_by
        assert pipeline_depth >= 1
        assert pipeline_depth == 1 or coalesce, \
            "pipelining needs coalesced phases (coalesce=True)"
        # fused whole tick: the DEFAULT on a coalesced mesh (one
        # rlu.tick_mesh call a tick, two-pass skew-aware routing);
        # fused_tick=False keeps the three-call path
        if fused_tick is None:
            fused_tick = mesh is not None and coalesce
        if fused_tick and (mesh is None or not coalesce):
            raise ValueError("fused_tick needs a mesh backend and "
                             "coalesce=True")
        self.fused_tick = fused_tick
        self.device = resolve_device(device)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the mesh is on {mesh.device}, the engine on "
                             f"{self.device}")
        # observability: ``trace=True`` (or a Tracer instance) turns on
        # tick-level span recording (tracing.py); the default NULL_TRACER
        # keeps every call site a single enabled-flag check
        if isinstance(trace, Tracer):
            self.tracer = trace
        else:
            self.tracer = Tracer() if trace else NULL_TRACER
        self._profile_window = None    # (start_tick, stop_tick, logdir)
        self._profiling = False
        # the last window's torch.profiler.profile, and its host seconds
        # (ended by a synchronise on the card)
        self.profiler = None
        self.profile_seconds = 0.0
        self._profile_t0 = 0.0
        self.shard_by = shard_by
        self.coalesce = coalesce
        self.pad_pow2 = pad_pow2
        self.pipeline_depth = pipeline_depth
        # floor for padded batch shapes: 2*slots covers the common tick
        # (reads+updates for every slot) so most ticks have ONE shape
        self.pad_min = 1 << max(2 * max_slots - 1, 1).bit_length()
        self.compact_every = compact_every
        self.tenants = tenants or TenantRegistry()
        self.metrics = metrics or MetricsCollector()
        if cfg is None and tables is None:
            cfg = HashMemConfig(num_buckets=256, slots_per_page=64,
                                overflow_pages=256, max_chain=8,
                                backend="ref")
        # the insert fast path is the fixed-arena hashmap.insert — PR_ERROR
        # falls back to the host-level grow loop at drain time
        if tables is not None:
            for i, hm in enumerate(tables):
                if hm.device != self.device:
                    raise ValueError(f"table {i} is on {hm.device}, the "
                                     f"engine on {self.device}")
        if mesh is not None:
            base = tables[0].config if tables else cfg
            self.backend = _MeshShards(self, mesh, mesh_axis, base, tables)
        else:
            shards = list(tables) if tables is not None else \
                [hashmap.create(cfg, device=self.device)
                 for _ in range(num_shards)]
            self.backend = _HostShards(self, shards)
        self.num_shards = self.backend.num_shards
        # mesh phases must split evenly into the shards' source blocks
        self._pad_multiple = self.num_shards if mesh is not None else 1
        self.pool = SlotPool(max_slots, max_pending, admit_ok=self._quota_ok,
                             on_admit=self._on_admit)
        self.ticks = 0
        self._rid = 0
        self._active_by_tenant: dict[int, int] = {}
        self._pending_by_tenant: dict[int, int] = {}
        # engine-level HashMem API calls, cumulative and per-tick (the
        # coalescing tests assert calls_last_tick[kind] <= num_shards on
        # host shards and == 1 on a mesh; "fused_tick" counts whole-tick
        # calls -- a fused tick is ONE call for all phases)
        self.batch_calls = {"probe": 0, "delete": 0, "insert": 0,
                            "fused_tick": 0}
        self.calls_last_tick = dict(self.batch_calls)
        # two-pass routing telemetry: one record per fused call -- per-phase
        # (q_local, cap, measured max), which shows the routed capacity
        # tracking skew instead of the Q_local worst case.  The log is a
        # bounded ring; exact lifetime sums live in the totals.
        self.route_cap_log: deque = deque(maxlen=ROUTE_CAP_LOG_MAX)
        self.route_cap_totals = {"launches": 0, "cap_sum": 0,
                                 "q_local_sum": 0, "measured_sum": 0}
        self._tombstones = [0] * self.num_shards
        self.grow_events = 0
        # extendible-resize telemetry: group splits and directory doublings
        # repaired inline at drain time (no pipeline flush; see grow-smoke)
        self.split_events = 0
        self.directory_doublings = 0
        self.compact_events = 0
        self.killed_requests = 0
        self.stall_events = 0
        # per-shard rebuild epoch: bumped by grow/compact of THAT shard so
        # drain-time tombstone accounting from before the rebuild is dropped
        # for it alone (other shards' counters keep accumulating)
        self._shard_epochs = [0] * self.num_shards
        self._inflight: list[_TickRecord] = []
        self._cur_lane = 0             # trace track of the tick being built
        # probe keys of the most recent tick that had any — reused by the
        # throttled rows-activated telemetry sample (metrics.py)
        self._last_probe_keys: Optional[np.ndarray] = None
        # optional executed-op log for the differential harness: entries
        # (tick, kind, folded_keys tuple, val|None, res dict) in gather
        # order — with the fixed phase order this is enough to replay the
        # exact schedule against the DictModel (tests/model.py)
        self.record_schedule = record_schedule
        self.schedule: list = []

    # -- back-compat views -------------------------------------------------
    @property
    def shards(self) -> list:
        """Per-shard HashMems (host: the live list; mesh: views of the
        stacked table's shards)."""
        return self.backend.shard_list()

    # -- admission ---------------------------------------------------------
    def _quota_ok(self, req: Request) -> bool:
        t = req.tenant
        if t is None or not t.max_slots:
            return True
        return self._active_by_tenant.get(t.tid, 0) < t.max_slots

    def _validate_ops(self, req: Request):
        """Reject keys that collide with the reserved pad/sentinel range
        BEFORE admission (a real exception, not an assert — it must survive
        ``python -O``).  A stored key equal to ROUTE_PAD (0xFFFFFFF0) would
        silently become routing padding: never stored, probes always miss —
        so the engine/tenancy boundary is where the key domain is closed.
        Raw (untenanted) keys must stay below PAD_KEY; tenant keys must fit
        the tenant key space (folding then keeps them below PAD_KEY because
        the all-ones tenant id is unregistrable)."""
        bound = int(self.tenants.space.key_space) if req.tenant is not None \
            else int(PAD_KEY)
        for op in req.ops:
            kind = op[0]
            if kind not in OP_KINDS:
                raise ValueError(f"unknown op kind {kind!r}")
            lo = int(op[1])
            hi = lo + int(op[2]) - 1 if kind == "scan" else lo
            if lo < 0 or hi >= bound:
                raise ValueError(
                    f"op {kind!r} key {hi:#x} outside the usable key domain "
                    f"[0, {bound:#x}) — keys at or above "
                    f"{int(PAD_KEY):#x} are reserved for routing padding "
                    f"and the EMPTY/TOMBSTONE sentinels")

    def submit(self, req: Request) -> str:
        """Admission control: place in a free slot, else queue, else reject.
        Rejection happens when the global queue is full OR the tenant's own
        pending quota is exhausted.  Raises ValueError on keys colliding
        with the reserved pad/sentinel range."""
        self._validate_ops(req)
        req.rid, self._rid = self._rid, self._rid + 1
        req.submit_time = time.perf_counter()
        tr = self.tracer
        if tr.enabled:
            # request lifecycle slices: "request" wraps "queue" (submit ->
            # admit) then "service" (admit -> complete/kill), keyed by rid
            tr.async_begin("request", req.rid, ops=len(req.ops))
            tr.async_begin("queue", req.rid)
        t = req.tenant
        if t is not None:
            t.stats["submitted"] += 1
            if t.max_pending and \
                    self._pending_by_tenant.get(t.tid, 0) >= t.max_pending \
                    and not (self._quota_ok(req)
                             and any(s is None for s in self.pool.slots)):
                t.stats["rejected"] += 1
                self._trace_close_request(req, "rejected")
                return "rejected"
        status = self.pool.submit(req)
        if status == "queued":
            req._queued = True
            if t is not None:
                t.stats["queued"] += 1
                self._pending_by_tenant[t.tid] = \
                    self._pending_by_tenant.get(t.tid, 0) + 1
        elif status == "rejected":
            if t is not None:
                t.stats["rejected"] += 1
            self._trace_close_request(req, "rejected")
        return status

    def _trace_close_request(self, req: Request, status: str):
        """Balance the request's open async slices at a terminal event
        (reject or kill) so the exported trace never holds a dangling
        begin.  Completion closes them inline in ``tick()``."""
        tr = self.tracer
        if not tr.enabled:
            return
        if req.admit_tick >= 0:
            tr.async_end("service", req.rid, status=status)
        else:
            tr.async_end("queue", req.rid, status=status)
        tr.async_end("request", req.rid, status=status)

    def submit_all(self, reqs: Iterable[Request]) -> dict:
        out = {"admitted": 0, "queued": 0, "rejected": 0}
        for r in reqs:
            out[self.submit(r)] += 1
        return out

    def _on_admit(self, slot: int, req: Request):
        """SlotPool admission callback — runs the moment a slot is taken, so
        quota state is exact even within one refill batch."""
        req.admit_tick = self.ticks
        req.admit_time = time.perf_counter()
        if self.tracer.enabled:
            self.tracer.async_end("queue", req.rid)
            self.tracer.async_begin("service", req.rid, slot=slot,
                                    tick=self.ticks)
        t = req.tenant
        if getattr(req, "_queued", False):
            req._queued = False
            if t is not None:
                self._pending_by_tenant[t.tid] = \
                    max(self._pending_by_tenant.get(t.tid, 0) - 1, 0)
        if t is not None:
            t.stats["admitted"] += 1
            self._active_by_tenant[t.tid] = \
                self._active_by_tenant.get(t.tid, 0) + 1

    def _refill(self):
        self.pool.refill()

    def kill(self, req: Request) -> bool:
        """Abort a request mid-flight (client disconnect / failure
        injection): remaining ops are dropped, the slot (or queue entry) is
        reclaimed immediately.  Ops already issued in still-in-flight ticks
        complete on-device — their write claims stay fenced until drained —
        and their results land in ``req.results`` harmlessly."""
        t = req.tenant
        for slot, r in self.pool.active():
            if r is req:
                req.killed = True
                self.pool.release(slot)
                if t is not None:
                    t.stats["killed"] += 1
                    self._active_by_tenant[t.tid] = \
                        max(self._active_by_tenant.get(t.tid, 0) - 1, 0)
                self.killed_requests += 1
                self.tracer.instant("kill", tid=self._cur_lane, rid=req.rid)
                self._trace_close_request(req, "killed")
                return True
        for i, r in enumerate(self.pool.pending):
            if r is req:              # identity — Request.__eq__ is by value
                req.killed = True
                del self.pool.pending[i]
                if t is not None:
                    t.stats["killed"] += 1
                    self._pending_by_tenant[t.tid] = \
                        max(self._pending_by_tenant.get(t.tid, 0) - 1, 0)
                self.killed_requests += 1
                self.tracer.instant("kill", tid=self._cur_lane, rid=req.rid)
                self._trace_close_request(req, "killed")
                return True
        return False                  # already completed/released: no-op

    # -- key handling ------------------------------------------------------
    def _fold(self, req: Request, key: int) -> int:
        """Scalar tenant fold for the per-op gather hot loop (the vectorized
        TenantSpace.fold would build a throwaway array per key).  Tenant ids
        are range-checked at registration; the key range is checked here."""
        if req.tenant is None:
            key = int(key)
            # PAD_KEY/ROUTE_PAD and the sentinels live above this floor; a
            # stored key up there would break the padding/routing no-op
            # invariant (kv_synth keeps workload keys below it too)
            assert 0 <= key < int(PAD_KEY), \
                f"key {key:#x} collides with the pad/sentinel range"
            return key
        sp = self.tenants.space
        key = int(key)
        assert 0 <= key < sp.key_space, \
            f"tenant key {key} must fit {sp.key_bits} bits"
        return (req.tenant.tid << sp.key_bits) | key

    def _padded(self, arr: np.ndarray, fill, pow2: bool = True) -> np.ndarray:
        """Batch padding: pow2 floor (bounds the set of batch shapes) and,
        on a mesh, round up to a multiple of num_shards (the routed batch
        splits into equal source blocks)."""
        q = _pad_pow2(arr, fill, self.pad_min) \
            if (pow2 and self.pad_pow2) else arr
        m = self._pad_multiple
        if m > 1 and len(q) % m:
            q = np.concatenate([q, np.full(m - len(q) % m, fill, arr.dtype)])
        return q

    def _on_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host batch (uint32 keys/values as int32 bits, or a bool mask)
        as a tensor on the engine's device.  To the card it goes through
        pinned memory with ``non_blocking``, so the issue path never
        waits for the card."""
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _record_call(self, kind: str):
        self.batch_calls[kind] += 1
        self.calls_last_tick[kind] += 1

    def _phase_span(self, name: str, lane: int, **args):
        """Span + per-phase metrics in one context manager: the tracer gets
        a duration span on ``lane`` and MetricsCollector a ``phase_ms``
        sample, so the snapshot's per-phase latency blocks exist even when
        tracing is off."""
        return _PhaseTimer(self, name, lane, args)

    def _record_route_caps(self, q_locals, caps, measured):
        self.route_cap_log.append({
            "tick": self.ticks,
            "q_local": list(q_locals),     # worst-case (unfused) capacity
            "cap": list(caps),             # two-pass routed capacity
            "max": list(measured),         # exact measured per-(src,dst) max
        })
        tot = self.route_cap_totals
        tot["launches"] += 1
        tot["cap_sum"] += int(sum(caps))
        tot["q_local_sum"] += int(sum(q_locals))
        tot["measured_sum"] += int(sum(measured))
        tr = self.tracer
        if tr.enabled:
            ql = sum(q_locals)
            tr.counter("route_cap_fill", sum(caps) / ql if ql else 1.0)
            # routed element volume of this call: each phase's receive
            # buffer holds D * D * cap entries
            tr.counter("routed_elems",
                       self.num_shards ** 2 * int(sum(caps)))

    # -- the tick ----------------------------------------------------------
    def tick(self) -> int:
        """One engine step.  Returns the number of ops issued.

        Trace shape: the tick's lane (``tick % pipeline_depth``) is its
        trace track, so with depth>=2 consecutive tick spans land on
        DIFFERENT tracks and render overlapped — the issue->drain span of
        tick N is still open on lane N%d while tick N+1 runs on the next
        lane, and a write-claim stall shows as a ``pipeline_stall`` span
        nested in the stalling tick.  The span is *begun* here and *ended*
        by ``_drain_one`` (depth=1 drains within this call)."""
        t0 = time.perf_counter()
        tr = self.tracer
        lane = self.ticks % self.pipeline_depth
        self._cur_lane = lane
        pw = self._profile_window
        if pw is not None and not self._profiling and self.ticks >= pw[0]:
            self._start_profiler()
        tick_tok = tr.begin("tick", lane, tick=self.ticks)
        self._refill()
        self.calls_last_tick = {"probe": 0, "delete": 0, "insert": 0,
                                "fused_tick": 0}

        with self._phase_span("gather", lane):
            probes, deletes, inserts, claims, conflict, n_ops = \
                self._gather()
        if conflict and self._inflight:
            # write-claim fence: an op touches a key whose in-flight insert
            # could still be refused — stall (drain, resolving any deferred
            # growth) before issuing, so the op observes the repaired table
            self.stall_events += 1
            tr.instant("write_fence", tid=lane,
                       inflight=len(self._inflight))
            with self._phase_span("pipeline_stall", lane):
                self.flush()
        if probes:
            self._last_probe_keys = np.asarray([k for k, _ in probes],
                                               np.uint32)
        rec = self._issue(probes, deletes, inserts, claims)
        rec.lane = lane
        rec.span = tick_tok
        self._inflight.append(rec)
        # drain down to the pipeline window: depth=1 materializes THIS tick
        # before completion (the unpipelined behavior); depth=d keeps
        # d-1 ticks in flight
        while len(self._inflight) > self.pipeline_depth - 1:
            self._drain_one()

        # completion + slot recycling (cursor-driven: a request can complete
        # while its last results are still in flight)
        with self._phase_span("admit", lane):
            for slot, req in self.pool.active():
                if req.done():
                    self.pool.release(slot)
                    t = req.tenant
                    now = time.perf_counter()
                    queue_s = max(req.admit_time - req.submit_time, 0.0)
                    service_s = max(now - req.admit_time, 0.0)
                    if t is not None:
                        t.stats["completed"] += 1
                        t.stats["queue_secs"] += queue_s
                        t.stats["service_secs"] += service_s
                        self._active_by_tenant[t.tid] = \
                            max(self._active_by_tenant.get(t.tid, 0) - 1, 0)
                    if tr.enabled:
                        tr.async_end("service", req.rid)
                        tr.async_end("request", req.rid, status="ok")
                    self.metrics.record_request(
                        self.ticks - req.admit_tick + 1,
                        now - req.submit_time,
                        queue_secs=queue_s, service_secs=service_s)
            self._refill()

        self.ticks += 1
        self.metrics.record_tick(n_ops, self.pool.occupancy(),
                                 time.perf_counter() - t0)
        if tr.enabled:
            tr.counter("occupancy", self.pool.occupancy())
            tr.counter("tick_ops", n_ops)
        # throttled telemetry: the "sample" span token is simply dropped on
        # un-sampled ticks (begin() allocates no ring entry until end())
        sample_tok = tr.begin("sample", lane)
        if self.metrics.sample_chains(self.backend.shard_list) \
                and self._last_probe_keys is not None:
            rows = self._rows_activated(self._last_probe_keys)
            self.metrics.record_rows_activated(rows)
            tr.counter("rows_activated", rows)
            tr.end(sample_tok)
        if self.ticks % self.compact_every == 0:
            self.maybe_compact()
        if self._profiling and self.ticks >= self._profile_window[1]:
            self._stop_profiler()
        return n_ops

    def _gather(self):
        """One op per active slot, expanded into three global phase buffers
        (probe/delete/insert) — UNROUTED: shard partitioning happens inside
        the backend.  Entry shapes: probe/delete (key, writeback); insert
        (key, val, writeback).

        The gather rules are IDENTICAL with pipelining on or off (that's
        what makes pipelined results bit-equal): a batched delete
        tombstones only the FIRST chain match per key, so the first
        delete-phase op (delete/update/rmw) on a folded key claims it for
        the tick and later writers wait a tick.  The only pipelining
        byproduct is the ``conflict`` flag: True when any op touches an
        insert-phase key of a still-in-flight tick (the caller stalls the
        pipeline before issuing — module docstring).
        """
        probes: list = []
        deletes: list = []
        inserts: list = []
        fence: set = set()
        for r in self._inflight:
            fence |= r.claims
        conflict = False
        claimed: set = set()
        claims: set = set()
        hot: list = []
        n_ops = 0
        for _, req in self.pool.active():
            if req.done() or req.killed:
                continue
            op = req.ops[req.cursor]
            kind = op[0]
            if kind == "scan":
                touched = [self._fold(req, int(op[1]) + i)
                           for i in range(int(op[2]))]
            else:
                touched = [self._fold(req, op[1])]
            if fence and any(k in fence for k in touched):
                conflict = True
            if kind in ("delete", "update", "rmw"):
                if touched[0] in claimed:
                    # same-tick write contention: deferred to the next tick
                    self.tracer.instant("deferred_write",
                                        tid=self._cur_lane,
                                        key=touched[0], kind=kind)
                    continue
                claimed.add(touched[0])
            req.cursor += 1
            n_ops += 1
            hot.extend(touched)
            res = {"op": kind, "key": int(op[1])}
            req.results.append(res)
            if req.tenant is not None:
                req.tenant.stats["ops"][kind] += 1
            if self.record_schedule:
                self.schedule.append(
                    (self.ticks, kind, tuple(touched),
                     int(op[2]) if kind in ("insert", "update", "rmw")
                     else None, res))

            def wb(field, res=res):
                def set_(v):
                    res[field] = v
                return set_

            k = touched[0]
            if kind == "read":
                probes.append((k, self._wb_read(res, req)))
            elif kind == "scan":
                n = int(op[2])
                res.update(n=n, values=[0] * n, found=[False] * n)
                for i, ki in enumerate(touched):
                    probes.append((ki, self._wb_scan(res, req, i)))
            elif kind == "delete":
                deletes.append((k, wb("found")))
            elif kind == "insert":
                inserts.append((k, int(op[2]), wb("ok")))
                claims.add(k)
            elif kind == "update":
                deletes.append((k, wb("replaced")))
                inserts.append((k, int(op[2]), wb("ok")))
                claims.add(k)
            elif kind == "rmw":
                probes.append((k, self._wb_read(res, req, field="old")))
                deletes.append((k, wb("replaced")))
                inserts.append((k, int(op[2]), wb("ok")))
                claims.add(k)
            else:
                raise ValueError(f"unknown op kind {kind!r}")
        if hot:
            self.metrics.record_hot_keys(hot)
        return probes, deletes, inserts, claims, conflict, n_ops

    def _issue(self, probes, deletes, inserts, claims) -> _TickRecord:
        """Issue the tick's phases in fixed order (probe -> delete ->
        insert).  Device calls are dispatched now; host materialization
        waits for drain.  On a fused-tick mesh engine all three phases go
        out in ONE rlu.tick_mesh call."""
        phases = []
        if self.fused_tick and (probes or deletes or inserts):
            pk = np.asarray([k for k, _ in probes], np.uint32)
            dk = np.asarray([k for k, _ in deletes], np.uint32)
            ik = np.asarray([k for k, _, _ in inserts], np.uint32)
            iv = np.asarray([v for _, v, _ in inserts], np.uint32)
            with self._phase_span("fused_tick", self._cur_lane,
                                  probes=len(pk), deletes=len(dk),
                                  inserts=len(ik)):
                fp, fd, fi = self.backend.tick_fused(pk, dk, ik, iv)
            if probes:
                phases.append(_PhasePending("probe", probes, fp, pk))
            if deletes:
                phases.append(_PhasePending("delete", deletes, fd, dk))
            if inserts:
                phases.append(_PhasePending("insert", inserts, fi, ik, iv))
            return _TickRecord(self.ticks, list(self._shard_epochs), phases,
                               claims)
        if probes:
            phases.append(self._issue_phase("probe", probes))
        if deletes:
            phases.append(self._issue_phase("delete", deletes))
        if inserts:
            phases.append(self._issue_phase("insert", inserts))
        return _TickRecord(self.ticks, list(self._shard_epochs), phases,
                           claims)

    def _issue_phase(self, kind: str, entries: list) -> _PhasePending:
        with self._phase_span(kind, self._cur_lane, n=len(entries)):
            return self._issue_phase_inner(kind, entries)

    def _issue_phase_inner(self, kind: str, entries: list) -> _PhasePending:
        if kind == "insert":
            keys = np.asarray([k for k, _, _ in entries], np.uint32)
            vals = np.asarray([v for _, v, _ in entries], np.uint32)
        else:
            keys = np.asarray([k for k, _ in entries], np.uint32)
            vals = None
        if self.coalesce:
            if kind == "insert":
                fin = self.backend.insert(keys, vals)
            else:
                fin = getattr(self.backend, kind)(keys)
        else:
            # per-request baseline: one (unpadded) call per op
            fins = []
            for i in range(len(keys)):
                if kind == "insert":
                    fins.append(self.backend.insert(keys[i:i + 1],
                                                    vals[i:i + 1], pad=False))
                else:
                    fins.append(getattr(self.backend, kind)(keys[i:i + 1],
                                                            pad=False))
            fin = self._merge_finalizes(kind, fins)
        return _PhasePending(kind, entries, fin, keys, vals)

    @staticmethod
    def _merge_finalizes(kind: str, fins: list):
        def finalize():
            outs = [f() for f in fins]
            if kind == "probe":
                return (np.concatenate([o[0] for o in outs]),
                        np.concatenate([o[1] for o in outs]))
            if kind == "delete":
                found = np.concatenate([o[0] for o in outs])
                tombs: dict = {}
                for _, t in outs:
                    for s, c in t.items():
                        tombs[s] = tombs.get(s, 0) + c
                return found, tombs
            return np.concatenate(outs)
        return finalize

    def _drain_one(self):
        """Materialize the oldest in-flight tick: run writebacks, account
        hits/tombstones, and resolve deferred insert PR_ERRORs through the
        grow path.  Releases the tick's write claims."""
        rec = self._inflight.pop(0)
        with self._phase_span("writeback", rec.lane, tick=rec.tick):
            self._drain_phases(rec)
        self.tracer.end(rec.span)       # the tick's issue->drain span

    def _drain_phases(self, rec: _TickRecord):
        for ph in rec.phases:
            if ph.kind == "probe":
                vals, found = ph.finalize()
                hits = 0
                for i, (_, fwb) in enumerate(ph.entries):
                    fwb((vals[i], found[i]))
                    hits += int(found[i])
                self.metrics.record_ops("read", len(ph.entries), hits)
            elif ph.kind == "delete":
                found, tombs = ph.finalize()
                for i, (_, fwb) in enumerate(ph.entries):
                    fwb(bool(found[i]))
                for s, c in tombs.items():
                    # a rebuild of THAT shard since issue reclaimed these
                    if rec.epochs[s] == self._shard_epochs[s]:
                        self._tombstones[s] += c
                self.metrics.record_ops("delete", len(ph.entries))
            else:
                ok = np.array(ph.finalize())     # writable copy (grow repair)
                failed = np.nonzero(~ok)[0]
                if failed.size and self.backend.auto_grow:
                    # extendible repair is a per-shard LOCAL mutation ordered
                    # like this tick's own insert-phase writes (the fence
                    # already claims every key it can move), so it runs
                    # inline WITHOUT flushing the pipeline — hence its own
                    # span name, which grow-smoke forbids being "grow"
                    span = "split" if self.backend.resize_mode == \
                        "extendible" else "grow"
                    with self._phase_span(span, rec.lane,
                                          refused=int(failed.size)):
                        ok2, grown, events = self.backend.grow_insert(
                            ph.keys[failed], ph.vals[failed])
                    ok[failed] = ok2
                    self.split_events += events.get("splits", 0)
                    self.directory_doublings += events.get("doublings", 0)
                    if grown:
                        self.grow_events += 1
                        for s in grown:          # rebuilds drop tombstones
                            self._tombstones[s] = 0
                            self._shard_epochs[s] += 1
                for i, (_, _, fwb) in enumerate(ph.entries):
                    fwb(bool(ok[i]))
                self.metrics.record_ops("insert", len(ph.entries))

    def flush(self):
        """Drain every in-flight tick (pipeline barrier)."""
        while self._inflight:
            self._drain_one()

    def run(self, max_ticks: int = 100_000) -> dict:
        """Tick until all submitted work drains; returns a metrics snapshot."""
        while not self.pool.idle() and self.ticks < max_ticks:
            self.tick()
        self.flush()
        # short runs can finish inside one sample window: force a final
        # chain/rows-activated sample so the snapshot is never empty
        if not self.metrics.chain_samples:
            self.metrics.force_chain_sample(self.backend.shard_list)
        if self.metrics.rows_h.count == 0 \
                and self._last_probe_keys is not None:
            self.metrics.record_rows_activated(
                self._rows_activated(self._last_probe_keys))
        return self.metrics.snapshot()

    def _rows_activated(self, keys) -> float:
        """Mean DRAM-row activations per probe for ``keys`` against the
        live table(s): ``hashmap.rows_activated_per_probe`` per owning
        shard with the SAME bucket routing as the serving probe path (host
        shards hash the full key locally; the mesh path probes the rlu
        local bucket), weighted by per-shard key count."""
        keys = np.asarray(keys, np.uint32)
        if not keys.size:
            return 0.0
        shards = self.backend.shard_list()
        cfg = shards[0].config
        owner = rlu.owner_of_np(keys, cfg, self.num_shards, self.shard_by)
        total, n = 0.0, 0
        for s in range(self.num_shards):
            mine = keys[owner == s]
            if not mine.size:
                continue
            b = None
            if self.backend.is_mesh:
                _, b = rlu.owner_and_local_bucket(
                    self._on_device(mine), cfg, self.num_shards,
                    self.shard_by)
            total += float(hashmap.rows_activated_per_probe(
                shards[s], self._on_device(mine), b=b)) * int(mine.size)
            n += int(mine.size)
        return total / n if n else 0.0

    # -- writeback closures ------------------------------------------------
    def _wb_read(self, res: dict, req: Request, field: str = "value"):
        def set_(vf):
            v, f = vf
            res[field] = int(v)
            res["found"] = bool(f)
            if req.tenant is not None:
                req.tenant.stats["hits" if f else "misses"] += 1
        return set_

    def _wb_scan(self, res: dict, req: Request, i: int):
        def set_(vf):
            v, f = vf
            res["values"][i] = int(v)
            res["found"][i] = bool(f)
            if req.tenant is not None:
                req.tenant.stats["hits" if f else "misses"] += 1
        return set_

    # -- maintenance -------------------------------------------------------
    def maybe_compact(self):
        """Engine-tick compaction: tombstone-fraction OR chain-length
        trigger per shard.  Runs on the tick clock, so long-running skewed
        tenants get compacted even when no request ever frees/deletes again
        after piling up tombstones.  Flushes the pipeline first (a rebuild
        invalidates in-flight tombstone accounting)."""
        self.flush()
        with self._phase_span("compact", self._cur_lane):
            compacted = self.backend.compact_shards(self._tombstones)
        for s in compacted:
            self._tombstones[s] = 0
            self._shard_epochs[s] += 1
            self.compact_events += 1

    # -- profiler window ---------------------------------------------------
    def profile_ticks(self, start_tick: int, stop_tick: int, logdir: str):
        """Arm a ``torch.profiler`` window (CPU activity, and CUDA on the
        card): it starts when the engine reaches ``start_tick`` and stops
        once ``stop_tick`` ticks have completed, after a synchronise on the
        card, so the window holds its ticks' device work.  The trace is
        written to ``logdir`` as Chrome trace-event JSON, the profile stays
        in ``self.profiler`` and the window's host seconds in
        ``self.profile_seconds``.  The host-side Tracer marks both edges
        with ``profiler_start``/``profiler_stop`` instants.  A window that
        fails to start or stop raises."""
        assert stop_tick > start_tick >= 0
        self._profile_window = (start_tick, stop_tick, logdir)

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile
        self._profiling = True
        logdir = self._profile_window[2]
        self.tracer.instant("profiler_start", tid=self._cur_lane,
                            tick=self.ticks, logdir=logdir)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.profiler = profile(activities=acts)
        self.profiler.start()
        self._profile_t0 = time.perf_counter()

    def _stop_profiler(self):
        start, stop, logdir = self._profile_window
        self._profiling = False
        self._profile_window = None
        self.tracer.instant("profiler_stop", tid=self._cur_lane,
                            tick=self.ticks)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.profile_seconds = time.perf_counter() - self._profile_t0
        self.profiler.stop()
        os.makedirs(logdir, exist_ok=True)
        self.profiler.export_chrome_trace(
            os.path.join(logdir, f"ticks_{start}_{stop}.json"))

    # -- introspection -----------------------------------------------------
    def export_trace(self, path: str, **metadata) -> int:
        """Write the tracer's ring as Chrome trace-event JSON (annotated
        with the engine shape); returns the event count."""
        return self.tracer.export(path, ticks=self.ticks,
                                  pipeline_depth=self.pipeline_depth,
                                  num_shards=self.num_shards,
                                  fused_tick=self.fused_tick,
                                  stalls=self.stall_events, **metadata)

    def preload(self, keys, vals, tenant: Optional[Tenant] = None):
        """Bulk-load the table(s) outside the request path (YCSB load
        phase).  Growth during the load runs the same bookkeeping as the
        drain path (tombstone reset + rebuild epoch + grow_events).  The
        load goes through ``hashmap.insert_auto`` and waits for the
        device."""
        keys = np.asarray(keys, np.uint32)
        vals = np.asarray(vals, np.uint32)
        if tenant is not None:
            keys = self.tenants.fold(tenant.tid, keys)
        elif keys.size and int(keys.max()) >= int(PAD_KEY):
            raise ValueError(
                f"preload key {int(keys.max()):#x} collides with the "
                f"reserved pad/sentinel range [{int(PAD_KEY):#x}, "
                f"0xffffffff]")
        self.flush()
        with self._phase_span("preload", self._cur_lane, n=len(keys)):
            grown = self.backend.preload(keys, vals)
        if grown:
            self.grow_events += 1
            for s in grown:
                self._tombstones[s] = 0
                self._shard_epochs[s] += 1

    def stats(self) -> dict:
        return {
            "ticks": self.ticks,
            "batch_calls": dict(self.batch_calls),
            "grow_events": self.grow_events,
            "split_events": self.split_events,
            "directory_doublings": self.directory_doublings,
            "resize": self.backend.resize_mode,
            "compact_events": self.compact_events,
            "killed_requests": self.killed_requests,
            "occupancy": self.pool.occupancy(),
            "pending": len(self.pool.pending),
            "pipeline": {"depth": self.pipeline_depth,
                         "inflight": len(self._inflight),
                         "stalls": self.stall_events},
            "mesh_backed": self.backend.is_mesh,
            "fused_tick": self.fused_tick,
            "route_caps": list(self.route_cap_log)[-8:],
            "route_cap_totals": dict(self.route_cap_totals),
            "trace": {"enabled": self.tracer.enabled,
                      "recorded": self.tracer._recorded,
                      "dropped": self.tracer.dropped},
            "chain_depth": {
                "p50": self.metrics.chain_samples[-1]["chain_p50"]
                if self.metrics.chain_samples else 0.0,
                "p99": self.metrics.chain_samples[-1]["chain_p99"]
                if self.metrics.chain_samples else 0.0,
            },
            "rows_activated": {
                "p50": self.metrics.rows_h.percentile(50),
                "p99": self.metrics.rows_h.percentile(99),
            },
            "tenants": self.tenants.stats(),
            "shards": [
                {k: v for k, v in hashmap.stats(hm).items()
                 if k != "chain_lengths"}
                for hm in self.backend.shard_list()],
        }
