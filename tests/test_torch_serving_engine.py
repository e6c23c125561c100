"""The port's serving engine on host shards, on its own (no JAX): the
host-shard cases of ``tests/test_serving_engine.py`` against ``DictModel``,
the engine-facing cases of ``tests/test_tenancy.py``,
``tests/test_tracing.py`` (with ``tools/trace_report.py`` on a port trace)
and ``tests/test_metrics.py``, the ``kv`` serve CLI, the multi-tenant
example, and the port's own changes of form: one host copy per phase at
drain, tables on the engine's device, the ``torch.profiler`` window that
raises instead of failing quietly, the mesh entry points, and the refusal of
what is not ported (``--mode decode``).
Every engine runs with ``device="cpu"``: the plain PyTorch versions."""
import dataclasses
import json
import math
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap, rlu
from repro_torch.serving import (MetricsCollector, Request, ServingEngine,
                                 TenantRegistry, Tracer)
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.metrics import LogHistogram, SpaceSaving
from repro_torch.serving.tenancy import TenantSpace
from repro_torch.serving.tracing import NULL_TRACER, SPAN_NAMES

from model import DictModel, make_engine_schedule, \
    replay_schedule_against_model

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools import trace_report  # noqa: E402
import torch_threads

one_thread = torch_threads.one_thread

CPU = "cpu"


def _cfg(**kw):
    base = dict(num_buckets=32, slots_per_page=16, overflow_pages=32,
                max_chain=8, backend="ref")
    base.update(kw)
    return HashMemConfig(**base)


def _engine(**kw):
    kw.setdefault("max_slots", 8)
    kw.setdefault("device", CPU)
    cfg = kw.pop("cfg", _cfg())
    return ServingEngine(cfg, **kw)


NO_CALLS = {"probe": 0, "delete": 0, "insert": 0, "fused_tick": 0}


def _calls(**kw):
    return {**NO_CALLS, **kw}


# ---------------------------------------------------------------------------
# Coalescing
# ---------------------------------------------------------------------------

def test_one_batched_call_per_phase_per_tick():
    """16 concurrent inserting requests -> ONE insert call in the tick."""
    eng = _engine(max_slots=16)
    eng.submit_all([Request(ops=[("insert", k, k + 1), ("read", k)])
                    for k in range(16)])
    eng.tick()
    assert eng.calls_last_tick == _calls(insert=1)
    eng.tick()
    assert eng.calls_last_tick == _calls(probe=1)


@pytest.mark.parametrize("shards", [1, 2])
def test_mixed_tick_at_most_one_call_per_phase_per_shard(shards):
    eng = _engine(max_slots=12, num_shards=shards)
    eng.preload(np.arange(32, dtype=np.uint32),
                np.arange(32, dtype=np.uint32) + 7)
    reqs = [Request(ops=[("read", k)]) for k in range(4)] + \
           [Request(ops=[("update", k, 99)]) for k in range(4, 8)] + \
           [Request(ops=[("delete", k)]) for k in range(8, 10)] + \
           [Request(ops=[("rmw", k, 5)]) for k in range(10, 12)]
    eng.submit_all(reqs)
    eng.tick()
    for kind in ("probe", "delete", "insert"):
        assert 1 <= eng.calls_last_tick[kind] <= shards, \
            (shards, kind, eng.calls_last_tick)


def test_per_request_baseline_calls_scale_with_requests():
    eng = _engine(max_slots=16, coalesce=False)
    eng.submit_all([Request(ops=[("insert", k, k + 1)]) for k in range(16)])
    eng.tick()
    assert eng.calls_last_tick["insert"] == 16


def test_coalesced_equals_per_request_results():
    """Identical request stream, identical per-request results either way
    (fixed phase order; distinct keys within a tick)."""
    def build(coalesce):
        eng = _engine(max_slots=4, coalesce=coalesce)
        eng.preload(np.arange(16, dtype=np.uint32),
                    np.arange(16, dtype=np.uint32) * 10)
        reqs = [
            Request(ops=[("read", 0), ("update", 0, 111), ("read", 0)]),
            Request(ops=[("rmw", 1, 222), ("read", 1), ("delete", 1)]),
            Request(ops=[("scan", 2, 4), ("insert", 100, 7), ("read", 100)]),
            Request(ops=[("read", 15), ("delete", 15), ("read", 15)]),
            Request(ops=[("read", 3), ("read", 100), ("scan", 0, 3)]),
        ]
        eng.submit_all(reqs)
        eng.run()
        return [r.results for r in reqs]

    assert build(True) == build(False)


# ---------------------------------------------------------------------------
# Differential: engine semantics vs the dict model
# ---------------------------------------------------------------------------

def test_engine_differential_vs_dict_model():
    """Random single-op requests (distinct keys per tick) replayed against
    DictModel, which encodes the exact HashMem semantics: update is
    tombstone-oldest + append, probe returns the oldest duplicate."""
    rng = np.random.default_rng(7)
    eng = _engine(max_slots=6, cfg=_cfg(num_buckets=16, overflow_pages=48))
    m = DictModel()
    keys0 = np.arange(24, dtype=np.uint32)
    vals0 = rng.integers(1, 2**31, 24).astype(np.uint32)
    eng.preload(keys0, vals0)
    m.insert(keys0, vals0, np.ones(24, bool))

    for _ in range(30):
        ks = rng.choice(40, size=6, replace=False)
        reqs = []
        for k in ks:
            kind = rng.choice(["read", "update", "insert", "delete", "rmw"])
            v = int(rng.integers(1, 2**31))
            if kind in ("read", "delete"):
                reqs.append(Request(ops=[(str(kind), int(k))]))
            else:
                reqs.append(Request(ops=[(str(kind), int(k), v)]))
        eng.submit_all(reqs)
        eng.tick()
        # mirror the tick's phase order on the model: probe, delete, insert
        expected = {}
        for r in reqs:
            op = r.ops[0]
            if op[0] in ("read", "rmw"):
                ev, ef = m.probe([op[1]])
                expected[r.rid] = (ev[0], ef[0])
        for r in reqs:
            op = r.ops[0]
            if op[0] in ("delete", "update", "rmw"):
                m.delete([op[1]])
        for r in reqs:
            op = r.ops[0]
            if op[0] in ("insert", "update", "rmw"):
                m.insert([op[1]], [op[2]], [True])
        for r in reqs:
            res = r.results[0]
            op = r.ops[0]
            if op[0] in ("read", "rmw"):
                ev, ef = expected[r.rid]
                field = "value" if op[0] == "read" else "old"
                assert res["found"] == ef and (not ef or res[field] == ev)
    st = hashmap.stats(eng.shards[0])
    assert st["live_entries"] == m.live_entries()


# ---------------------------------------------------------------------------
# Admission control + slot lifecycle
# ---------------------------------------------------------------------------

def test_admission_queue_and_reject():
    eng = _engine(max_slots=2, max_pending=3)
    outcomes = [eng.submit(Request(ops=[("read", 0)])) for _ in range(7)]
    assert outcomes == ["admitted", "admitted", "queued", "queued",
                        "queued", "rejected", "rejected"]
    snap = eng.run()
    assert snap["requests_completed"] == 5      # rejected ones never run
    assert eng.pool.idle()


def test_tenant_slot_quota_throttles_concurrency():
    reg = TenantRegistry()
    greedy = reg.register("greedy", max_slots=1)
    other = reg.register("other")
    eng = _engine(max_slots=4, tenants=reg)
    eng.submit_all([Request(ops=[("read", k), ("read", k)], tenant=greedy)
                    for k in range(4)])
    eng.submit_all([Request(ops=[("read", k)], tenant=other)
                    for k in range(3)])
    occ = []
    while not eng.pool.idle():
        eng.tick()
        occ.append(eng._active_by_tenant.get(greedy.tid, 0))
    assert max(occ) == 1                        # quota held every tick
    assert greedy.stats["completed"] == 4       # but all work drained
    assert other.stats["completed"] == 3


def test_tenant_pending_quota_rejects():
    reg = TenantRegistry()
    t = reg.register("t", max_slots=1, max_pending=2)
    eng = _engine(max_slots=4, tenants=reg)
    outcomes = [eng.submit(Request(ops=[("read", 0)], tenant=t))
                for _ in range(5)]
    assert outcomes == ["admitted", "queued", "queued",
                        "rejected", "rejected"]
    assert t.stats["rejected"] == 2


def test_slot_recycling_drains_backlog():
    eng = _engine(max_slots=3)
    n = 17
    eng.submit_all([Request(ops=[("insert", k, k)]) for k in range(n)])
    snap = eng.run()
    assert snap["requests_completed"] == n
    assert snap["occupancy"]["max"] == 3
    _, f = hashmap.probe(eng.shards[0], np.arange(n, dtype=np.uint32))
    assert bool(f.all())


def test_reserved_keys_are_rejected_at_submit_and_preload():
    eng = _engine()
    with pytest.raises(ValueError, match="reserved"):
        eng.submit(Request(ops=[("read", int(engine_mod.PAD_KEY))]))
    with pytest.raises(ValueError, match="reserved"):
        eng.preload(np.asarray([0xFFFFFFFE], np.uint32),
                    np.asarray([1], np.uint32))
    with pytest.raises(ValueError, match="unknown op kind"):
        eng.submit(Request(ops=[("raed", 1)]))


# ---------------------------------------------------------------------------
# Engine-tick compaction + metrics
# ---------------------------------------------------------------------------

def test_tick_clock_compaction_without_further_deletes():
    """Tombstones left by early deletes are reclaimed by the tick clock
    even though no later request ever deletes."""
    eng = _engine(max_slots=8, compact_every=4,
                  cfg=_cfg(compact_tombstone_frac=0.0))
    keys = np.arange(16, dtype=np.uint32)
    eng.preload(keys, keys + 1)
    eng.submit_all([Request(ops=[("delete", int(k))]) for k in keys[:6]])
    eng.run()
    assert eng.compact_events == 0               # tick clock not reached yet
    assert hashmap.stats(eng.shards[0])["tombstones"] == 6
    # read-only traffic from here on — compaction must still fire
    eng.submit_all([Request(ops=[("read", int(k))] * 3)
                    for k in np.tile(keys[6:14], 2)])
    eng.run()
    assert eng.compact_events >= 1
    assert hashmap.stats(eng.shards[0])["tombstones"] == 0


def test_metrics_snapshot_contents():
    eng = _engine(max_slots=4, metrics=MetricsCollector(chain_sample_every=1))
    eng.preload(np.arange(8, dtype=np.uint32), np.arange(8, dtype=np.uint32))
    eng.submit_all([Request(ops=[("read", k % 8), ("update", k % 8, 5)])
                    for k in range(6)])
    snap = eng.run()
    assert snap["requests_completed"] == 6
    assert snap["total_ops"] == 12
    assert snap["probe_hit_rate"] == 1.0
    assert snap["request_latency_ticks"]["p99"] >= \
        snap["request_latency_ticks"]["p50"] >= 2
    assert snap["occupancy"]["max"] <= 4
    assert snap["chain_telemetry"], "chain sampling never ran"
    assert snap["rows_activated"]["mean"] >= 1.0
    assert snap["op_counts"]["read"] == 6
    assert eng.stats()["tenants"] == {}


@pytest.mark.parametrize("shards", [1, 3])
def test_scan_results(shards):
    eng = _engine(max_slots=2, num_shards=shards)
    eng.preload(np.arange(10, dtype=np.uint32),
                np.arange(10, dtype=np.uint32) * 2)
    r = Request(ops=[("scan", 7, 5)])
    eng.submit(r)
    eng.run()
    res = r.results[0]
    assert res["values"][:3] == [14, 16, 18]
    assert res["found"] == [True, True, True, False, False]


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("shard_by", ["mod", "highbits"])
def test_sharded_engine_correctness(shards, shard_by):
    eng = _engine(max_slots=4, num_shards=shards, shard_by=shard_by)
    keys = np.arange(30, dtype=np.uint32)
    eng.preload(keys, keys * 5)
    reqs = [Request(ops=[("read", int(k))]) for k in keys]
    eng.submit_all(reqs)
    eng.run()
    for k, r in zip(keys, reqs):
        assert r.results[0] == {"op": "read", "key": int(k),
                                "value": int(k) * 5, "found": True}
    owners = rlu.owner_of_np(keys, eng.shards[0].config, shards, shard_by)
    for s in range(shards):
        assert hashmap.stats(eng.shards[s])["live_entries"] == \
            int((owners == s).sum())


# ---------------------------------------------------------------------------
# Multi-tick op pipelining (metamorphic: pipelined == unpipelined, exactly)
# ---------------------------------------------------------------------------

def _strip_time(snap: dict) -> dict:
    """Deterministic slice of a metrics snapshot (wall-clock fields vary)."""
    return {k: snap[k] for k in
            ("ticks", "total_ops", "ops_per_tick", "requests_completed",
             "request_latency_ticks", "occupancy", "op_counts",
             "probe_hit_rate")}


@pytest.mark.parametrize("seed", range(6))
def test_pipelined_results_and_metrics_equal_unpipelined(seed):
    """Random mixed workloads (uniform AND zipfian-contended): pipeline
    depths 2 and 3 must reproduce the unpipelined run bit-for-bit — request
    results, the op->tick schedule itself, and every deterministic metric —
    and the schedule replays against the DictModel."""
    streams = make_engine_schedule(seed, n_requests=16, ops_per_request=3,
                                   keyspace=32,
                                   zipf_theta=0.99 if seed % 2 else 0.0)

    def run(depth):
        eng = _engine(max_slots=8, pipeline_depth=depth,
                      record_schedule=True)
        eng.preload(np.arange(16, dtype=np.uint32),
                    np.arange(16, dtype=np.uint32) * 3)
        reqs = [Request(ops=list(o)) for o in streams]
        eng.submit_all(reqs)
        snap = eng.run()
        return [r.results for r in reqs], snap, eng

    r1, s1, e1 = run(1)
    model = DictModel()
    model.insert(range(16), [3 * k for k in range(16)], [True] * 16)
    replay_schedule_against_model(e1.schedule, model)
    for depth in (2, 3):
        rd, sd, ed = run(depth)
        assert rd == r1, (seed, depth)
        assert ed.schedule == e1.schedule, (seed, depth)
        assert _strip_time(sd) == _strip_time(s1), (seed, depth)


def test_pipelined_read_your_writes_stalls_fence():
    """A read of a key whose insert is still in flight must stall the
    pipeline (write-claim fence), then observe the write."""
    eng = _engine(max_slots=2, pipeline_depth=2)
    eng.preload(np.asarray([5], np.uint32), np.asarray([50], np.uint32))
    r = Request(ops=[("update", 5, 111), ("read", 5)])
    eng.submit(r)
    eng.run()
    assert r.results[1] == {"op": "read", "key": 5, "value": 111,
                            "found": True}
    assert eng.stall_events >= 1
    # non-conflicting traffic does NOT stall
    eng2 = _engine(max_slots=4, pipeline_depth=2)
    eng2.preload(np.arange(8, dtype=np.uint32), np.arange(8, dtype=np.uint32))
    eng2.submit_all([Request(ops=[("insert", 100 + k, k), ("read", k)])
                     for k in range(4)])
    eng2.run()
    assert eng2.stall_events == 0


def test_pipelined_tick_call_counts_unchanged():
    """A pipelined tick still issues at most one call per phase per shard."""
    eng = _engine(max_slots=16, pipeline_depth=2)
    eng.submit_all([Request(ops=[("insert", k, k + 1), ("read", 100 + k)])
                    for k in range(16)])
    eng.tick()
    assert eng.calls_last_tick == _calls(insert=1)
    eng.tick()
    assert eng.calls_last_tick == _calls(probe=1)
    assert eng.stats()["pipeline"]["depth"] == 2


def test_one_shard_grow_keeps_other_shards_tombstone_accounting():
    """A grow that rebuilds only shard 1 must not reset shard 0's tombstone
    counter (per-shard rebuild epochs)."""
    cfg = _cfg(num_buckets=8, slots_per_page=8, overflow_pages=8,
               max_chain=2, auto_grow=True)
    eng = ServingEngine(cfg, num_shards=2, max_slots=8, compact_every=10**6,
                        device=CPU)
    owners = rlu.owner_of_np(np.arange(4096, dtype=np.uint32), cfg, 2,
                             eng.shard_by)
    k0 = np.nonzero(owners == 0)[0][:8].astype(np.uint32)
    k1 = np.nonzero(owners == 1)[0][:160].astype(np.uint32)
    eng.preload(k0, k0)
    eng.submit_all([Request(ops=[("delete", int(k))]) for k in k0[:4]])
    eng.run()
    assert eng._tombstones[0] == 4
    eng.submit_all([Request(ops=[("insert", int(k), 1)]) for k in k1])
    eng.run()
    assert eng.grow_events >= 1
    assert eng.shards[1].config.num_buckets > cfg.num_buckets
    assert eng.shards[0].config.num_buckets == cfg.num_buckets
    assert eng._tombstones[0] == 4, "untouched shard's accounting was reset"
    assert eng._tombstones[1] == 0


@pytest.mark.parametrize("coalesce", [True, False])
def test_same_tick_write_contention_is_serialized(coalesce):
    """Two updates of one key submitted in the same tick behave like
    sequential updates (write-claim deferral): no leaked duplicate copies,
    and a later read sees the LAST writer's value."""
    eng = _engine(max_slots=8, coalesce=coalesce)
    eng.preload(np.asarray([5], np.uint32), np.asarray([50], np.uint32))
    r1 = Request(ops=[("update", 5, 111)])
    r2 = Request(ops=[("update", 5, 222)])
    eng.submit_all([r1, r2])
    eng.tick()                               # r2's update is deferred
    assert r1.results and not r2.results
    eng.run()
    eng.submit(Request(ops=[("update", 5, 333)]))
    eng.run()
    r4 = Request(ops=[("read", 5)])
    eng.submit(r4)
    eng.run()
    assert hashmap.stats(eng.shards[0])["live_entries"] == 1
    assert r4.results[0] == {"op": "read", "key": 5, "value": 333,
                             "found": True}


def test_same_tick_duplicate_deletes_remove_once():
    eng = _engine(max_slots=8)
    eng.preload(np.asarray([9], np.uint32), np.asarray([90], np.uint32))
    d1 = Request(ops=[("delete", 9)])
    d2 = Request(ops=[("delete", 9)])
    eng.submit_all([d1, d2])
    eng.run()
    assert d1.results[0]["found"] is True
    assert d2.results[0]["found"] is False
    assert hashmap.stats(eng.shards[0])["live_entries"] == 0


# ---------------------------------------------------------------------------
# The port's changes of form
# ---------------------------------------------------------------------------

def test_one_host_copy_per_phase_at_drain(monkeypatch):
    """Each phase's results cross to the host once, at drain: a pipelined
    tick issues with no copy, and draining it makes one per phase however
    many shards the phase touched."""
    copies = []
    real = engine_mod._to_host
    monkeypatch.setattr(engine_mod, "_to_host",
                        lambda parts: copies.append(len(parts)) or
                        real(parts))
    eng = _engine(max_slots=8, num_shards=3, pipeline_depth=2)
    eng.preload(np.arange(32, dtype=np.uint32), np.arange(32, dtype=np.uint32))
    eng.submit_all([Request(ops=[("read", k), ("update", k, 1)])
                    for k in range(8)])
    eng.tick()
    assert copies == [] and len(eng._inflight) == 1
    eng.flush()
    assert len(copies) == 1 and copies[0] == 2 * eng.calls_last_tick["probe"]
    eng.tick()
    eng.flush()
    assert len(copies) == 3        # delete + insert of the second tick


def test_tables_must_be_on_the_engine_device():
    t = hashmap.create(_cfg(), device=CPU)
    eng = ServingEngine(tables=[t], device=CPU)
    assert eng.shards[0] is t
    elsewhere = dataclasses.replace(t, store=dataclasses.replace(
        t.store, pool=t.store.pool.to("meta")))
    with pytest.raises(ValueError, match="engine on cpu"):
        ServingEngine(tables=[elsewhere], device=CPU)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine()


def test_profiler_window_brackets_ticks(tmp_path):
    eng = _engine(max_slots=4, trace=True)
    eng.profile_ticks(1, 3, str(tmp_path))
    for _ in range(8):
        eng.submit(Request(ops=[("insert", 3, 4), ("read", 3)]))
    eng.run()
    assert eng.profiler is not None and eng.profile_seconds > 0.0
    assert list(tmp_path.glob("ticks_1_3.json"))
    names = {e.key for e in eng.profiler.key_averages()}
    assert names, "the window recorded no operators"
    marks = [e["name"] for e in eng.tracer.to_events() if e["ph"] == "i"
             and e["name"].startswith("profiler_")]
    assert marks == ["profiler_start", "profiler_stop"]


def test_profiler_failure_raises(tmp_path, monkeypatch):
    import torch.profiler

    def boom(**_):
        raise RuntimeError("no profiler backend")
    monkeypatch.setattr(torch.profiler, "profile", boom)
    eng = _engine(max_slots=4)
    eng.profile_ticks(0, 1, str(tmp_path))
    eng.submit(Request(ops=[("insert", 3, 4), ("read", 3)]))
    with pytest.raises(RuntimeError, match="no profiler backend"):
        eng.run()


@pytest.mark.parametrize("fused", [None, False])
def test_mesh_engine_runs_fused_and_unfused(fused):
    """``mesh=`` stacks the shards; a coalesced mesh engine fuses its tick
    unless ``fused_tick=False``."""
    from repro_torch.launch.mesh import make_serving_mesh
    eng = _engine(mesh=make_serving_mesh(2, device=CPU), fused_tick=fused)
    assert eng.fused_tick == (fused is None) and eng.num_shards == 2
    eng.submit_all([Request(ops=[("insert", k, k + 1), ("read", k)])
                    for k in range(8)])
    eng.run()
    want = _calls(fused_tick=2) if fused is None \
        else _calls(probe=1, insert=1)
    assert eng.batch_calls == want
    st = eng.stats()
    assert st["mesh_backed"] and st["fused_tick"] == (fused is None)
    assert st["route_cap_totals"]["launches"] == want["fused_tick"]


# ---------------------------------------------------------------------------
# Tenancy
# ---------------------------------------------------------------------------

def test_fold_unfold_roundtrip_and_sentinel_safety():
    sp = TenantSpace(bits=8)
    keys = np.random.default_rng(0).integers(0, sp.key_space,
                                             1000).astype(np.uint32)
    for tid in (0, 1, 17, sp.max_tenants - 1):
        tids, raw = sp.unfold(sp.fold(tid, keys))
        assert (tids == tid).all() and (raw == keys).all()
    assert sp.fold(sp.max_tenants - 1, [sp.key_space - 1])[0] < 0xFFFFFFF0
    with pytest.raises(ValueError):
        sp.fold(sp.max_tenants, [0])
    with pytest.raises(ValueError):
        sp.fold(0, [sp.key_space])


def _read_all(eng, tenant, keys):
    reqs = [Request(ops=[("read", int(k))], tenant=tenant) for k in keys]
    eng.submit_all(reqs)
    eng.run()
    return [(r.results[0]["value"], r.results[0]["found"]) for r in reqs]


def test_tenant_isolation_under_deletes_and_growth():
    reg = TenantRegistry()
    a = reg.register("A")
    b = reg.register("B")
    cfg = HashMemConfig(num_buckets=8, slots_per_page=4, overflow_pages=16,
                        max_chain=2, backend="ref", auto_grow=True,
                        max_load_factor=0.9)
    eng = ServingEngine(cfg, max_slots=8, tenants=reg, device=CPU)
    rng = np.random.default_rng(3)
    bkeys = np.arange(40, dtype=np.uint32)
    bvals = rng.integers(1, 2**31, 40).astype(np.uint32)
    eng.preload(bkeys, bvals, tenant=b)
    before = _read_all(eng, b, bkeys)
    assert [v for v, _ in before] == [int(v) for v in bvals]
    for _ in range(6):
        ks = rng.choice(64, size=8, replace=False)
        eng.submit_all(
            [Request(ops=[("insert", int(k), int(rng.integers(1, 2**31)))],
                     tenant=a) for k in ks[:5]]
            + [Request(ops=[("delete", int(k))], tenant=a) for k in ks[5:]])
        eng.run()
    assert eng.grow_events >= 1, "churn never forced a grow rebuild"
    assert _read_all(eng, b, bkeys) == before
    eng.submit_all([Request(ops=[("delete", int(k))], tenant=b)
                    for k in bkeys[:10]])
    eng.run()
    assert not any(f for _, f in _read_all(eng, b, bkeys[:10]))
    assert hashmap.stats(eng.shards[0])["live_entries"] > 0


@pytest.mark.parametrize("shards", [1, 3])
def test_tenant_stats_exact_attribution_multi_shard(shards):
    """Per-tenant accounting is exact: once per executed op at gather time
    and once per probed key at writeback, whichever shard an op routes to;
    deferred writers count once, on the tick they execute."""
    reg = TenantRegistry()
    a = reg.register("A")
    b = reg.register("B")
    eng = ServingEngine(_cfg(), max_slots=8, tenants=reg, num_shards=shards,
                        device=CPU)
    eng.preload(np.arange(16, dtype=np.uint32),
                np.arange(16, dtype=np.uint32) * 2, tenant=a)
    eng.submit_all([
        Request(ops=[("update", 0, 9), ("read", 0)], tenant=a),
        Request(ops=[("scan", 1, 4)], tenant=a),
        Request(ops=[("rmw", 5, 7), ("read", 5)], tenant=a),
        Request(ops=[("update", 0, 11)], tenant=a),
    ])
    eng.submit_all([Request(ops=[("read", k)], tenant=b) for k in range(3)])
    eng.run()
    st = reg.stats()
    assert st["A"]["ops"] == {"read": 2, "update": 2, "insert": 0,
                              "delete": 0, "scan": 1, "rmw": 1}
    assert st["A"]["hits"] == 7 and st["A"]["misses"] == 0
    assert st["B"]["ops"]["read"] == 3 and st["B"]["misses"] == 3
    assert st["A"]["completed"] == 4 and st["B"]["completed"] == 3
    va, fa = _read_all(eng, a, [0])[0]
    assert fa and va == 11


def test_tenant_killed_attribution():
    reg = TenantRegistry()
    t = reg.register("T")
    eng = ServingEngine(_cfg(), max_slots=2, tenants=reg, device=CPU)
    victim = Request(ops=[("insert", 1, 1), ("insert", 2, 2),
                          ("insert", 3, 3)], tenant=t)
    other = Request(ops=[("read", 1)], tenant=t)
    eng.submit_all([victim, other])
    eng.tick()
    assert eng.kill(victim)
    eng.run()
    st = reg.stats()["T"]
    assert st["killed"] == 1 and st["completed"] == 1
    assert st["ops"]["insert"] == 1
    assert eng.stats()["killed_requests"] == 1


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

def validate_events(events):
    spans, _, problems = trace_report.validate(events)
    assert not problems, problems
    return spans


def run_traced(depth, trace=True, n_reqs=24, seed=3):
    rng = np.random.default_rng(seed)
    eng = ServingEngine(num_shards=2, max_slots=8, pipeline_depth=depth,
                        trace=trace, record_schedule=True, device=CPU)
    eng.preload(np.arange(64, dtype=np.uint32),
                np.arange(64, dtype=np.uint32))
    reqs = []
    for _ in range(n_reqs):
        k = int(rng.integers(0, 64))
        reqs.append(Request(ops=[("read", k), ("update", k, k + 1),
                                 ("read", k)]))
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, reqs


def test_ring_bound_and_balanced_export():
    tr = Tracer(capacity=8)
    for i in range(50):
        with tr.span("tick", tid=i % 3, tick=i):
            with tr.span("gather", tid=i % 3):
                pass
    assert len(tr) == 8 and tr.dropped == 92
    validate_events(tr.to_events())
    off = Tracer(enabled=False)
    with off.span("tick"):
        off.counter("occupancy", 1)
    assert len(off) == 0 and NULL_TRACER.to_events() == []


def test_engine_trace_valid_and_has_span_vocabulary(tmp_path):
    eng, _ = run_traced(depth=1)
    path = tmp_path / "eng.json"
    eng.export_trace(str(path))
    doc = json.loads(path.read_text())
    spans = validate_events(doc["traceEvents"])
    seen = {s[0] for s in spans}
    assert {"tick", "gather", "probe", "delete", "insert", "writeback",
            "admit", "preload"} <= seen
    assert seen <= set(SPAN_NAMES)
    assert doc["otherData"]["pipeline_depth"] == 1
    assert doc["otherData"]["fused_tick"] is False


def test_phase_spans_nest_inside_their_tick():
    eng, _ = run_traced(depth=1)
    spans = validate_events(eng.tracer.to_events())
    ticks = [(s[2], s[2] + s[3]) for s in spans if s[0] == "tick"]
    for name, _, ts, dur, *_ in spans:
        if name in ("gather", "probe", "delete", "insert"):
            assert any(lo <= ts and ts + dur <= hi + 1e-3
                       for lo, hi in ticks), name


@pytest.mark.parametrize("depth", [2, 3])
def test_pipelined_ticks_overlap_and_schedule_matches_unpipelined(depth):
    eng1, _ = run_traced(depth=1)
    eng, _ = run_traced(depth=depth)
    strip = [(t, k, keys, v) for t, k, keys, v, _ in eng1.schedule]
    assert [(t, k, keys, v) for t, k, keys, v, _ in eng.schedule] == strip
    spans = validate_events(eng.tracer.to_events())
    ticks = [s for s in spans if s[0] == "tick"]
    assert len({s[1] for s in ticks}) == depth      # one track per lane
    ivs = sorted((s[2], s[2] + s[3], s[1]) for s in ticks)
    assert sum(1 for a, b in zip(ivs, ivs[1:])
               if b[0] < a[1] and a[2] != b[2]) >= 1


def test_stall_visible_in_pipelined_trace():
    eng = ServingEngine(num_shards=2, max_slots=4, pipeline_depth=2,
                        trace=True, device=CPU)
    for _ in range(6):
        eng.submit(Request(ops=[("update", 1, 9), ("read", 1),
                                ("update", 1, 10)]))
    eng.run()
    assert eng.stall_events >= 1
    spans = validate_events(eng.tracer.to_events())
    assert len([s for s in spans if s[0] == "pipeline_stall"]) == \
        eng.stall_events


def test_killed_request_emits_abort_exactly_once():
    eng = ServingEngine(num_shards=1, max_slots=2, trace=True, device=CPU)
    live = Request(ops=[("read", 1)] * 6)
    victim = Request(ops=[("read", 2)] * 6)
    eng.submit(live)
    eng.submit(victim)
    eng.tick()
    assert eng.kill(victim)
    assert not eng.kill(victim)
    eng.run()
    evs = eng.tracer.to_events()
    kills = [e for e in evs if e["ph"] == "i" and e["name"] == "kill"]
    assert len(kills) == 1 and kills[0]["args"]["rid"] == victim.rid
    ends = [e for e in evs if e["ph"] == "e" and e["name"] == "request"
            and e["id"] == victim.rid]
    assert len(ends) == 1 and ends[0]["args"]["status"] == "killed"


def test_request_lifecycle_slices_and_counters():
    eng, reqs = run_traced(depth=2)
    evs = eng.tracer.to_events()
    per = defaultdict(lambda: defaultdict(int))
    for e in evs:
        if e["ph"] in ("b", "e"):
            per[(e["name"], e["id"])][e["ph"]] += 1
    for key, c in per.items():
        assert c["b"] == 1 and c["e"] == 1, (key, dict(c))
    names = defaultdict(set)
    for (name, rid) in per:
        names[rid].add(name)
    done = [r.rid for r in reqs if r.done()]
    assert done and all(names[rid] == {"request", "queue", "service"}
                        for rid in done)
    occ = [e for e in evs if e["ph"] == "C" and e["name"] == "occupancy"]
    assert len(occ) == eng.ticks


def test_untraced_engine_matches_traced_results():
    eng_t, reqs_t = run_traced(depth=2, trace=True)
    eng_u, reqs_u = run_traced(depth=2, trace=False)
    assert [r.results for r in reqs_t] == [r.results for r in reqs_u]
    assert eng_u.tracer is NULL_TRACER and len(eng_u.tracer) == 0


def test_trace_report_cli_on_a_port_trace(tmp_path, capsys):
    eng, _ = run_traced(depth=2)
    path = tmp_path / "r.json"
    eng.export_trace(str(path))
    rc = trace_report.main([str(path), "--assert-spans",
                            "tick,gather,probe,delete,insert,writeback"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "per-phase breakdown" in out and "trace OK" in out
    assert trace_report.main([str(path), "--assert-spans", "fused_tick"]) == 1
    capsys.readouterr()


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def test_empty_snapshot_is_finite_and_json_safe():
    m = MetricsCollector()
    doc = json.loads(m.to_json())
    assert doc["ticks"] == 0 and doc["total_ops"] == 0
    assert doc["request_latency_ticks"]["p50"] == 0.0


def test_log_histogram_and_space_saving():
    rng = np.random.default_rng(0)
    samples = rng.exponential(5e-3, 20_000)
    h = LogHistogram(lsb=1e-6)
    for v in samples:
        h.record(v)
    for q in (50, 99):
        exact = float(np.percentile(samples, q, method="inverted_cdf"))
        assert h.percentile(q) == pytest.approx(exact, rel=0.05)
    ss = SpaceSaving(k=16)
    stream = rng.zipf(1.3, 5000) % 200
    for k in stream:
        ss.offer(int(k))
    top = int(np.bincount(stream).argmax())
    assert top in {k for k, _, _ in ss.top(16)}


def test_chain_sample_walks_every_shard_in_one_copy():
    eng = _engine(max_slots=4, num_shards=3)
    eng.preload(np.arange(300, dtype=np.uint32),
                np.arange(300, dtype=np.uint32))
    eng.metrics.force_chain_sample(eng.shards)
    s = eng.metrics.chain_samples[-1]
    want = [int(hashmap.chain_lengths(hm).max()) for hm in eng.shards]
    assert s["max_chain_per_shard"] == want
    assert s["buckets"] == 3 * eng.shards[0].config.num_buckets


def test_to_prom_exposition_from_an_engine():
    eng, _ = run_traced(depth=1, trace=False)
    text = eng.metrics.to_prom()
    for ln in text.splitlines():
        if not ln.startswith("#"):
            assert math.isfinite(float(ln.rsplit(" ", 1)[1])), ln
    assert f"hashmem_ticks_total {eng.ticks}" in text
    assert 'hashmem_phase_seconds{phase="writeback",quantile="0.5"}' in text


# ---------------------------------------------------------------------------
# Entry points: the kv serve CLI and the multi-tenant example
# ---------------------------------------------------------------------------

def test_serve_kv_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import serve
    trace = tmp_path / "kv.json"
    prom = tmp_path / "kv.prom"
    eng, snap = serve.serve_kv(workloads="A,B,E", requests=24, slots=8,
                               shards=2, record_count=512, pipeline=2,
                               backend="perf", device=CPU,
                               trace_out=str(trace), metrics_prom=str(prom))
    assert snap["requests_completed"] == 24
    assert eng.shards[0].config.backend == "perf"
    assert trace_report.main([str(trace), "--assert-spans",
                              "tick,probe,writeback"]) == 0
    assert "hashmem_ops_total" in prom.read_text()
    capsys.readouterr()


@pytest.mark.parametrize("argv,match", [
    (["--mode", "decode", "--arch", "whisper-tiny", "--smoke"],
     "src/repro/launch/serve.py:57"),
])
def test_serve_cli_refuses_what_is_not_ported(argv, match, capsys):
    """The decode CLI refuses an encoder-decoder arch, which the reference's
    serving loop cannot serve either (``launch.serve.refuse_encdec``)."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as e:
        serve.main(argv + ["--device", CPU])
    assert e.value.code != 0
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--mesh-shards", "2"],
                                  ["--no-fused-tick"]])
def test_serve_cli_mesh_flags(argv, capsys):
    """``--mesh-shards N`` serves from N stacked shards; ``--no-fused-tick``
    alone keeps host shards (it selects the unfused mesh path)."""
    from repro_torch.launch import serve
    serve.main(["--mode", "kv", "--device", CPU, "--requests", "8",
                "--slots", "4", "--record-count", "256"] + argv)
    out = capsys.readouterr().out
    st = json.loads(out[out.index("{"):])["engine"]
    mesh = "--mesh-shards" in argv
    assert st["mesh_backed"] == mesh and st["fused_tick"] == mesh
    assert len(st["shards"]) == (2 if mesh else 1)


def test_serve_cli_kv_main(capsys):
    from repro_torch.launch import serve
    serve.main(["--mode", "kv", "--device", CPU, "--workloads", "C",
                "--requests", "8", "--slots", "4", "--record-count", "256"])
    out = capsys.readouterr().out
    doc = json.loads(out[out.index("{"):])
    assert doc["requests_completed"] == 8
    assert doc["engine"]["shards"][0]["num_buckets"] == 256


def test_serve_multitenant_example(capsys):
    from repro_torch import serve_multitenant
    reg, eng = serve_multitenant.main(CPU)
    st = reg.stats()
    assert st["webapp"]["completed"] + st["webapp"]["rejected"] == 24
    assert sum(t["completed"] for t in st.values()) > 0
    assert "per-tenant stats" in capsys.readouterr().out
