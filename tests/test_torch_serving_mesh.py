"""The port's mesh-backed serving engine (``ServingEngine(mesh=...)``) on its
own, on the CPU: no JAX corpus.  The port's host-shard engine is already
equal to the JAX engine (``tests/test_torch_serving_parity.py``), so the mesh
engine is held against it on the schedules of ``tests/model.py`` -- equal
results, ``record_schedule`` logs, deterministic metrics and, where no
growth differs, equal tables -- and against the ``DictModel`` replay, with
per-shard ownership and population checks, as ``tests/sharded_driver.py``
holds the JAX mesh engine.  Also: the repair cases (a grow and an
extendible split inside a pipelined window, a request killed mid-pipeline),
one call per phase (or one fused call) per tick, the routing-capacity log
against ``rlu.routing_cap``, the ``--mesh-shards``/``--no-fused-tick`` CLI,
``channels_demo`` and the device rules.  Tolerance 0 throughout."""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap, rlu
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.serving import Request, ServingEngine, build_ycsb_engine

from model import (DictModel, make_engine_schedule,
                   make_insert_heavy_schedule, replay_schedule_against_model)
import torch_threads

one_thread = torch_threads.one_thread

CPU = "cpu"
CLOCK_KEYS = ("wall_seconds", "ops_per_sec", "request_latency_ms",
              "queue_ms", "service_ms", "tick_ms", "phase_ms")
ZERO = {"probe": 0, "delete": 0, "insert": 0, "fused_tick": 0}


def _cfg(**kw):
    base = dict(num_buckets=16, slots_per_page=8, overflow_pages=32,
                max_chain=4, backend="ref")
    base.update(kw)
    return HashMemConfig(**base)


def _displaced_cfg():
    return HashMemConfig(num_buckets=16, slots_per_page=32,
                         overflow_pages=32, max_chain=4, backend="ref",
                         displacement=True, fingerprint_bits=8,
                         stash_slots=32)


def _mesh(D=2):
    return make_serving_mesh(D, device=CPU)


def run_streams(streams, cfg, preload=None, max_slots=8, **kw):
    eng = ServingEngine(cfg, max_slots=max_slots, record_schedule=True,
                        device=CPU, **kw)
    if preload is not None:
        eng.preload(*preload)
    reqs = [Request(ops=list(ops)) for ops in streams]
    eng.submit_all(reqs)
    snap = eng.run()
    return eng, [r.results for r in reqs], snap


def _seeded_model(pk, pv):
    m = DictModel()
    m.insert(pk, pv, np.ones(len(pk), bool))
    return m


def _live_keys(hm) -> np.ndarray:
    """A shard's live keys: its pool's, then its stash's."""
    leaves = hashmap.to_numpy(hm)
    keys = leaves["pool"][..., 0].reshape(-1)
    if "stash" in leaves:
        keys = np.concatenate([keys, leaves["stash"][:, 0]])
    return keys[(keys != 0xFFFFFFFF) & (keys != 0xFFFFFFFE)]


def check_shard_state(eng, model):
    """Shard live entries sum to the model's population, and every live key
    lives on the shard the router assigns it to."""
    total = 0
    for s, hm in enumerate(eng.shards):
        live = _live_keys(hm)
        total += live.size
        if live.size:
            owners = rlu.owner_of_np(live, hm.config, eng.num_shards,
                                     eng.shard_by)
            assert (owners == s).all(), f"shard {s} holds foreign keys"
    assert total == model.live_entries(), (total, model.live_entries())


def det(snap):
    return {k: v for k, v in snap.items() if k not in CLOCK_KEYS}


VARIANTS = {
    "fused_d1": dict(),
    "fused_d2": dict(pipeline_depth=2),
    "unfused_d1": dict(fused_tick=False),
    "unfused_d2": dict(fused_tick=False, pipeline_depth=2),
    "per_request": dict(coalesce=False),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mesh_engine_equals_host_engine_and_model(seed, variant):
    """Uniform (even seeds) and zipfian-contended (odd) schedules on 2 or 4
    shards: results, schedule, deterministic metrics and table leaves equal
    the host engine's; the schedule replays against the DictModel."""
    D = 2 + 2 * (seed // 2)
    streams = make_engine_schedule(seed, n_requests=16, ops_per_request=3,
                                   keyspace=48,
                                   zipf_theta=0.99 if seed % 2 else 0.0)
    rng = np.random.default_rng(seed)
    pk = rng.choice(48, 16, replace=False).astype(np.uint32)
    pv = rng.integers(1, 2**30, 16).astype(np.uint32)
    host, ref, hsnap = run_streams(streams, _cfg(), (pk, pv), num_shards=D)
    eng, results, snap = run_streams(streams, _cfg(), (pk, pv),
                                     mesh=_mesh(D), **VARIANTS[variant])
    assert results == ref
    assert eng.schedule == host.schedule
    assert det(snap) == det(hsnap)
    for a, b in zip(eng.shards, host.shards):
        want = hashmap.to_numpy(b)
        for name, leaf in hashmap.to_numpy(a).items():
            np.testing.assert_array_equal(leaf, want[name], name)
    model = replay_schedule_against_model(eng.schedule, _seeded_model(pk, pv))
    check_shard_state(eng, model)
    calls = eng.batch_calls
    if variant.startswith("fused"):
        assert calls["fused_tick"] > 0 and calls["probe"] == 0 \
            and calls["delete"] == 0 and calls["insert"] == 0, calls
    else:
        assert calls["fused_tick"] == 0, calls
    assert eng.stats()["mesh_backed"]


@pytest.mark.parametrize("variant", ["fused_d2", "unfused_d1"])
def test_displaced_mesh_engine_equals_host_engine(variant):
    streams = make_engine_schedule(7, n_requests=16, ops_per_request=3,
                                   keyspace=48, zipf_theta=0.99)
    host, ref, _ = run_streams(streams, _displaced_cfg(), num_shards=2)
    eng, results, _ = run_streams(streams, _displaced_cfg(), mesh=_mesh(),
                                  **VARIANTS[variant])
    assert results == ref and eng.schedule == host.schedule
    check_shard_state(eng, replay_schedule_against_model(eng.schedule))


def test_grow_inside_a_pipelined_window():
    """A tiny arena and insert-heavy streams force synchronized growth of
    every shard while a tick is in flight: no lost or duplicated key."""
    cfg = HashMemConfig(num_buckets=4, slots_per_page=4, overflow_pages=8,
                        max_chain=2, backend="ref", auto_grow=True,
                        max_load_factor=0.95)
    streams = make_insert_heavy_schedule(5, n_requests=48, ops_per_request=3,
                                         keyspace=96)
    _, ref, _ = run_streams(streams, cfg, num_shards=2)
    eng, results, _ = run_streams(streams, cfg, mesh=_mesh(),
                                  pipeline_depth=2)
    assert eng.grow_events >= 1 and results == ref
    model = replay_schedule_against_model(eng.schedule)
    check_shard_state(eng, model)
    keys = np.asarray(model.keys(), np.uint32)
    want = np.asarray([model.d[int(k)][0] for k in keys], np.uint32)
    v, f = rlu.probe_sharded(_mesh(), eng.backend.hm_stacked,
                             np.tile(keys, 2), eng.backend.cfg,
                             shard_by=eng.shard_by)
    assert f.all() and (v.numpy()[:keys.size] == want).all()
    counts: dict = {}
    for hm in eng.shards:
        for k in _live_keys(hm):
            counts[int(k)] = counts.get(int(k), 0) + 1
    assert counts == {k: len(v) for k, v in model.d.items()}


def test_extendible_split_inside_a_pipelined_window():
    """Extendible resize under a pipelined mesh schedule: refused inserts
    are repaired by group splits (and directory doublings) inline, with
    "split" spans and no "grow" span and no rebuild."""
    cfg = HashMemConfig(num_buckets=4, slots_per_page=4, overflow_pages=60,
                        max_chain=2, backend="ref", auto_grow=True,
                        resize="extendible", max_load_factor=1.0)
    streams = make_insert_heavy_schedule(9, n_requests=48, ops_per_request=3,
                                         keyspace=96, zipf_theta=0.6)
    _, ref, _ = run_streams(streams, cfg, num_shards=2)
    eng, results, snap = run_streams(streams, cfg, mesh=_mesh(),
                                     pipeline_depth=2, trace=True)
    assert eng.split_events >= 2 and eng.grow_events == 0
    assert results == ref
    check_shard_state(eng, replay_schedule_against_model(eng.schedule))
    assert "split" in snap["phase_ms"] and "grow" not in snap["phase_ms"]
    st = eng.stats()
    assert st["resize"] == "extendible" and st["split_events"] >= 2


def test_kill_mid_pipeline():
    eng = ServingEngine(_cfg(), mesh=_mesh(), max_slots=4, pipeline_depth=2,
                        record_schedule=True, device=CPU)
    victim = Request(ops=[("insert", 100, 1), ("insert", 101, 2),
                          ("insert", 102, 3), ("insert", 103, 4)])
    others = [Request(ops=[("insert", k, k), ("read", k), ("read", k)])
              for k in range(8)]
    eng.submit_all([victim] + others)
    backlog = [Request(ops=[("read", k)]) for k in range(4)]
    while not eng.pool.idle() or eng._inflight:
        if eng.ticks == 2 and not victim.killed:
            assert eng._inflight, "expected in-flight work at the kill"
            assert eng.kill(victim)
            eng.submit_all(backlog)         # the freed slot is reusable
        if eng.pool.idle() and eng._inflight:
            eng.flush()
        else:
            eng.tick()
    assert victim.killed and victim.cursor < len(victim.ops)
    assert all(r.done() for r in others + backlog)
    assert eng.killed_requests == 1 and eng.pool.occupancy() == 0
    check_shard_state(eng, replay_schedule_against_model(eng.schedule))
    executed = {ks[0] for _, kind, ks, _, _ in eng.schedule
                if kind == "insert"}
    assert {op[1] for op in victim.ops[victim.cursor:]}.isdisjoint(executed)


def test_one_call_per_phase_or_one_fused_call_per_tick():
    def reqs():
        return [Request(ops=[("read", k)]) for k in range(6)] + \
            [Request(ops=[("update", k, 99)]) for k in range(6, 10)] + \
            [Request(ops=[("delete", k)]) for k in range(10, 13)] + \
            [Request(ops=[("rmw", k, 5)]) for k in range(13, 16)]

    def engine(**kw):
        eng = ServingEngine(_cfg(), mesh=_mesh(), max_slots=16, device=CPU,
                            **kw)
        eng.preload(np.arange(32, dtype=np.uint32),
                    np.arange(32, dtype=np.uint32) + 7)
        return eng

    eng = engine()
    assert eng.fused_tick
    eng.submit_all(reqs())
    eng.tick()
    assert eng.calls_last_tick == dict(ZERO, fused_tick=1)
    eng = engine(fused_tick=False)
    eng.submit_all(reqs())
    eng.tick()
    assert eng.calls_last_tick == dict(ZERO, probe=1, delete=1, insert=1)
    eng = engine(pipeline_depth=2)
    eng.submit_all([Request(ops=[("update", k, 1), ("read", k + 20)])
                    for k in range(16)])
    for _ in range(2):
        eng.tick()
        assert eng.calls_last_tick == dict(ZERO, fused_tick=1)
    eng = engine(coalesce=False)
    assert not eng.fused_tick
    eng.submit_all([Request(ops=[("read", k)]) for k in range(16)])
    eng.tick()
    assert eng.calls_last_tick == dict(ZERO, probe=16)


def test_route_cap_log_equals_routing_cap_on_the_same_batches(monkeypatch):
    """Every fused call records (q_local, cap, measured max) per phase: the
    caps equal ``rlu.routing_cap`` of the batches the call routed, and on a
    batch whose keys all route to shard 0 the cap rises to Q_local and
    never truncates."""
    D = 4
    seen = []
    orig = rlu.tick_mesh

    def spy(mesh, hm, pq, dq, ik, iv, cfg, axis="model", caps=None,
            shard_by="mod"):
        seen.append([rlu.routing_cap(rlu.as_u32(q, "cpu").numpy(), cfg, D,
                                     shard_by) for q in (pq, dq, ik)])
        return orig(mesh, hm, pq, dq, ik, iv, cfg, axis, caps, shard_by)
    monkeypatch.setattr(rlu, "tick_mesh", spy)
    cand = np.arange(0, 20_000, dtype=np.uint32)
    hot = cand[rlu.owner_of_np(cand, _cfg(), D, "highbits") == 0][:64]
    rng = np.random.default_rng(7)
    streams = [[("read", int(k)), ("insert", int(k), 1),
                ("update", int(k), 2)] for k in rng.choice(hot, 40)]
    streams += make_engine_schedule(3, n_requests=8, keyspace=48)
    host, ref, _ = run_streams(streams, _cfg(), num_shards=D, max_slots=64)
    eng, results, _ = run_streams(streams, _cfg(), mesh=_mesh(D),
                                  max_slots=64)
    assert results == ref
    log = list(eng.route_cap_log)
    assert len(log) == len(seen) == eng.batch_calls["fused_tick"] > 0
    for rec, caps in zip(log, seen):
        assert rec["cap"] == caps, (rec, caps)
        for ql, cap, mx in zip(rec["q_local"], rec["cap"], rec["max"]):
            assert mx <= cap <= ql, rec
    assert any(rec["cap"][0] == rec["q_local"][0] >= 32 for rec in log)
    tot = eng.route_cap_totals
    assert tot["launches"] == len(log)
    assert tot["cap_sum"] == sum(sum(r["cap"]) for r in log)
    assert tot["q_local_sum"] == sum(sum(r["q_local"]) for r in log)
    assert eng.stats()["route_cap_totals"] == tot


def test_mesh_engine_takes_tables_and_build_ycsb_engine_takes_a_mesh():
    tables = [hashmap.create(_cfg(), device=CPU) for _ in range(2)]
    eng = ServingEngine(tables=tables, mesh=_mesh(), device=CPU)
    assert eng.num_shards == 2 and eng.backend.hm_stacked.store.pool.shape \
        == (2,) + tuple(tables[0].store.pool.shape)
    eng, gens = build_ycsb_engine(["A", "E"], slots=8, record_count=256,
                                  mesh=_mesh(4), device=CPU)
    reqs = [r for g in gens for r in g.requests(8)]
    eng.submit_all(reqs)
    snap = eng.run()
    assert snap["requests_completed"] == 16 and eng.stats()["fused_tick"]
    assert sum(hashmap.stats(hm)["live_entries"] for hm in eng.shards) >= 512


def test_device_rules():
    from repro_torch.launch.mesh import ServingMesh
    with pytest.raises(ValueError, match="mesh is on meta"):
        ServingEngine(_cfg(), mesh=ServingMesh(2, "model",
                                               torch.device("meta")),
                      device=CPU)
    with pytest.raises(ValueError, match="needs a mesh"):
        ServingEngine(_cfg(), fused_tick=True, device=CPU)
    with pytest.raises(ValueError, match="at least one shard"):
        make_serving_mesh(0, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_serving_mesh(2)                   # the card by default


@pytest.mark.parametrize("argv", [["--mesh-shards", "4"],
                                  ["--mesh-shards", "4", "--no-fused-tick",
                                   "--pipeline", "2"]])
def test_serve_cli_mesh_on_the_cpu(argv, capsys):
    from repro_torch.launch import serve
    serve.main(["--mode", "kv", "--device", CPU, "--workloads", "A,B,E",
                "--requests", "24", "--slots", "8",
                "--record-count", "256"] + argv)
    out = capsys.readouterr().out
    doc = json.loads(out[out.index("{"):])
    assert doc["requests_completed"] == 24
    eng = doc["engine"]
    assert eng["mesh_backed"] and len(eng["shards"]) == 4
    assert eng["fused_tick"] == ("--no-fused-tick" not in argv)
    calls = eng["batch_calls"]
    if eng["fused_tick"]:
        assert calls["fused_tick"] > 0 and calls["probe"] == 0
    else:
        assert calls["fused_tick"] == 0 and calls["probe"] > 0


def test_channels_demo_on_the_cpu(capsys):
    from repro_torch import channels_demo
    hm8, hm = channels_demo.main(CPU)
    assert hm8.store.pool.shape[0] == 8
    out = capsys.readouterr().out
    assert "hits+misses correct" in out and "replicated" in out
