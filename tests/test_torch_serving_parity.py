"""Parity of the port's serving engine with the JAX package's, on the CPU.

The same ``LoadGen`` streams (same seeds, same tenants) go through
``repro.serving.ServingEngine`` and ``repro_torch.serving.ServingEngine``
(``device="cpu"``).  For each scenario the two runs must give equal
per-request results, equal ``record_schedule`` op->tick logs, equal
deterministic metrics (every snapshot and ``stats()`` field that does not
come from a clock), equal final tables leaf by leaf, and the port's schedule
must replay against ``tests/model.py``'s ``DictModel`` seeded with the
preload.  Tolerance 0 throughout (integer state and exact counters).

Scenarios: (a) YCSB A,B,E on one shard at pipeline depth 1 and 2; (b) three
shards under both routers, with scans that span shards; (c) the
per-request baseline (``coalesce=False``); (d) an insert-heavy schedule on a
tiny table through a drain-time rebuild grow and through extendible split
repair; (e) tenant slot and pending quotas and ``kill``; (f) the ``perf``,
``area`` and ``bitserial`` backends (the JAX kernels in interpret mode).
Also: the host router against JAX's host and device routers, ``LoadGen``
streams draw for draw, a JAX-preloaded engine carried into the port through
``hashmap.from_numpy``, and the mesh engine's ``stats()`` keys.

Each scenario runs the JAX engine once, in a module-scoped fixture shared by
every assertion on it.  The JAX package's host-level loops run as they are,
with some of its module functions swapped for jitted forms while the file
runs (``insert_with_buckets`` padded to a power of two with ``valid=False``,
which writes nothing and claims nothing; ``grow``, ``compact``,
``hash_to_bucket``, ``live_count`` and ``rows_activated_per_probe`` under
``jax.jit``), since eager JAX compiles every primitive anew; the engine's
own jitted phase calls are untouched.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import HashMemConfig as JaxConfig
from repro.core import hashmap as jhm
from repro.core import rlu as jrlu
from repro import serving as jserving
from repro.serving import engine as jengine

from repro_torch import serving as tserving
from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm
from repro_torch.core import rlu as trlu

from model import (DictModel, make_insert_heavy_schedule,
                   replay_schedule_against_model)
from test_torch_hashmap import jax_leaves

CPU = "cpu"
PACKAGES = {"jax": (jserving, JaxConfig), "torch": (tserving, HashMemConfig)}

_j_iwb = jax.jit(jhm.insert_with_buckets)


def _padded_insert_with_buckets(hm, keys, vals, b, valid=None):
    n = keys.shape[0]
    m = max(8, 1 << (n - 1).bit_length())

    def pad(a, fill):
        a = jnp.asarray(a)
        return jnp.concatenate([a, jnp.full((m - n,), fill, a.dtype)])

    v = jnp.ones((n,), bool) if valid is None else jnp.asarray(valid)
    hm2, ok = _j_iwb(hm, pad(keys, 0), pad(vals, 0), pad(b, 0), pad(v, False))
    return hm2, ok[:n]


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_loops():
    jengine._jitted("probe")           # the engine's own jit of the originals
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhm, "insert_with_buckets", _padded_insert_with_buckets)
        mp.setattr(jhm, "grow", jax.jit(jhm.grow,
                                        static_argnames=("factor",
                                                         "bucket_fn")))
        mp.setattr(jhm, "compact", jax.jit(jhm.compact,
                                           static_argnames=("bucket_fn",)))
        mp.setattr(jhm, "hash_to_bucket", jax.jit(
            jhm.hash_to_bucket, static_argnames=("num_buckets", "fn",
                                                 "salt")))
        mp.setattr(jhm, "live_count", jax.jit(jhm.live_count))
        mp.setattr(jhm, "rows_activated_per_probe", jax.jit(
            jhm.rows_activated_per_probe,
            static_argnames=("use_fingerprints",)))
        yield


def cfg_of(**kw) -> dict:
    base = dict(num_buckets=64, slots_per_page=64, overflow_pages=64,
                max_chain=8, backend="ref")
    base.update(kw)
    return base


# ---------------------------------------------------------------------------
# One scenario through one package
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    eng: object
    reqs: list
    snap: dict
    model: DictModel            # the preload, folded, oldest value first
    killed: list


def run(pkg, *, workloads, record_count=256, per_tenant=12, slots=16,
        shards=1, depth=1, coalesce=True, shard_by="highbits", cfg=None,
        tenant_slots=0, tenant_pending=0, max_pending=0, seed=0,
        chain_every=8, streams=None, kill=None, trace=False):
    """Tenants (one per workload letter), each a LoadGen; the YCSB load
    phase through ``engine.preload``; then the requests (LoadGen streams,
    or ``streams`` for tenant 0) drained by ``run``.  ``kill`` =
    (tick, [request indices]): those requests are killed once the engine has
    run that many ticks."""
    ser, Config = PACKAGES[pkg]
    reg = ser.TenantRegistry()
    gens = []
    for i, wl in enumerate(workloads):
        t = reg.register(f"tenant{i}-{wl}", max_slots=tenant_slots,
                         max_pending=tenant_pending)
        gens.append(ser.LoadGen(ser.WorkloadSpec(
            wl, record_count=record_count, ops_per_request=4), t,
            seed=seed + i))
    kw = dict(num_shards=shards, max_slots=slots, max_pending=max_pending,
              tenants=reg, coalesce=coalesce, pipeline_depth=depth,
              shard_by=shard_by, record_schedule=True, trace=trace,
              metrics=ser.MetricsCollector(chain_sample_every=chain_every))
    if pkg == "torch":
        kw["device"] = CPU
    eng = ser.ServingEngine(Config(**(cfg or cfg_of())), **kw)
    model = DictModel()
    for g in gens:
        keys, vals = g.preload_kv()
        eng.preload(keys, vals, tenant=g.tenant)
        model.insert(reg.fold(g.tenant.tid, keys), vals,
                     np.ones(len(keys), bool))
    if streams is not None:
        reqs = [ser.Request(ops=list(o), tenant=gens[0].tenant)
                for o in streams]
    else:
        reqs = [r for g in gens for r in g.requests(per_tenant)]
    outcomes = [eng.submit(r) for r in reqs]
    killed = []
    if kill is not None:
        at, victims = kill
        while eng.ticks < at:
            eng.tick()
        killed = [eng.kill(reqs[i]) for i in victims]
    snap = eng.run()
    assert eng.ticks < 100_000
    return Run(eng, reqs, {**snap, "outcomes": outcomes}, model, killed)


CLOCK_KEYS = ("wall_seconds", "ops_per_sec", "request_latency_ms",
              "queue_ms", "service_ms", "tick_ms")


def det_snapshot(snap: dict) -> dict:
    """The snapshot without its clock fields; per-phase blocks keep only
    their sample counts."""
    out = {k: v for k, v in snap.items() if k not in CLOCK_KEYS}
    out["phase_ms"] = {k: v["count"] for k, v in snap["phase_ms"].items()}
    return out


def det_stats(st: dict) -> dict:
    out = dict(st)
    out["tenants"] = {name: {k: v for k, v in t.items()
                             if k not in ("queue_secs", "service_secs")}
                      for name, t in st["tenants"].items()}
    return out


def assert_same_tables(t_eng, j_eng):
    assert len(t_eng.shards) == len(j_eng.shards)
    for t, j in zip(t_eng.shards, j_eng.shards):
        assert t.config == HashMemConfig(**dataclasses.asdict(j.config))
        got, want = thm.to_numpy(t), jax_leaves(j)
        assert set(got) == set(want)
        for name in got:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)


SCENARIOS = {
    "a_ABE_depth1": dict(workloads="ABE", depth=1),
    "a_ABE_depth2": dict(workloads="ABE", depth=2),
    "b_3shards_mod": dict(workloads="EA", shards=3, shard_by="mod",
                          per_tenant=16),
    "b_3shards_highbits": dict(workloads="EA", shards=3,
                               shard_by="highbits", per_tenant=16),
    "c_per_request": dict(workloads="AF", coalesce=False, per_tenant=8),
    "d_insert_heavy_rebuild": dict(
        workloads="A", record_count=16, slots=8, depth=2,
        cfg=cfg_of(num_buckets=4, slots_per_page=8, overflow_pages=4,
                   max_chain=2, auto_grow=True),
        streams=make_insert_heavy_schedule(4, n_requests=16, keyspace=96)),
    "d_insert_heavy_extendible": dict(
        workloads="A", record_count=16, slots=8, depth=2,
        cfg=cfg_of(num_buckets=4, slots_per_page=8, overflow_pages=28,
                   max_chain=2, auto_grow=True, resize="extendible",
                   max_load_factor=1.0),
        streams=make_insert_heavy_schedule(4, n_requests=16, keyspace=96)),
    "e_quotas_kill": dict(workloads="AFD", slots=6, tenant_slots=2,
                          tenant_pending=5, max_pending=12, per_tenant=8,
                          depth=2, kill=(3, [1, 2, 17])),
    "f_perf": dict(workloads="BF", cfg=cfg_of(backend="perf")),
    "f_area": dict(workloads="BF", cfg=cfg_of(backend="area")),
    "f_bitserial": dict(workloads="BF", cfg=cfg_of(backend="bitserial")),
}


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def scenario(request):
    kw = SCENARIOS[request.param]
    return request.param, run("jax", **kw), run("torch", **kw)


def test_results_equal(scenario):
    name, j, t = scenario
    assert [r.results for r in t.reqs] == [r.results for r in j.reqs], name
    assert t.killed == j.killed
    assert t.snap["outcomes"] == j.snap["outcomes"]


def test_schedule_equal(scenario):
    name, j, t = scenario
    assert t.eng.schedule == j.eng.schedule, name
    assert t.eng.schedule, name


def test_deterministic_metrics_equal(scenario):
    name, j, t = scenario
    assert det_snapshot(t.snap) == det_snapshot(j.snap), name
    assert det_stats(t.eng.stats()) == det_stats(j.eng.stats()), name


def test_tables_equal(scenario):
    name, j, t = scenario
    assert_same_tables(t.eng, j.eng)


def test_schedule_replays_against_dict_model(scenario):
    name, j, t = scenario
    replay_schedule_against_model(t.eng.schedule, t.model)


def test_scenarios_exercise_their_paths(scenario):
    """Each scenario reaches what it is named for, on both engines."""
    name, j, t = scenario
    st = t.eng.stats()
    if name.startswith("a_ABE_depth2"):
        assert st["pipeline"]["depth"] == 2
    if name.startswith("b_"):
        scans = [e for e in t.eng.schedule if e[1] == "scan"]
        owners = [set(trlu.owner_of_np(np.asarray(e[2], np.uint32),
                                       t.eng.shards[0].config, 3,
                                       t.eng.shard_by)) for e in scans]
        assert any(len(o) > 1 for o in owners), "no scan spans shards"
        assert max(st["batch_calls"].values()) > t.eng.ticks
    if name == "c_per_request":
        assert st["batch_calls"]["probe"] == t.snap["op_counts"]["read"] \
            + t.snap["op_counts"]["rmw"]
    if name == "d_insert_heavy_rebuild":
        assert st["grow_events"] >= 1
    if name == "d_insert_heavy_extendible":
        assert st["split_events"] >= 1 and st["grow_events"] == 0
    if name == "e_quotas_kill":
        assert t.killed.count(True) >= 2
        assert st["killed_requests"] == j.eng.stats()["killed_requests"]
        assert "rejected" in t.snap["outcomes"]
        assert t.snap["outcomes"].count("queued") > 0
    if name.startswith("f_"):
        assert t.eng.shards[0].config.backend == name[2:]


# ---------------------------------------------------------------------------
# Router, load generator, state carried across, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hash_fn", ["murmur3_fmix", "mult_shift", "identity"])
@pytest.mark.parametrize("shard_by", ["mod", "highbits"])
def test_owner_of_np_equals_jax_routers(hash_fn, shard_by):
    rng = np.random.default_rng(11)
    keys = np.concatenate([
        rng.integers(0, 2**32, 20_000, dtype=np.uint64).astype(np.uint32),
        np.arange(0xFFFFFFF0, 0x100000000, dtype=np.uint64).astype(np.uint32),
        np.asarray([0, 1, 2**31 - 1, 2**31], np.uint32)])
    tc = HashMemConfig(hash_fn=hash_fn)
    jc = JaxConfig(hash_fn=hash_fn)
    for d in (1, 3, 4, 7):
        got = trlu.owner_of_np(keys, tc, d, shard_by)
        np.testing.assert_array_equal(got, jrlu.owner_of_np(keys, jc, d,
                                                            shard_by))
        np.testing.assert_array_equal(
            got, np.asarray(jrlu.owner_of(jnp.asarray(keys), jc, d,
                                          shard_by)))
    assert trlu.ROUTE_PAD == jrlu.ROUTE_PAD
    assert trlu.SHARD_ROUTERS == jrlu.SHARD_ROUTERS


def _stream(ser, wl, record_count, n, spec_kw=None):
    g = ser.LoadGen(ser.WorkloadSpec(wl, record_count=record_count,
                                     **(spec_kw or {})), seed=3)
    kv = g.preload_kv()
    return [r.ops for r in g.requests(n)], kv, g.insert_point, g._zipf_n


@pytest.mark.parametrize("record_count", [1024, 100_000])
@pytest.mark.parametrize("wl", list("ABCDEF"))
def test_loadgen_streams_equal_jax(wl, record_count):
    t = _stream(tserving, wl, record_count, 48)
    j = _stream(jserving, wl, record_count, 48)
    assert t[0] == j[0]
    for a, b in zip(t[1], j[1]):
        np.testing.assert_array_equal(a, b)
    assert t[2:] == j[2:]


@pytest.mark.parametrize("record_count", [1024, 100_000])
def test_loadgen_recache_point_equal_jax(record_count):
    """An insert-heavy "latest" stream grows the key range past 1.25x the
    cached size, so the zipfian weights (and the port's CDF) are rebuilt
    mid-stream; the draws stay equal across it."""
    n_req = record_count // 3 // 4 + 8          # > 25% of the range inserted
    spec = dict(mix={"insert": 0.96, "read": 0.04}, ops_per_request=4)
    t = _stream(tserving, "D", record_count, n_req, spec)
    j = _stream(jserving, "D", record_count, n_req, spec)
    assert t[2] > record_count * 1.25
    assert t[3] > record_count                  # re-cached
    assert t[0] == j[0] and t[2:] == j[2:]


def test_jax_preloaded_tables_carry_into_the_port():
    """An engine preloaded and half-served in JAX hands its tables to the
    port through ``hashmap.from_numpy``; both then serve the rest of the
    stream with equal results and end with equal tables."""
    def tenants_and_requests(ser):
        reg = ser.TenantRegistry()
        gens = [ser.LoadGen(ser.WorkloadSpec(wl, record_count=256),
                            reg.register(f"t{wl}"), seed=i)
                for i, wl in enumerate("AD")]
        reqs = [r for g in gens for r in g.requests(16)]
        return reg, gens, reqs

    jreg, jgens, jreqs = tenants_and_requests(jserving)
    je = jserving.ServingEngine(JaxConfig(**cfg_of()), num_shards=2,
                                max_slots=8, tenants=jreg)
    jserving.preload_engine(je, jgens)
    je.submit_all(jreqs[:16])
    je.run()

    treg, _, treqs = tenants_and_requests(tserving)
    tables = [thm.from_numpy(HashMemConfig(**dataclasses.asdict(s.config)),
                             jax_leaves(s), device=CPU) for s in je.shards]
    te = tserving.ServingEngine(tables=tables, max_slots=8, tenants=treg,
                                device=CPU)
    assert [r.ops for r in treqs] == [r.ops for r in jreqs]
    je.submit_all(jreqs[16:])
    te.submit_all(treqs[16:])
    je.run()
    te.run()
    assert [r.results for r in treqs[16:]] == [r.results for r in jreqs[16:]]
    assert_same_tables(te, je)


def test_mesh_engine_stats_have_the_jax_keys():
    """``build_ycsb_engine(mesh=)`` serves from stacked shards, and the mesh
    and host engines report the JAX engine's ``stats()`` keys."""
    from repro_torch.launch.mesh import make_serving_mesh
    eng, gens = tserving.build_ycsb_engine(
        ["A", "B"], mesh=make_serving_mesh(2, device=CPU), device=CPU)
    eng.submit_all([r for g in gens for r in g.requests(8)])
    snap = eng.run()
    st = eng.stats()
    assert snap["requests_completed"] == 16
    assert st["mesh_backed"] and st["fused_tick"] and st["route_caps"]
    assert st["route_cap_totals"]["launches"] == st["batch_calls"][
        "fused_tick"] > 0
    assert set(st) == set(jserving.ServingEngine().stats())
    host = tserving.ServingEngine(fused_tick=False, device=CPU).stats()
    assert not host["mesh_backed"] and not host["fused_tick"]
    assert host["route_caps"] == [] and set(host) == set(st)
