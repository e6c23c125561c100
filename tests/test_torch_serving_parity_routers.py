"""Serving parity with the JAX package: the host router against JAX's host
and device routers, a JAX-preloaded engine carried into the port through
``hashmap.from_numpy``, and the mesh engine's ``stats()`` keys."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import HashMemConfig as JaxConfig
from repro.core import rlu as jrlu
from repro import serving as jserving

from repro_torch import serving as tserving
from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm
from repro_torch.core import rlu as trlu

from hashmap_cases import jax_leaves
import serving_parity_cases
from serving_parity_cases import CPU, assert_same_tables, cfg_of
import torch_threads

one_thread = torch_threads.one_thread
jitted_jax_loops = serving_parity_cases.jitted_jax_loops


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
