"""The port's checkpointer keeps the JAX package's on-disk format: a model and
optimizer state and three HashMem tables (displaced with a stash, extendible
after a split, two shards stacked) saved by JAX and restored by the port
with equal leaves and equal probes. Exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs.base import OptimConfig as JOptimConfig
from repro.core import hashmap as jhashmap
from repro.core import rlu as jrlu

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import OptimConfig, smoke_config
from repro_torch.core import hashmap, rlu
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.launch.train import _restore_tree_shapes
from repro_torch.models import model
from repro_torch.models.layers import flatten_tree

from test_checkpoint import _displaced_cfg as _j_displaced_cfg
import torch_threads
import checkpoint_cases
from checkpoint_cases import (
    CPU, displaced_jax_table, extendible_jax_table, j_moments,
    j_table_leaves, j_train_state, port_cfg, port_moments)

jitted_jax_tables = checkpoint_cases.jitted_jax_tables

one_thread = torch_threads.one_thread


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_jax_train_state_restores_into_the_port(tmp_path, state_dtype):
    arch = "qwen3-8b"
    joc = JOptimConfig(state_dtype=state_dtype)
    from repro.configs import smoke_config as j_smoke_config
    jstate = j_train_state(j_smoke_config(arch), joc)
    JCheckpointer(str(tmp_path), async_save=False).save(3, jstate)

    cfg = smoke_config(arch)
    got = Checkpointer(str(tmp_path)).restore(
        3, _restore_tree_shapes(cfg, OptimConfig(state_dtype=state_dtype)),
        device=CPU)
    want = flatten_tree(jax.tree.map(np.asarray, jstate["params"]))
    have = flatten_tree(model.params_to_numpy(got["params"]))
    assert want.keys() == have.keys()
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], k)
    assert got["params"].embed.requires_grad
    for mom in ("m", "v"):
        w, h = j_moments(jstate["opt"][mom]), port_moments(got["opt"][mom])
        assert w.keys() == h.keys()
        for k in w:
            np.testing.assert_array_equal(h[k], w[k], f"{mom} {k}")
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 17


def port_table_leaves(hm) -> dict:
    return hashmap.to_numpy(hm)


def assert_table_equal(hm, jhm):
    have, want = port_table_leaves(hm), j_table_leaves(jhm)
    assert have.keys() == want.keys()
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], k)


def test_jax_displaced_table_restores_into_the_port(tmp_path):
    jcfg, keys, jhm = displaced_jax_table(5)
    assert int(np.asarray(jhm.store.stash_fill)) > 0
    JCheckpointer(str(tmp_path), async_save=False).save(11, jhm)

    cfg = port_cfg(jcfg)
    hm = Checkpointer(str(tmp_path)).restore(
        11, hashmap.create(cfg, CPU), device=CPU)
    assert_table_equal(hm, jhm)
    qs = np.concatenate([keys, keys + 7_000_000]).astype(np.uint32)
    jv, jf = jhashmap.probe(jhm, jnp.asarray(qs))
    v, f = hashmap.probe(hm, qs)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv).astype(np.int64))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert bool(f[:36].all())


def test_jax_extendible_table_restores_into_the_port(tmp_path):
    jhm, keys = extendible_jax_table()
    JCheckpointer(str(tmp_path), async_save=False).save(4, jhm)
    # the directory width is config-derived: restore targets the grown cfg
    cfg = port_cfg(jhm.config)
    hm = Checkpointer(str(tmp_path)).restore(
        4, hashmap.create(cfg, CPU), device=CPU)
    assert_table_equal(hm, jhm)
    st = hashmap.stats(hm)
    assert st["max_local_depth"] > st["min_local_depth"]
    qs = np.concatenate([keys, keys + 5_000_000]).astype(np.uint32)
    jv, jf = jhashmap.probe(jhm, jnp.asarray(qs))
    v, f = hashmap.probe(hm, qs)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv).astype(np.int64))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert bool(f[:20].all())


def test_jax_sharded_table_restores_as_a_stacked_port_table(tmp_path):
    """JAX restores a saved 2-shard table elastically onto a mesh; the port
    restores it as a stacked table (both shards on one device) whose
    ``probe_sharded`` answers each query as JAX's probe of its owner shard
    does, bit for bit."""
    jcfg = _j_displaced_cfg()
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(1, 1 << 30, 64).astype(np.uint32))
    vals = (keys * 3 + 1).astype(np.uint32)
    jhm = jrlu.build_sharded(jcfg, jnp.asarray(keys), jnp.asarray(vals), 2,
                             shard_by="highbits")
    JCheckpointer(str(tmp_path), async_save=False).save(1, jhm)

    cfg = port_cfg(jcfg)
    target = hashmap.stack([hashmap.create(cfg, CPU) for _ in range(2)])
    hm = Checkpointer(str(tmp_path)).restore(1, target, device=CPU)
    assert_table_equal(hm, jhm)
    qs = np.concatenate([keys, keys + 9_000_000]).astype(np.uint32)
    qs = qs[:(qs.size // 2) * 2]
    v, f = rlu.probe_sharded(make_serving_mesh(2, device=CPU), hm, qs, cfg,
                             shard_by="highbits")
    owner = np.asarray(jrlu.owner_of(jnp.asarray(qs), jcfg, 2,
                                     shard_by="highbits"))
    for d in range(2):
        m = owner == d
        shard = jax.tree.map(lambda x: x[d], jhm)
        ev, ef = jhashmap.probe(shard, jnp.asarray(qs[m]))
        np.testing.assert_array_equal(v.numpy()[m],
                                      np.asarray(ev).astype(np.int64))
        np.testing.assert_array_equal(f.numpy()[m], np.asarray(ef))
    assert f[:keys.size].all() and not f[keys.size:].any()
