"""Parity of the port's sharded build and routed host-level insert with the JAX
package's: every shard grows, splits and doubles as JAX's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import hashmap as jhm
from repro.core import rlu as jrlu

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm
from repro_torch.core import rlu as trlu

from hashmap_cases import jax_leaves, jcfg
import torch_threads
import rlu_parity_cases
from rlu_parity_cases import CPU, _keys, _small_cfg, j_build_sharded

jitted_jax_loops = rlu_parity_cases.jitted_jax_loops

one_thread = torch_threads.one_thread


def assert_same_stack(t, j):
    """Equal stacked leaves: ``hashmap.to_numpy`` of the port's stacked
    table against JAX's stacked pytree."""
    got, want = thm.to_numpy(t), jax_leaves(j)
    assert set(got) == set(want) == set(thm.leaf_names(t.config))
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("shard_by", trlu.SHARD_ROUTERS)
@pytest.mark.parametrize("displaced", [False, True], ids=["chained",
                                                          "displaced"])
def test_build_sharded_matches_jax(displaced, shard_by):
    cfg = _small_cfg(displaced)
    rng = np.random.default_rng(3)
    keys = _keys(rng, 600)
    keys[:20] = keys[20:40]                              # duplicates
    vals = rng.integers(0, 2**32, keys.size, dtype=np.uint64).astype(
        np.uint32)
    t = trlu.build_sharded(cfg, keys, vals, 3, shard_by, device=CPU)
    j = j_build_sharded(jcfg(cfg), jnp.asarray(keys), jnp.asarray(vals), 3,
                        shard_by=shard_by)
    assert t.store.pool.shape == (3, cfg.num_pages, cfg.slots_per_page, 2)
    assert_same_stack(t, j)
    for d, shard in enumerate(thm.unstack(t)):          # views of the stack
        assert shard.store.pool.data_ptr() == t.store.pool[d].data_ptr()
    back = thm.from_numpy(cfg, thm.to_numpy(t), device=CPU)
    assert_same_stack(back, j)


def test_insert_sharded_grows_every_shard_as_jax(jitted_jax_loops):
    """A batch far past every shard's capacity: all shards grow together
    (rebuild mode), as ``tests/test_distributed.py`` forces on the mesh."""
    cfg = HashMemConfig(num_buckets=4, slots_per_page=32, overflow_pages=4,
                        max_chain=3, backend="perf", auto_grow=True)
    rng = np.random.default_rng(17)
    k0 = rng.choice(2**30, 64, replace=False).astype(np.uint32)
    k1 = np.setdiff1d(rng.choice(2**30, 1500, replace=False)
                      .astype(np.uint32), k0)
    t = trlu.build_sharded(cfg, k0, k0 * 2, 4, device=CPU)
    j = j_build_sharded(jcfg(cfg), jnp.asarray(k0), jnp.asarray(k0 * 2), 4)
    tev, jev = {}, {}
    t, tok, tcfg = trlu.insert_sharded(t, k1, k1 * 2, cfg, 4, events=tev)
    j, jok, jc = jrlu.insert_sharded(j, jnp.asarray(k1), jnp.asarray(k1 * 2),
                                     jcfg(cfg), 4, events=jev)
    assert tok.numpy().all() and np.asarray(jok).all()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jc)
    assert tcfg.num_buckets > cfg.num_buckets and tev == jev
    assert tev["rebuilds"] >= 1
    assert_same_stack(t, j)


def test_insert_sharded_extendible_splits_and_doubles_as_jax(
        jitted_jax_loops):
    cfg = HashMemConfig(num_buckets=4, slots_per_page=4, overflow_pages=60,
                        max_chain=2, backend="ref", auto_grow=True,
                        resize="extendible", max_load_factor=1.0)
    rng = np.random.default_rng(9)
    keys = _keys(rng, 96)
    t = thm.stack([thm.create(cfg, device=CPU) for _ in range(2)])
    j = jax.tree.map(lambda *xs: jnp.stack(xs),
                     *[jhm.create(jcfg(cfg)) for _ in range(2)])
    tev, jev = {}, {}
    tcfg, jc = cfg, jcfg(cfg)
    for lo in range(0, keys.size, 48):
        kb = keys[lo:lo + 48]
        t, tok, tcfg = trlu.insert_sharded(t, kb, kb + 1, tcfg, 2,
                                           shard_by="highbits", events=tev)
        j, jok, jc = jrlu.insert_sharded(j, jnp.asarray(kb),
                                         jnp.asarray(kb + 1), jc, 2,
                                         shard_by="highbits", events=jev)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jc)
        assert tev == jev
        assert_same_stack(t, j)
    assert tev.get("splits", 0) > 0 and tev.get("doublings", 0) > 0, tev
    assert tev.get("rebuilds", 0) == 0, tev
