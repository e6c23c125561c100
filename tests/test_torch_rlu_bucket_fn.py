"""Parity of every ``bucket_fn`` entry point of the port's hashmap with the JAX
package's, on a shard of a stacked table."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashmap as jhm
from repro.core import rlu as jrlu

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm
from repro_torch.core import rlu as trlu

from hashmap_cases import assert_same_state, jcfg
import torch_threads
import rlu_parity_cases
from rlu_parity_cases import CPU, _keys, _small_cfg, j_build_sharded

jitted_jax_loops = rlu_parity_cases.jitted_jax_loops

one_thread = torch_threads.one_thread

j_compact = jax.jit(jhm.compact, static_argnames=("bucket_fn",))
j_delete_wb = jax.jit(jhm.delete_with_buckets)
j_probe_wb = jax.jit(jhm.probe_with_buckets)
# one JAX bucket_fn per router, so the jitted calls compile once per config
J_BUCKET_FNS = {(D, r): jrlu._local_bucket_fn(D, r) for D in (2, 3)
                for r in ("mod", "highbits")}


# ---------------------------------------------------------------------------
# bucket_fn entry points of hashmap
# ---------------------------------------------------------------------------
def _shard_pair(cfg, D=3, shard_by="mod"):
    """Shard 1 of a sharded build in both packages (chained or displaced),
    with a few deletes, and the router's bucket_fn of each."""
    rng = np.random.default_rng(21)
    keys = _keys(rng, 500)
    t = trlu.build_sharded(cfg, keys, keys ^ 7, D, shard_by, device=CPU)
    j = j_build_sharded(jcfg(cfg), jnp.asarray(keys), jnp.asarray(keys ^ 7),
                        D, shard_by=shard_by)
    t = thm.unstack(t)[1]
    j = jax.tree.map(lambda x: x[1], j)
    mine = keys[trlu.owner_of_np(keys, cfg, D, shard_by) == 1]
    t, _ = thm.delete_with_buckets(
        t, mine[:9], trlu._local_bucket_fn(D, shard_by)(
            torch.from_numpy(mine[:9].astype(np.int64)), cfg))
    jfn = J_BUCKET_FNS[D, shard_by]
    j, _ = j_delete_wb(j, jnp.asarray(mine[:9]),
                       jfn(jnp.asarray(mine[:9]), jcfg(cfg)))
    return t, trlu._local_bucket_fn(D, shard_by), j, jfn, mine


@pytest.mark.parametrize("entry", ["grow", "compact", "rebuild_check",
                                   "grow_displaced", "compact_displaced",
                                   "insert_auto"])
def test_bucket_fn_rebuild_entry_points_match_jax(entry, jitted_jax_loops):
    displaced = entry.endswith("displaced")
    cfg = _small_cfg(displaced)
    if entry == "insert_auto":
        cfg = dataclasses.replace(cfg, overflow_pages=8, max_chain=2,
                                  max_load_factor=0.3)
    t, tfn, j, jfn, mine = _shard_pair(cfg)
    if entry.startswith("grow"):
        t, j = thm.grow(t, bucket_fn=tfn), jhm.grow(j, bucket_fn=jfn)
    elif entry.startswith("compact"):
        t, j = thm.compact(t, bucket_fn=tfn), j_compact(j, bucket_fn=jfn)
    elif entry == "rebuild_check":
        big = dataclasses.replace(cfg, num_buckets=8, slots_per_page=1)
        assert thm.rebuild_check(t, big, bucket_fn=tfn) \
            == jhm.rebuild_check(j, jcfg(big), bucket_fn=jfn)
        one = thm.rebuild_check(t, big, bucket_fn=lambda k, c: 0 * k)
        assert one == jhm.rebuild_check(j, jcfg(big),
                                        bucket_fn=lambda k, c: 0 * k)
        assert one["max_chain_needed"] == mine.size - 9   # all in bucket 0
        return
    else:
        rng = np.random.default_rng(4)
        new = _keys(rng, 400)
        tev, jev = {}, {}
        t, tok = thm.insert_auto(t, new, new + 3, bucket_fn=tfn, events=tev)
        j, jok = jhm.insert_auto(j, jnp.asarray(new), jnp.asarray(new + 3),
                                 bucket_fn=jfn, events=jev)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert tev == jev and tev["rebuilds"] > 0
    assert dataclasses.asdict(t.config) == dataclasses.asdict(j.config)
    assert_same_state(t, j)
    b = tfn(torch.from_numpy(mine.astype(np.int64)), t.config)
    tv, tf = thm.probe_with_buckets(t, mine, b)
    jv, jf = j_probe_wb(j, jnp.asarray(mine),
                        jfn(jnp.asarray(mine), j.config))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tf[9:].all() and not tf[:9].any()


@pytest.mark.parametrize("entry", ["split_group", "grow_extendible",
                                   "insert_extendible"])
def test_bucket_fn_extendible_entry_points_match_jax(entry,
                                                     jitted_jax_loops):
    cfg = HashMemConfig(num_buckets=4, slots_per_page=4, overflow_pages=60,
                        max_chain=2, backend="ref", resize="extendible",
                        max_load_factor=1.0)
    D, shard_by = 2, "mod"
    tfn, jfn = trlu._local_bucket_fn(D, shard_by), J_BUCKET_FNS[D, shard_by]
    rng = np.random.default_rng(2)
    keys = _keys(rng, 400)
    keys = keys[trlu.owner_of_np(keys, cfg, D, shard_by) == 0]
    b = tfn(torch.from_numpy(keys.astype(np.int64)), cfg).numpy()
    hot = keys[b == 1][:9]                     # nine keys of local bucket 1
    t, _ = thm.insert_with_buckets(thm.create(cfg, device=CPU), hot, hot,
                                   b[b == 1][:9])
    j, _ = jhm.insert_with_buckets(jhm.create(jcfg(cfg)), jnp.asarray(hot),
                                   jnp.asarray(hot),
                                   jnp.asarray(b[b == 1][:9]))
    if entry == "split_group":
        t, j = thm.double_directory(t), jhm.double_directory(j)
        (t, ts), (j, js) = (thm.split_group(t, 1, bucket_fn=tfn),
                            jhm.split_group(j, 1, bucket_fn=jfn))
        assert ts == js == "ok"
    elif entry == "grow_extendible":
        (t, th), (j, jh) = (thm.grow_extendible(t, 1, bucket_fn=tfn),
                            jhm.grow_extendible(j, 1, bucket_fn=jfn))
        assert th == jh
    else:
        tev, jev = {}, {}
        t, tok = thm.insert_extendible(t, keys[:60], keys[:60] + 1,
                                       bucket_fn=tfn, events=tev)
        j, jok = jhm.insert_extendible(j, jnp.asarray(keys[:60]),
                                       jnp.asarray(keys[:60] + 1),
                                       bucket_fn=jfn, events=jev)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert tev == jev and tev.get("splits", 0) > 0, tev
    assert dataclasses.asdict(t.config) == dataclasses.asdict(j.config)
    assert_same_state(t, j)
