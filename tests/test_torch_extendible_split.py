"""Parity of the port's extendible resize with the JAX package: the cases of
``tests/test_extendible.py`` on ``double_directory`` as a pointer copy,
``split_group``'s four statuses and its locality, splits instead of
rebuilds, FIFO order across splits, a rebuild resetting the directory, and a
JAX table carried in. Tolerance 0; the JAX side is set out in
``tests/extendible_cases.py``."""
import dataclasses

import jax.numpy as jnp
import numpy as np

from repro.core import hashmap as jhm
from repro.core.hashing import hash_to_bucket as j_hash

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm
from repro_torch.core.hashing import bits_used

from model import mine_bucket_colliding_keys
from hashmap_cases import jcfg
import torch_threads
import extendible_cases
from extendible_cases import (
    CPU, assert_same, both, both_insert, ecfg, j_delete, probe_both)

jitted_jax_loops = extendible_cases.jitted_jax_loops

one_thread = torch_threads.one_thread


def bucket_of(keys, cfg):
    return int(np.asarray(j_hash(jnp.asarray(keys), cfg.num_buckets,
                                 cfg.hash_fn, cfg.salt))[0])


# ---------------------------------------------------------------------------
# Directory doubling
# ---------------------------------------------------------------------------
def test_double_directory_is_pointer_copy():
    cfg = ecfg()
    keys = np.arange(1, 33, dtype=np.uint32)
    t, j = both(cfg)
    t, j, ok, _ = both_insert(t, j, keys, keys * 3)
    assert ok.all()
    t2, j2 = thm.double_directory(t), jhm.double_directory(j)
    assert_same(t2, j2)
    assert t2.config.num_buckets == 2 * cfg.num_buckets
    assert t2.config.num_pages == cfg.num_pages
    assert t2.store is t.store                     # no data moves
    st = thm.stats(t2)
    assert st["global_depth"] == bits_used(cfg.num_buckets) + 1
    assert st["max_local_depth"] == bits_used(cfg.num_buckets)
    v, f = probe_both(t2, j2, keys)
    assert f.all() and (v == keys * 3).all()
    small = ecfg(num_buckets=16, overflow_pages=8)
    assert thm.double_directory(thm.create(small, device=CPU)) is None
    assert jhm.double_directory(jhm.create(jcfg(small))) is None


def test_extendible_table_crosses_over_from_jax():
    """An extendible JAX table whose groups have split crosses over leaf by
    leaf (``local_depth`` included) and goes on splitting as JAX's does."""
    cfg = ecfg(max_chain=2)
    keys = mine_bucket_colliding_keys(30, cfg.num_buckets, same_b2=False)
    vals = np.arange(1, 31, dtype=np.uint32)
    j, _ = jhm.insert_extendible(jhm.create(jcfg(cfg)), jnp.asarray(keys[:16]),
                                 jnp.asarray(vals[:16]))
    from hashmap_cases import jax_leaves
    cfg2 = HashMemConfig(**dataclasses.asdict(j.config))
    t = thm.from_numpy(cfg2, jax_leaves(j), device=CPU)
    assert_same(t, j)
    assert thm.stats(t)["max_local_depth"] > bits_used(cfg.num_buckets)
    t, j, ok, _ = both_insert(t, j, keys[16:], vals[16:], "insert_extendible")
    assert ok.all()
    assert_same(t, j)
    v, f = probe_both(t, j, keys)
    assert f.all() and (v == vals).all()


# ---------------------------------------------------------------------------
# split_group: statuses and locality
# ---------------------------------------------------------------------------
def test_split_group_statuses_and_locality():
    cfg = ecfg(max_chain=2, overflow_pages=56)
    t, j = both(cfg)
    t1, status = thm.split_group(t, 0)
    assert status == jhm.split_group(j, 0)[1] == "need_double" and t1 is t

    keys = mine_bucket_colliding_keys(8, cfg.num_buckets, same_b2=False)
    vals = np.arange(1, 9, dtype=np.uint32) * 7
    t, j, ok, _ = both_insert(t, j, keys, vals)
    assert ok.all()
    b0 = bucket_of(keys, cfg)
    t, j = thm.double_directory(t), jhm.double_directory(j)
    heads_before = t.bucket_head.numpy().copy()
    pool_before = thm.to_numpy(t)["pool"].copy()
    ld = bits_used(cfg.num_buckets)
    c = b0 & ((1 << ld) - 1)
    old_pages, p = [], int(heads_before[c])
    pn = t.page_next.numpy()
    while p >= 0:
        old_pages.append(p)
        p = int(pn[p])
    top_before = int(t.free_top)

    t2, status = thm.split_group(t, b0)
    j2, jstatus = jhm.split_group(j, b0)
    assert status == jstatus == "ok"
    assert_same(t2, j2)
    # only the split group's directory aliases were repointed
    gd = bits_used(t2.config.num_buckets)
    aliases = c + (np.arange(1 << (gd - ld)) << ld)
    untouched = np.setdiff1d(np.arange(t2.config.num_buckets), aliases)
    np.testing.assert_array_equal(t2.bucket_head.numpy()[untouched],
                                  heads_before[untouched])
    ch = t2.bucket_head.numpy()[aliases]
    np.testing.assert_array_equal(t2.store.local_depth.numpy()[ch], ld + 1)
    # every other group's pages are bit-identical: the split is local
    touched = set(old_pages) | set(range(top_before, int(t2.free_top)))
    other = np.setdiff1d(np.arange(cfg.num_pages), sorted(touched))
    np.testing.assert_array_equal(thm.to_numpy(t2)["pool"][other],
                                  pool_before[other])
    v, f = probe_both(t2, j2, keys)
    assert f.all() and (v == vals).all()


def test_split_group_stuck_full_and_rebuild_fallback():
    cfg = ecfg(max_chain=2, overflow_pages=56)
    keys = mine_bucket_colliding_keys(8, 64, same_b2=False)
    t, j = both(cfg)
    t, j, ok, _ = both_insert(t, j, keys, np.arange(1, 9, dtype=np.uint32))
    assert ok.all()
    b0 = bucket_of(keys, cfg)
    t, j = thm.double_directory(t), jhm.double_directory(j)

    tight_t = thm.HashMem(store=t.store, bucket_head=t.bucket_head,
                          config=dataclasses.replace(t.config, max_chain=1))
    tight_j = jhm.HashMem(store=j.store, bucket_head=j.bucket_head,
                          config=dataclasses.replace(j.config, max_chain=1))
    assert thm.split_group(tight_t, b0)[1] == "stuck"
    assert jhm.split_group(tight_j, b0)[1] == "stuck"

    full_t = thm.HashMem(store=dataclasses.replace(
        t.store, free_top=t.free_top.new_tensor(cfg.num_pages)),
        bucket_head=t.bucket_head, config=t.config)
    full_j = jhm.HashMem(store=dataclasses.replace(
        j.store, free_top=jnp.asarray(cfg.num_pages, jnp.int32)),
        bucket_head=j.bucket_head, config=j.config)
    assert thm.split_group(full_t, b0)[1] == "full"
    assert jhm.split_group(full_j, b0)[1] == "full"

    t2, how = thm.grow_extendible(full_t, b0)
    j2, jhow = jhm.grow_extendible(full_j, b0)
    assert how == jhow == "rebuild"
    assert_same(t2, j2)
    assert t2.config.num_pages > cfg.num_pages
    assert probe_both(t2, j2, keys)[1].all()


# ---------------------------------------------------------------------------
# insert_extendible: splits instead of rebuilds; FIFO order survives
# ---------------------------------------------------------------------------
def test_insert_extendible_splits_not_rebuilds():
    cfg = ecfg(max_chain=2)
    keys = mine_bucket_colliding_keys(24, cfg.num_buckets, same_b2=False)
    vals = np.arange(1, 25, dtype=np.uint32)
    t, j = both(cfg)
    t, j, ok, events = both_insert(t, j, keys, vals, "insert_extendible")
    assert ok.all()
    assert events.get("splits", 0) >= 1 and events.get("rebuilds", 0) == 0
    assert_same(t, j)
    assert t.config.num_pages == cfg.num_pages
    v, f = probe_both(t, j, keys)
    assert f.all() and (v == vals).all()
    assert thm.stats(t)["max_local_depth"] > bits_used(cfg.num_buckets)


def test_duplicate_fifo_order_survives_splits():
    cfg = ecfg(max_chain=2)
    keys = mine_bucket_colliding_keys(20, cfg.num_buckets, same_b2=False)
    dup = keys[:1]
    t, j = both(cfg)
    t, j, _, _ = both_insert(t, j, dup, np.array([111], np.uint32))
    t, j, ok, _ = both_insert(t, j, keys[1:], np.arange(1, 20, dtype=np.uint32),
                              "insert_extendible")
    t, j, ok2, _ = both_insert(t, j, dup, np.array([222], np.uint32),
                               "insert_extendible")
    assert ok.all() and ok2.all()
    assert_same(t, j)
    v, f = probe_both(t, j, dup)
    assert f[0] and v[0] == 111                       # the oldest wins
    t, tf = thm.delete(t, dup)
    j, jf = j_delete(j, jnp.asarray(dup))
    assert bool(tf[0]) and bool(jf[0])
    assert_same(t, j)
    v, f = probe_both(t, j, dup)
    assert f[0] and v[0] == 222                       # its FIFO successor


def test_rebuild_under_extendible_resets_directory_and_reclaims():
    cfg = ecfg(max_chain=2)
    keys = mine_bucket_colliding_keys(24, cfg.num_buckets, same_b2=False)
    t, j = both(cfg)
    t, j, ok, _ = both_insert(t, j, keys, np.arange(1, 25, dtype=np.uint32),
                              "insert_extendible")
    assert ok.all()
    t2, j2 = thm.compact(t), jhm.compact(j)
    assert_same(t2, j2)
    st = thm.stats(t2)
    assert st["min_local_depth"] == st["max_local_depth"] \
        == st["global_depth"]
    needed = int(np.maximum(st["chain_lengths"] - 1, 0).sum())
    assert st["free_pages"] == \
        t2.config.num_pages - t2.config.num_buckets - needed
    assert probe_both(t2, j2, keys)[1].all()
