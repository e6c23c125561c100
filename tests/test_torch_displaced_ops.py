"""Parity of the port's displaced tables with the JAX package, op by op: the
displaced insert/delete/grow/compact schedules and ``insert_scan``. Every
leaf (``fprints``, ``stash``, ``stash_fill`` included) and every result must
be equal (tolerance 0), and the ``DictModel`` oracle must agree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashmap as jhm

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm
from repro_torch.core import layout as tlayout

from model import DictModel, mine_bucket_colliding_keys
from hashmap_cases import assert_same_state, jcfg
import torch_threads
from displaced_cases import (
    CPU, assert_same_probes, both_delete, both_insert, dcfg)

one_thread = torch_threads.one_thread

j_grow = jax.jit(jhm.grow)
j_compact = jax.jit(jhm.compact)


def assert_fprints_invariant(t):
    assert torch.equal(t.store.fprints,
                       tlayout.pack_fprints(t.key_pages, t.store.fp_bits))


# ---------------------------------------------------------------------------
# Displaced tables, op by op
# ---------------------------------------------------------------------------
OPS = np.array(["insert", "probe", "delete", "grow", "compact"])


@pytest.mark.parametrize("backend,seed", [("perf", 0), ("perf", 1),
                                          ("bitserial", 2), ("ref", 3)])
def test_dcfg_schedule_matches_jax(backend, seed):
    """The displaced sweep's schedule (``_dcfg``): inserts, probes, deletes
    with duplicate queries, grows and compacts, with equal leaves after
    every op, equal probes through every backend and the DictModel
    agreeing."""
    cfg = dcfg(backend)
    rng = np.random.default_rng(seed)
    keyspace = rng.choice(100_000, 256, replace=False).astype(np.uint32)
    t, j = thm.create(cfg, device=CPU), jhm.create(jcfg(cfg))
    model = DictModel()
    for op in rng.choice(OPS, 14, p=[0.4, 0.2, 0.25, 0.08, 0.07]):
        if op == "insert":
            ks = rng.choice(keyspace, 24).astype(np.uint32)
            vs = rng.integers(1, 2**31, 24).astype(np.uint32)
            t, j, ok = both_insert(t, j, ks, vs)
            model.insert(ks, vs, ok)
        elif op == "delete":
            live = np.asarray(model.keys(), np.uint32)
            ks = rng.choice(np.concatenate([live, keyspace[:4]]), 8) \
                .astype(np.uint32)
            ks[-2:] = ks[0]                          # duplicate queries
            t, j, found = both_delete(t, j, ks)
            np.testing.assert_array_equal(found, model.delete(ks))
        elif op == "grow" and t.config.num_buckets < 32:
            t, j = thm.grow(t), j_grow(j)
            assert_same_state(t, j)
        elif op == "compact":
            t, j = thm.compact(t), j_compact(j)
            assert_same_state(t, j)
        assert_fprints_invariant(t)
        v, f = assert_same_probes(t, j, keyspace)
        ev, ef = model.probe(keyspace)
        np.testing.assert_array_equal(f, ef)
        np.testing.assert_array_equal(v, np.asarray(ev, np.uint32))
    ts, js = thm.stats(t), jhm.stats(j)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def test_one_bucket_displacement_into_stash():
    """Keys whose H1 and H2 share one bucket: 32 land on the direct page,
    32 on the one overflow page (max_chain=2), 8 in the stash.  Deletes
    across all three classes, then a grow with stash entries live."""
    cfg = dcfg("bitserial", overflow_pages=8, max_chain=2)
    keys = mine_bucket_colliding_keys(72, cfg.num_buckets, same_b2=True)
    vals = keys * np.uint32(2) + np.uint32(1)
    t, j = thm.create(cfg, device=CPU), jhm.create(jcfg(cfg))
    t, j, ok = both_insert(t, j, keys, vals)
    assert ok.all()
    st = thm.stats(t)
    assert st["stash_live"] == 8 and st["live_entries"] == 72
    assert_same_probes(t, j, keys)
    dk = np.concatenate([keys[30:34], keys[64:68], keys[64:66]])
    t, j, found = both_delete(t, j, dk)
    assert found.all()
    st = thm.stats(t)
    assert st["stash_live"] == 4 and st["stash_tombstones"] == 4
    assert_fprints_invariant(t)
    v, f = assert_same_probes(t, j, keys)
    assert f.sum() == 64
    t, j = thm.grow(t), j_grow(j)
    assert_same_state(t, j)
    assert thm.stats(t)["tombstones"] == 0
    assert_same_probes(t, j, keys)
    assert torch.equal(t.planes, tlayout.pack_bitplanes(t.key_pages, 32))


def test_displacement_relocates_instead_of_chaining():
    """Same H1 bucket, H2 != H1: the overflow past the direct page moves to
    the H2 direct pages; no overflow page, no stash entry."""
    cfg = dcfg("perf", overflow_pages=8, max_chain=2)
    keys = mine_bucket_colliding_keys(40, cfg.num_buckets, same_b2=False)
    t, j = thm.create(cfg, device=CPU), jhm.create(jcfg(cfg))
    t, j, ok = both_insert(t, j, keys, keys + np.uint32(5))
    assert ok.all()
    assert thm.stats(t)["stash_live"] == 0
    assert int(t.free_top) == cfg.num_buckets
    assert_same_probes(t, j, keys)


@pytest.mark.parametrize("backend", ["perf", "bitserial"])
def test_displaced_grow_and_compact_match_jax(backend):
    """Grow and compact with entries in all three classes and tombstones in
    the pool and the stash: the replay (class 0, class 1, the stash) gives
    JAX's leaves, and every key keeps its value."""
    cfg = dcfg(backend, overflow_pages=8, max_chain=2)
    same = mine_bucket_colliding_keys(72, cfg.num_buckets, same_b2=True)
    rng = np.random.default_rng(11)
    keys = np.concatenate([same, rng.choice(0xFFFFFFF0, 60).astype(np.uint32)])
    t, j = thm.create(cfg, device=CPU), jhm.create(jcfg(cfg))
    t, j, ok = both_insert(t, j, keys, keys ^ np.uint32(0x5A5A))
    assert ok.all() and thm.stats(t)["stash_live"] >= 8
    t, j, _ = both_delete(t, j, np.concatenate([same[::10], same[66:68]]))
    for op in ("compact", "grow", "compact"):
        t, j = getattr(thm, op)(t), (j_compact if op == "compact"
                                     else j_grow)(j)
        assert_same_state(t, j)
        assert_fprints_invariant(t)
        assert thm.stats(t)["tombstones"] == 0
        assert_same_probes(t, j, keys)


@pytest.mark.parametrize("displacement", [False, True])
def test_duplicate_deletes_keep_fprints_on_perf_table(displacement):
    """A ``perf`` table keeps fingerprints and no planes.  Duplicate delete
    queries hit one slot; its tombstone fingerprint must be set once, as
    JAX's ``_dedup_plane_pages`` does for any table with a packed lane."""
    cfg = dcfg("perf", displacement=displacement,
               stash_slots=16 if displacement else 0)
    rng = np.random.default_rng(5)
    keys = rng.choice(0xFFFFFFF0, 150, replace=False).astype(np.uint32)
    t, j = thm.create(cfg, device=CPU), jhm.create(jcfg(cfg))
    t, j, _ = both_insert(t, j, keys, keys)
    dk = np.concatenate([keys[:20], keys[:20], keys[5:8]])
    t, j, found = both_delete(t, j, dk)
    assert found.all()
    assert t.planes is None
    assert_fprints_invariant(t)


def test_insert_scan_keeps_fprints():
    """The per-element reference insert keeps the fingerprint lane as JAX's
    ``lax.scan`` does, and matches the vectorized chained insert."""
    cfg = HashMemConfig(num_buckets=8, slots_per_page=32, overflow_pages=24,
                        max_chain=4, backend="bitserial", fingerprint_bits=8)
    rng = np.random.default_rng(3)
    t, j = thm.create(cfg, device=CPU), jhm.create(jcfg(cfg))
    tv = thm.create(cfg, device=CPU)
    for _ in range(3):
        ks = rng.integers(0, 64, 32).astype(np.uint32)
        vs = rng.integers(1, 2**31, 32).astype(np.uint32)
        t, tok = thm.insert_scan(t, ks, vs)
        j, jok = jhm.insert_scan(j, jnp.asarray(ks), jnp.asarray(vs))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert_same_state(t, j)
        tv, _ = thm.insert(tv, ks, vs)
        for name, a in thm.to_numpy(tv).items():
            np.testing.assert_array_equal(a, thm.to_numpy(t)[name], name)
    assert_fprints_invariant(t)
