"""Parity of the port's fingerprint lane, displacement and stash with the JAX
package: the lanes through ``empty_store``/``write_slots``/``write_keys``,
the fingerprint pre-pass (``_fp_filter``, also in blocks smaller than the
batch), ``resolve_pages_displaced``, ``stash_probe``, the displaced
insert/delete/grow/compact schedules, ``insert_scan``,
``rows_activated_per_probe`` and the fingerprint on/off ablation.  Same
numpy inputs from a seed go through both packages; every leaf (``fprints``,
``stash``, ``stash_fill`` included) and every result must be equal
(tolerance 0: all state is integer), and the ``DictModel`` oracle must
agree."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashmap as jhm
from repro.core import layout as jlayout
from repro.core.hashing import fingerprint as j_fingerprint

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm
from repro_torch.core import layout as tlayout

import fp_ablation
from model import DictModel, mine_bucket_colliding_keys
from test_torch_hashmap import assert_same_state, j_build, jcfg
import torch_threads

one_thread = torch_threads.one_thread

CPU = "cpu"
BACKENDS = ("ref", "perf", "area", "bitserial")

# the JAX functions under test, compiled once per table shape (eager JAX
# compiles every primitive anew and would dominate the file's time)
j_probe = jax.jit(lambda hm, q: jhm.probe(hm, q, backend="ref"))
j_insert = jax.jit(jhm.insert)
j_delete = jax.jit(jhm.delete)
j_grow = jax.jit(jhm.grow)
j_compact = jax.jit(jhm.compact)
j_rows = jax.jit(jhm.rows_activated_per_probe, static_argnums=2)


def dcfg(backend: str, **kw) -> HashMemConfig:
    """``tests/test_mutation_diff.py``'s ``_dcfg``: fingerprints,
    displacement and a stash on 8 buckets of 32 slots."""
    base = dict(num_buckets=8, slots_per_page=32, overflow_pages=24,
                max_chain=4, backend=backend, auto_grow=False,
                displacement=True, fingerprint_bits=8, stash_slots=16)
    base.update(kw)
    return HashMemConfig(**base)


def t32(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32))


def u32(t):
    return t.numpy().view(np.uint32)


def assert_same_probes(t, j, q):
    """Every backend the port's table has equals JAX's probe."""
    jv, jf = j_probe(j, jnp.asarray(q))
    for backend in BACKENDS if t.planes is not None else BACKENDS[:3]:
        tv, tf = thm.probe(t, q, backend=backend)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf), backend)
        np.testing.assert_array_equal(tv.numpy().astype(np.uint32),
                                      np.asarray(jv), backend)
    return np.asarray(jv), np.asarray(jf)


def assert_fprints_invariant(t):
    assert torch.equal(t.store.fprints,
                       tlayout.pack_fprints(t.key_pages, t.store.fp_bits))


def both_insert(t, j, keys, vals):
    t, tok = thm.insert(t, keys, vals)
    j, jok = j_insert(j, jnp.asarray(keys), jnp.asarray(vals))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert_same_state(t, j)
    return t, j, tok.numpy()


def both_delete(t, j, keys):
    t, tf = thm.delete(t, keys)
    j, jf = j_delete(j, jnp.asarray(keys))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert_same_state(t, j)
    return t, j, tf.numpy()


# ---------------------------------------------------------------------------
# The lanes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fp_bits", [1, 8, 12])
def test_lanes_through_empty_store_and_writes(fp_bits):
    """``empty_store`` makes the same fingerprint, stash and depth lanes;
    ``write_slots`` and ``write_keys`` (with a ``plane_pages`` override)
    keep ``fprints`` as JAX's do, writes past the pool dropped."""
    rng = np.random.default_rng(fp_bits)
    P, S = 6, 64
    t = tlayout.empty_store(P, S, 32, CPU, fp_bits=fp_bits, stash_slots=5,
                            local_depth=3)
    j = jlayout.empty_store(P, S, 32, fp_bits=fp_bits, stash_slots=5,
                            local_depth=3)
    for name in ("fprints", "stash", "stash_fill", "local_depth"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        np.testing.assert_array_equal(a.view(b.dtype), b, err_msg=name)
    assert t.fp_bits == j.fp_bits == fp_bits
    flat = rng.choice(P * S, 90, replace=False)
    pages = np.concatenate([flat // S, [P, P + 2]]).astype(np.int32)
    slots = np.concatenate([flat % S, [0, 5]]).astype(np.int32)
    keys = rng.integers(0, 2**32, 92, dtype=np.uint64).astype(np.uint32)
    t = t.write_slots(torch.from_numpy(pages), torch.from_numpy(slots),
                      t32(keys), t32(keys))
    j = j.write_slots(*map(jnp.asarray, (pages, slots, keys, keys)))
    np.testing.assert_array_equal(u32(t.fprints), np.asarray(j.fprints))
    tomb = np.full(10, 0xFFFFFFFE, np.uint32)
    pp = pages[:10].copy()
    pp[3] = P                                    # dropped from the lane only
    t = t.write_keys(torch.from_numpy(pages[:10]), torch.from_numpy(slots[:10]),
                     t32(tomb), plane_pages=torch.from_numpy(pp))
    j = j.write_keys(jnp.asarray(pages[:10]), jnp.asarray(slots[:10]),
                     jnp.asarray(tomb), plane_pages=jnp.asarray(pp))
    np.testing.assert_array_equal(u32(t.pool), np.asarray(j.pool))
    np.testing.assert_array_equal(u32(t.fprints), np.asarray(j.fprints))
    want = jlayout.pack_bitplanes(j_fingerprint(j.pool[..., 0], fp_bits),
                                  fp_bits)
    got = tlayout.pack_fprints(t.key_pages, fp_bits)
    np.testing.assert_array_equal(u32(got), np.asarray(want))


def fp_table(seed=0, fp_bits=6):
    """A chained table with fingerprints and chains in both packages."""
    cfg = HashMemConfig(num_buckets=16, slots_per_page=32, overflow_pages=16,
                        max_chain=4, fingerprint_bits=fp_bits)
    rng = np.random.default_rng(seed)
    keys = rng.choice(0xFFFFFFF0, 900, replace=False).astype(np.uint32)
    t = thm.build(cfg, keys, keys, device=CPU)
    j = j_build(jcfg(cfg), jnp.asarray(keys), jnp.asarray(keys))
    assert_same_state(t, j)
    return t, j, keys, rng


@pytest.mark.parametrize("pairs", [None, 7])
def test_fp_filter_matches_jax(pairs, monkeypatch):
    """Random (Q, 5) schedules with holes and page ids past the pool; with
    ``pairs`` the pre-pass works in blocks of 7 (query, page) pairs.  At
    fp_bits = 6 and 5 the OR over planes halves an odd count of planes."""
    t, j, keys, rng = fp_table(fp_bits=6 if pairs else 5)
    if pairs:
        monkeypatch.setattr(thm, "FP_PAIRS", pairs)
    P = t.config.num_pages
    q = np.concatenate([keys[rng.choice(900, 150)],
                        rng.choice(0xFFFFFFF0, 50).astype(np.uint32)])
    pages = rng.integers(-1, P + 3, (200, 5)).astype(np.int32)
    pages[rng.random((200, 5)) < 0.3] = -1
    got = thm._fp_filter(t.store, q, torch.from_numpy(pages))
    want = jhm._fp_filter(j.store, jnp.asarray(q), jnp.asarray(pages))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == -1).sum() > (pages == -1).sum()   # it filtered
    empty = thm._fp_filter(t.store, q[:0], torch.from_numpy(pages[:0]))
    assert empty.shape == (0, 5)


@pytest.mark.parametrize("hash_fn", ["murmur3_fmix", "identity"])
def test_resolve_pages_displaced_matches_jax(hash_fn):
    """The [H1 direct] + [H2 chain] schedule; under ``identity`` H2 == H1
    and the H2 head is blanked."""
    cfg = dcfg("perf", hash_fn=hash_fn, num_buckets=16)
    rng = np.random.default_rng(4)
    keys = rng.choice(4000, 1500, replace=False).astype(np.uint32)
    t = thm.build(cfg, keys, keys, device=CPU)
    j = j_build(jcfg(cfg), jnp.asarray(keys), jnp.asarray(keys))
    assert_same_state(t, j)
    got = thm.resolve_pages_displaced(t, keys).numpy()
    want = np.asarray(jhm.resolve_pages_displaced(j, jnp.asarray(keys)))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (1500, cfg.max_chain + 1)
    b1 = rng.integers(0, 16, 1500)
    np.testing.assert_array_equal(
        thm.resolve_pages_displaced(t, keys, torch.from_numpy(b1)).numpy(),
        np.asarray(jhm.resolve_pages_displaced(j, jnp.asarray(keys),
                                               jnp.asarray(b1))))
    if hash_fn == "identity":
        assert (got[:, 1] == -1).all()


@pytest.mark.parametrize("used", [6, 8])
def test_stash_probe_matches_jax(used):
    """Duplicates in the stash (the oldest wins), a tombstone, EMPTY slots
    (``used`` = 6) or none (``used`` = 8), and queries equal to EMPTY_KEY
    and TOMBSTONE_KEY."""
    rng = np.random.default_rng(7)
    stash = np.full((8, 2), 0xFFFFFFFF, np.uint32)
    stash[:, 1] = 0
    stash[:used, 0] = [11, 12, 11, 0xFFFFFFFE, 13, 12, 40, 11][:used]
    stash[:used, 1] = rng.integers(1, 2**32, used, dtype=np.uint64)
    q = np.array([11, 12, 13, 14, 0xFFFFFFFF, 0xFFFFFFFE, 40, 0], np.uint32)
    t = tlayout.empty_store(2, 32, 32, CPU, stash_slots=8)
    t.stash = t32(stash)
    j = dataclasses.replace(jlayout.empty_store(2, 32, 32, stash_slots=8),
                            stash=jnp.asarray(stash))
    tv, tf = thm.stash_probe(t, q)
    jv, jf = jhm.stash_probe(j, jnp.asarray(q))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy().astype(np.uint32), np.asarray(jv))
    assert tv[0] == int(stash[0, 1]) and not tf[3]
    assert bool(tf[4]) == (used < 8)


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


# ---------------------------------------------------------------------------
# Rows activated, the ablation, tables carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_fingerprints", [True, False])
def test_rows_activated_matches_jax(use_fingerprints):
    """On a displaced table with chains and a stash (one-bucket keys) and
    on a chained table with fingerprints: hits, misses and stash keys."""
    cfg = dcfg("perf", overflow_pages=8, max_chain=2)
    keys = mine_bucket_colliding_keys(72, cfg.num_buckets, same_b2=True)
    t, j = thm.create(cfg, device=CPU), jhm.create(jcfg(cfg))
    t, j, _ = both_insert(t, j, keys, keys)
    t2, j2, keys2, rng = fp_table(seed=1, fp_bits=4)
    miss = rng.choice(0xFFFFFFF0, 64).astype(np.uint32)
    for tt, jj, q in [(t, j, keys), (t, j, miss),
                      (t2, j2, np.concatenate([keys2[::3], miss]))]:
        got = thm.rows_activated_per_probe(tt, q, use_fingerprints)
        want = j_rows(jj, jnp.asarray(q), use_fingerprints)
        assert got.dtype == torch.float32
        assert float(got) == float(want)


@pytest.mark.parametrize("seed,displacement", [(0, False), (0, True),
                                               (1, False), (1, True)])
def test_fp_ablation_grid_is_bit_equal(seed, displacement):
    """``tests/fp_ablation.py``'s grid through the port: fingerprints on
    and off give equal oks, founds and probes on ``ref`` and ``perf``, and
    equal the DictModel (JAX's side of the grid is ``fp_ablation.py``)."""
    sched = fp_ablation._schedule(seed)
    oracle = fp_ablation._model_run(sched)
    for backend in ("ref", "perf"):
        off = run_port(fp_ablation._cfg(backend, 0, displacement), sched)
        on = run_port(fp_ablation._cfg(backend, 10, displacement), sched)
        assert on == off == oracle, backend


def run_port(jax_cfg, sched) -> list:
    """``fp_ablation._run`` on the port."""
    t = thm.create(HashMemConfig(**dataclasses.asdict(jax_cfg)), device=CPU)
    out = []
    for kind, ks, vs in sched:
        if kind == "grow":
            t = thm.grow(t)
        elif kind == "insert":
            t, ok = thm.insert(t, ks, vs)
            out.append(("insert", ok.tolist()))
        elif kind == "delete":
            t, f = thm.delete(t, ks)
            out.append(("delete", f.tolist()))
        else:
            v, f = thm.probe(t, ks)
            out.append(("probe", v.tolist(), f.tolist()))
    return out


def test_from_numpy_of_jax_displaced_table():
    """A displaced JAX table with stash entries crosses over leaf by leaf
    and goes on mutating as JAX's does."""
    cfg = dcfg("perf", overflow_pages=8, max_chain=2)
    keys = mine_bucket_colliding_keys(80, cfg.num_buckets, same_b2=True)
    j, _ = j_insert(jhm.create(jcfg(cfg)), jnp.asarray(keys[:76]),
                    jnp.asarray(keys[:76]))
    from test_torch_hashmap import jax_leaves
    t = thm.from_numpy(cfg, jax_leaves(j), device=CPU)
    assert_same_state(t, j)
    assert thm.stats(t)["stash_live"] == 12
    t, j, _ = both_insert(t, j, keys[76:], keys[76:])
    t, j, _ = both_delete(t, j, keys[60:70])
    assert_same_probes(t, j, keys)
    leaves = jax_leaves(j)
    del leaves["stash"]
    with pytest.raises(KeyError):                # the config needs a stash
        thm.from_numpy(cfg, leaves, device=CPU)
