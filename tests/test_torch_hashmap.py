"""Parity of the port's HashMem (build, resolve, probe, insert, delete,
stats) with the JAX package on small tables.  Same keys in, bit-equal state
out: ``pool``, ``page_next``, ``page_fill``, ``free_top``, ``bucket_head``
and, for bit-serial tables, ``planes`` after every operation, equal ok/found
masks and probe results, and agreement with the ``DictModel`` oracle.
Tolerance 0 throughout (integer state)."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import HashMemConfig as JaxConfig
from repro.core import hashmap as jhm

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm
from repro_torch.core import layout as tlayout
from repro_torch.kernels.probe_perf import probe_pages_perf

from model import DictModel, mine_bucket_colliding_keys, murmur3_fmix_np
import torch_threads

one_thread = torch_threads.one_thread

CPU = "cpu"

# the JAX functions under test, compiled once per table shape
j_build = jax.jit(jhm.build, static_argnums=0)
j_probe = jax.jit(partial(jhm.probe, backend="ref"))
j_insert = jax.jit(jhm.insert)
j_delete = jax.jit(jhm.delete)


def jcfg(cfg: HashMemConfig) -> JaxConfig:
    return JaxConfig(**dataclasses.asdict(cfg))


def jax_leaves(hm) -> dict:
    out = {"pool": np.asarray(hm.store.pool),
           "page_next": np.asarray(hm.page_next),
           "page_fill": np.asarray(hm.page_fill),
           "free_top": np.asarray(hm.free_top),
           "bucket_head": np.asarray(hm.bucket_head)}
    for name in ("planes", "fprints", "stash", "stash_fill", "local_depth"):
        if getattr(hm.store, name) is not None:
            out[name] = np.asarray(getattr(hm.store, name))
    return out


def assert_same_state(thm_table, jhm_table):
    got, want = thm.to_numpy(thm_table), jax_leaves(jhm_table)
    assert set(got) == set(want) == set(thm.leaf_names(thm_table.config))
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def assert_same_probe(t, j, queries):
    tv, tf = thm.probe(t, queries)
    jv, jf = j_probe(j, jnp.asarray(queries))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy().astype(np.uint32), np.asarray(jv))
    return tv.numpy().astype(np.uint32), tf.numpy()


SMALL = HashMemConfig(num_buckets=64, slots_per_page=128, overflow_pages=64,
                      max_chain=4)


def _unique(rng, n, hi=0xFFFFFFF0):
    return rng.choice(hi, size=n, replace=False).astype(np.uint32)


def one_bucket_keys(n, num_buckets):
    """n distinct keys that share one murmur3_fmix bucket."""
    cand = np.arange(1, 1 << 21, dtype=np.uint32)
    keys = cand[murmur3_fmix_np(cand) % np.uint32(num_buckets) == 5][:n]
    assert len(keys) == n
    return keys


def build_case(name):
    """(config, keys, vals) for each build scenario."""
    rng = np.random.default_rng(BUILD_CASES.index(name))
    if name == "murmur_chains":          # ~1.1 pages/bucket: some overflow
        keys = _unique(rng, 9000)
        cfg = SMALL
    elif name == "mult_shift_skew":
        keys = (np.arange(6000, dtype=np.uint32) * np.uint32(64))
        cfg = dataclasses.replace(SMALL, hash_fn="mult_shift")
    elif name == "identity_forced_chains":   # 3 buckets take every key
        keys = (rng.choice(3000, 1500, replace=False).astype(np.uint32) * 64
                + rng.integers(0, 3, 1500).astype(np.uint32))
        cfg = dataclasses.replace(SMALL, hash_fn="identity", max_chain=8)
    elif name == "mined_one_bucket":
        keys = one_bucket_keys(300, 64)
        cfg = SMALL
    elif name == "duplicates":
        base = _unique(rng, 3000)
        keys = rng.choice(base, 8000)                # every key several times
        cfg = SMALL
    elif name == "arena_too_small":      # overflow pages and chains dropped
        keys = _unique(rng, 14000)
        cfg = dataclasses.replace(SMALL, overflow_pages=8, max_chain=3)
    else:
        raise KeyError(name)
    vals = rng.integers(0, 2**32, size=len(keys), dtype=np.uint64) \
        .astype(np.uint32)
    return cfg, keys, vals


BUILD_CASES = ["murmur_chains", "mult_shift_skew", "identity_forced_chains",
               "mined_one_bucket", "duplicates", "arena_too_small"]


@pytest.mark.parametrize("case", BUILD_CASES)
def test_build_and_probe_match_jax(case):
    cfg, keys, vals = build_case(case)
    t = thm.build(cfg, keys, vals, device=CPU)
    j = j_build(jcfg(cfg), jnp.asarray(keys), jnp.asarray(vals))
    assert_same_state(t, j)
    np.testing.assert_array_equal(
        thm.resolve_pages(t, keys).numpy(),
        np.asarray(jhm.resolve_pages(j, jnp.asarray(keys))))
    np.testing.assert_array_equal(thm.chain_lengths(t).numpy(),
                                  np.asarray(jhm.chain_lengths(j)))
    assert thm.max_chain_len(t) == jhm.max_chain_len(j)
    rng = np.random.default_rng(1)
    q = np.concatenate([keys[rng.choice(len(keys), 500)],
                        _unique(rng, 100)])
    v, f = assert_same_probe(t, j, q)
    for backend in ("perf", "ref"):
        tv, tf = thm.probe(t, q, backend=backend)
        np.testing.assert_array_equal(tf.numpy(), f)
        np.testing.assert_array_equal(tv.numpy().astype(np.uint32), v)
    ts, js = thm.stats(t), jhm.stats(j)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    assert int(thm.live_count(t)) == int(jhm.live_count(j))
    assert float(thm.load_factor(t)) == float(jhm.load_factor(j))
    tc, jc = thm.build_check(cfg, keys), jhm.build_check(jcfg(cfg), keys)
    for k in jc:
        np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)


def test_build_agrees_with_dict_model():
    cfg, keys, vals = build_case("duplicates")
    t = thm.build(cfg, keys, vals, device=CPU)
    model = DictModel()
    model.insert(keys, vals, np.ones(len(keys), bool))
    q = np.unique(keys)
    ev, ef = model.probe(q)
    v, f = thm.probe(t, q)
    np.testing.assert_array_equal(f.numpy(), ef)
    np.testing.assert_array_equal(v.numpy(), ev)


@pytest.mark.parametrize("case", ["murmur_chains", "duplicates",
                                  "arena_too_small"])
def test_bitserial_build_matches_jax(case):
    """A bit-serial table: equal leaves, planes included, and every backend
    of the port probes as JAX's bit-serial backend does."""
    cfg, keys, vals = build_case(case)
    cfg = dataclasses.replace(cfg, backend="bitserial")
    t = thm.build(cfg, keys, vals, device=CPU)
    j = j_build(jcfg(cfg), jnp.asarray(keys), jnp.asarray(vals))
    assert_same_state(t, j)
    assert torch.equal(t.planes, tlayout.pack_bitplanes(t.key_pages, 32))
    q = np.concatenate([keys[::9], _unique(np.random.default_rng(2), 100)])
    jv, jf = jhm.probe(j, jnp.asarray(q), backend="bitserial")
    for backend in ("bitserial", "ref", "perf", "area"):
        tv, tf = thm.probe(t, q, backend=backend)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tv.numpy().astype(np.uint32),
                                      np.asarray(jv))


MUT = HashMemConfig(num_buckets=8, slots_per_page=32, overflow_pages=12,
                    max_chain=3)


@pytest.mark.parametrize("seed", [0, 1])
def test_insert_delete_schedule_matches_jax(seed):
    """A seeded schedule of inserts (with and without a ``valid`` mask, up to
    chain-bound and arena refusals) and deletes (with duplicate queries):
    equal ok/found and equal leaves after every op, and the DictModel
    agrees."""
    run_insert_delete_schedule(MUT, seed)


@pytest.mark.parametrize("seed", [2])
def test_bitserial_insert_delete_schedule_matches_jax(seed):
    """The same schedule on a bit-serial table: planes stay equal to JAX's
    after every insert and delete."""
    run_insert_delete_schedule(dataclasses.replace(MUT, backend="bitserial"),
                               seed)


def run_insert_delete_schedule(cfg, seed):
    rng = np.random.default_rng(seed)
    keyspace = _unique(rng, 160, hi=100_000)
    t = thm.create(cfg, device=CPU)
    j = jhm.create(jcfg(cfg))
    model = DictModel()
    refused = 0
    for step in range(24):
        op = rng.choice(["insert", "insert_valid", "delete", "probe"],
                        p=[0.45, 0.2, 0.25, 0.1])
        if op.startswith("insert"):
            ks = rng.choice(keyspace, 48).astype(np.uint32)
            vs = rng.integers(1, 2**32, 48, dtype=np.uint64).astype(np.uint32)
            valid = rng.random(48) < 0.75 if op == "insert_valid" else None
            t, tok = thm.insert(t, ks, vs, valid=valid)
            j, jok = j_insert(j, jnp.asarray(ks), jnp.asarray(vs),
                                None if valid is None else jnp.asarray(valid))
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
            if valid is not None:
                assert not tok.numpy()[~valid].any()
            refused += int((~tok.numpy() & (valid if valid is not None
                                             else True)).sum())
            model.insert(ks, vs, tok.numpy())
        elif op == "delete":
            live = np.asarray(model.keys(), np.uint32)
            pool = np.concatenate([live, keyspace[:8]]) if live.size \
                else keyspace
            ks = rng.choice(pool, 12).astype(np.uint32)
            ks[-3:] = ks[0]                          # duplicate queries
            t, tf = thm.delete(t, ks)
            j, jf = j_delete(j, jnp.asarray(ks))
            np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
            np.testing.assert_array_equal(tf.numpy(), model.delete(ks))
        assert_same_state(t, j)
        ev, ef = model.probe(keyspace)
        v, f = assert_same_probe(t, j, keyspace)
        np.testing.assert_array_equal(f, ef)
        np.testing.assert_array_equal(v, np.asarray(ev, np.uint32))
    assert refused > 0, "schedule never hit the chain or arena bound"
    assert thm.stats(t)["tombstones"] == jhm.stats(j)["tombstones"] > 0


def test_insert_refuses_past_chain_bound():
    keys = mine_bucket_colliding_keys(40, MUT.num_buckets, same_b2=False)
    t = thm.create(MUT, device=CPU)
    j = jhm.create(jcfg(MUT))
    for lo in (0, 20):                              # 2 batches of 20
        ks = keys[lo:lo + 20]
        vs = ks + np.uint32(7)
        t, tok = thm.insert(t, ks, vs)
        j, jok = j_insert(j, jnp.asarray(ks), jnp.asarray(vs))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert_same_state(t, j)
    ok = tok.numpy()
    # 3 pages x 32 slots hold 96 of one bucket; 40 fit, none refused yet
    assert ok.all()
    big = mine_bucket_colliding_keys(120, MUT.num_buckets, same_b2=False)
    t, tok = thm.insert(t, big, big)
    j, jok = j_insert(j, jnp.asarray(big), jnp.asarray(big))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert_same_state(t, j)
    assert (~tok.numpy()).sum() > 0
    assert thm.max_chain_len(t) <= MUT.max_chain


def test_insert_after_a_build_that_overflowed_the_arena():
    """A build whose overflow arena is too small links chains to page ids
    past the pool; inserts then find tails there.  The port writes what
    JAX writes (its scatters drop those pages) and raises nothing."""
    cfg = HashMemConfig(num_buckets=64, slots_per_page=128, overflow_pages=16,
                        max_chain=3)
    rng = np.random.default_rng(1)
    keys = _unique(rng, 14_000)
    vals = rng.integers(0, 2**32, keys.size, dtype=np.uint64).astype(np.uint32)
    t = thm.build(cfg, keys[:9000], vals[:9000], device=CPU)
    j = j_build(jcfg(cfg), jnp.asarray(keys[:9000]), jnp.asarray(vals[:9000]))
    assert int(t.page_next.max()) >= cfg.num_pages
    valid = np.arange(5000) % 7 != 0
    t, tok = thm.insert(t, keys[9000:], vals[9000:], valid=valid)
    j, jok = j_insert(j, jnp.asarray(keys[9000:]), jnp.asarray(vals[9000:]),
                      jnp.asarray(valid))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert_same_state(t, j)
    assert_same_probe(t, j, keys)


def test_from_numpy_of_jax_table_matches():
    cfg, keys, vals = build_case("murmur_chains")
    j = j_build(jcfg(cfg), jnp.asarray(keys[:8000]), jnp.asarray(vals[:8000]))
    t = thm.from_numpy(cfg, jax_leaves(j), device=CPU)
    assert_same_state(t, j)
    q = np.concatenate([keys[::7], keys[8000:]])
    with pytest.raises(KeyError):                # a bit-serial table needs planes
        thm.from_numpy(dataclasses.replace(cfg, backend="bitserial"),
                       jax_leaves(j), device=CPU)
    assert_same_probe(t, j, q)
    t, tok = thm.insert(t, keys[8000:], vals[8000:])
    j, jok = j_insert(j, jnp.asarray(keys[8000:]), jnp.asarray(vals[8000:]))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    t, tf = thm.delete(t, keys[:300])
    j, jf = j_delete(j, jnp.asarray(keys[:300]))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert_same_state(t, j)
    assert_same_probe(t, j, q)
    with pytest.raises(ValueError):
        thm.from_numpy(dataclasses.replace(cfg, num_buckets=32),
                       jax_leaves(j), device=CPU)


def test_from_numpy_of_jax_bitserial_table_probes_identically():
    """A bit-serial table built by JAX at key_bits=16 crosses over with its
    planes, probes as JAX's bit-serial backend does, and mutates as JAX's
    does."""
    cfg, keys, vals = build_case("murmur_chains")
    cfg = dataclasses.replace(cfg, backend="bitserial", key_bits=16)
    j = j_build(jcfg(cfg), jnp.asarray(keys[:8000]), jnp.asarray(vals[:8000]))
    t = thm.from_numpy(cfg, jax_leaves(j), device=CPU)
    assert_same_state(t, j)
    q = np.concatenate([keys[::7], keys[8000:]])
    tv, tf = thm.probe(t, q)
    jv, jf = jhm.probe(j, jnp.asarray(q))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy().astype(np.uint32), np.asarray(jv))
    t, _ = thm.insert(t, keys[8000:], vals[8000:])
    j, _ = j_insert(j, jnp.asarray(keys[8000:]), jnp.asarray(vals[8000:]))
    t, _ = thm.delete(t, keys[:300])
    j, _ = j_delete(j, jnp.asarray(keys[:300]))
    assert_same_state(t, j)


def test_delete_compares_full_keys_on_bitserial_tables():
    """At key_bits=8 two keys equal in their low 8 bits share one bucket.
    The bit-serial compare matches either, but delete tombstones the slot
    JAX's full 32-bit compare picks, whatever the table's backend."""
    cfg = HashMemConfig(num_buckets=8, slots_per_page=32, overflow_pages=8,
                        max_chain=3, hash_fn="identity", backend="bitserial",
                        key_bits=8)
    keys = np.array([0x105, 0x205, 0x305], np.uint32)      # bucket 5, low 0x05
    vals = np.array([1, 2, 3], np.uint32)
    t, _ = thm.insert(thm.create(cfg, device=CPU), keys, vals)
    j, _ = jhm.insert(jhm.create(jcfg(cfg)), jnp.asarray(keys),
                      jnp.asarray(vals))
    v, f = thm.probe(t, keys[1:2])                 # bit-serial: slot 0 matches
    assert bool(f[0]) and int(v[0]) == 1
    t, tf = thm.delete(t, keys[1:2])
    j, jf = jhm.delete(j, jnp.asarray(keys[1:2]))
    assert bool(tf[0]) and bool(jf[0])
    assert_same_state(t, j)
    kp = thm.to_numpy(t)["pool"][5, :3, 0]
    assert kp.tolist() == [0x105, 0xFFFFFFFE, 0x305]
    v, f = thm.probe(t, keys, backend="ref")
    assert f.tolist() == [True, False, True]


def test_mutations_leave_the_old_table_unchanged():
    cfg, keys, vals = build_case("murmur_chains")
    t = thm.build(cfg, keys[:5000], vals[:5000], device=CPU)
    before = thm.to_numpy(t)
    before = {k: v.copy() for k, v in before.items()}
    thm.insert(t, keys[5000:], vals[5000:])
    thm.delete(t, keys[:100])
    after = thm.to_numpy(t)
    for name in thm.LEAVES:
        np.testing.assert_array_equal(after[name], before[name])


def test_cpu_table_never_launches_the_kernel():
    cfg, keys, vals = build_case("identity_forced_chains")
    before = probe_pages_perf.launches
    t = thm.build(cfg, keys, vals, device=CPU)
    thm.probe(t, keys)
    thm.delete(t, keys[:5])
    assert probe_pages_perf.launches == before


def test_no_device_means_the_card():
    """Entry points default to CUDA; without a card they raise instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    keys = np.arange(10, dtype=np.uint32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thm.create(SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thm.build(SMALL, keys, keys)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thm.from_numpy(SMALL, thm.to_numpy(thm.create(SMALL, device=CPU)))


@pytest.mark.parametrize("change,match", [
    (dict(resize="incremental"), "unknown resize"),
    (dict(resize="extendible", displacement=True), "extendible"),
    (dict(resize="extendible", stash_slots=32), "extendible"),
    (dict(resize="extendible", num_buckets=6), "power-of-two"),
    (dict(resize="extendible", fingerprint_bits=8, num_buckets=6),
     "power-of-two"),
])
def test_resize_knob_validation_matches_jax(change, match):
    """``create`` refuses what the JAX package's ``_check_resize`` refuses,
    with the same message; an unknown backend is refused too."""
    cfg = dataclasses.replace(SMALL, **change)
    with pytest.raises(ValueError, match=match) as t_err:
        thm.create(cfg, device=CPU)
    with pytest.raises(ValueError, match=match) as j_err:
        jhm.create(jcfg(cfg))
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError):
        thm.create(dataclasses.replace(SMALL, resize="sideways"), device=CPU)
    with pytest.raises(ValueError):
        thm.create(dataclasses.replace(SMALL, backend="cam"), device=CPU)


def test_rebuild_mode_accepts_every_lane():
    """Rebuild mode takes displacement, fingerprints and a stash, on a
    directory that is not a power of two: both packages create the same
    empty table, every lane included."""
    cfg = dataclasses.replace(SMALL, displacement=True, fingerprint_bits=8,
                              stash_slots=32, num_buckets=6)
    assert_same_state(thm.create(cfg, device=CPU), jhm.create(jcfg(cfg)))
