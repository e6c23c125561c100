"""Parity of the port's HashMem ``insert`` and ``delete`` with the JAX
package's on the CPU: seeded schedules, the chain bound, an overflowed
arena, full-key deletes on bit-serial tables, and tables left unchanged."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import hashmap as jhm

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm

from model import DictModel, mine_bucket_colliding_keys
import torch_threads
from hashmap_cases import (
    CPU, _unique, assert_same_probe, assert_same_state, build_case,
    j_build, j_delete, j_insert, jcfg)

one_thread = torch_threads.one_thread

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
