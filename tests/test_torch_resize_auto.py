"""Parity of the port's ``insert_auto`` with the JAX package, then the directed
cases of ``tests/test_mutation_diff.py`` on the port: FIFO order of
duplicates across a grow, tombstones, arena exhaustion and the proactive
load-factor grow. Tolerance 0."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashmap as jhm

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm

from hashmap_cases import assert_same_state
import torch_threads
import resize_cases
from resize_cases import CPU, assert_same_probes, both, small

_jitted_jax = resize_cases._jitted_jax

one_thread = torch_threads.one_thread

INSERT_AUTO_CASES = {
    # name: (config, number of keys, max_grows)
    "reactive": (HashMemConfig(num_buckets=2, slots_per_page=32,
                               overflow_pages=2, max_chain=3, backend="ref"),
                 600, 8),
    "proactive": (HashMemConfig(num_buckets=4, slots_per_page=32,
                                overflow_pages=4, max_chain=4, backend="ref",
                                max_load_factor=0.5), 199, 8),
    "bitserial": (HashMemConfig(num_buckets=2, slots_per_page=32,
                                overflow_pages=2, max_chain=3,
                                backend="bitserial", max_load_factor=0.6),
                  300, 8),
    "budgets_run_out": (HashMemConfig(num_buckets=2, slots_per_page=32,
                                      overflow_pages=1, max_chain=2,
                                      backend="perf", max_load_factor=0.9),
                        400, 1),
    "auto_grow_off": (HashMemConfig(num_buckets=2, slots_per_page=32,
                                    overflow_pages=2, max_chain=3,
                                    backend="perf", auto_grow=False), 300, 8),
}


@pytest.mark.parametrize("case", sorted(INSERT_AUTO_CASES))
def test_insert_auto_matches_jax(case):
    """Both budgets (proactive on max_load_factor, reactive on refusals),
    the ``events`` count, and refusals left standing once a budget runs
    out or growth is off."""
    cfg, n, max_grows = INSERT_AUTO_CASES[case]
    keys = np.random.default_rng(5).choice(
        2**31, n, replace=False).astype(np.uint32)
    t, j = both(cfg)
    tev, jev = {}, {}
    t, tok = thm.insert_auto(t, keys, keys, max_grows=max_grows, events=tev)
    j, jok = jhm.insert_auto(j, jnp.asarray(keys), jnp.asarray(keys),
                             max_grows=max_grows, events=jev)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tev == jev
    assert t.config == HashMemConfig(**dataclasses.asdict(j.config))
    assert_same_state(t, j)
    ok = tok.numpy()
    if case in ("budgets_run_out", "auto_grow_off"):
        assert not ok.all()
    else:
        assert ok.all() and tev["rebuilds"] >= 1
    assert_same_probes(t, j, keys)


# ---------------------------------------------------------------------------
# The directed cases of tests/test_mutation_diff.py, through both packages
# ---------------------------------------------------------------------------
def test_insert_matches_scan_reference():
    """The vectorized insert is element-for-element the sequential
    reference on collision-heavy batches, in the port as in JAX."""
    cfg = small("bitserial")
    rng = np.random.default_rng(3)
    tv, jv = both(cfg)
    ts = thm.create(cfg, device=CPU)
    for _ in range(6):
        ks = rng.integers(0, 64, 32).astype(np.uint32)   # heavy duplication
        vs = rng.integers(1, 2**31, 32).astype(np.uint32)
        tv, ok_v = thm.insert(tv, ks, vs)
        ts, ok_s = thm.insert_scan(ts, ks, vs)
        jv, jok = jhm.insert(jv, jnp.asarray(ks), jnp.asarray(vs))
        assert torch.equal(ok_v, ok_s)
        np.testing.assert_array_equal(ok_v.numpy(), np.asarray(jok))
        a, b = thm.to_numpy(tv), thm.to_numpy(ts)
        for name in thm.leaf_names(cfg):
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        assert_same_state(tv, jv)


def test_duplicate_keys_fifo_order_across_grow():
    """Duplicates: probe returns the oldest, delete pops the oldest, and the
    order survives grow and compact."""
    t, j = both(small("perf"), np.array([42, 42, 42], np.uint32),
                np.array([1, 2, 3], np.uint32))
    t, j = thm.compact(thm.grow(t)), jhm.compact(jhm.grow(j))
    assert_same_state(t, j)
    for expect in (1, 2, 3):
        v, f = thm.probe(t, np.array([42], np.uint32))
        assert bool(f[0]) and int(v[0]) == expect
        t, fd = thm.delete(t, np.array([42], np.uint32))
        j, _ = jhm.delete(j, jnp.asarray([42], jnp.uint32))
        assert bool(fd[0])
    _, f = thm.probe(t, np.array([42], np.uint32))
    assert not bool(f[0])
    assert_same_state(t, j)


def test_tombstone_then_reinsert_then_compact():
    keys = np.arange(100, 140, dtype=np.uint32)
    t, j = both(small("bitserial"), keys, keys * 2)
    t, _ = thm.delete(t, keys)
    j, _ = jhm.delete(j, jnp.asarray(keys))
    assert thm.stats(t)["tombstones"] == 40
    t, ok = thm.insert(t, keys, keys * 5)     # appended past the tombstones
    j, _ = jhm.insert(j, jnp.asarray(keys), jnp.asarray(keys * 5))
    assert bool(ok.all())
    assert thm.stats(t)["tombstones"] == 40       # not reused (paper §2.5)
    t, j = thm.compact(t), jhm.compact(j)
    assert_same_state(t, j)
    st = thm.stats(t)
    assert st["tombstones"] == 0 and st["live_entries"] == 40
    v, f = thm.probe(t, keys)
    assert bool(f.all()) and np.array_equal(v.numpy(), keys * 5)


def test_arena_exhaustion_triggers_grow():
    """insert_auto: the refusal path becomes a resize, no dropped writes."""
    cfg = HashMemConfig(num_buckets=2, slots_per_page=32, overflow_pages=2,
                        max_chain=3, backend="ref")   # capacity 128 slots
    keys = np.random.default_rng(5).choice(
        2**31, 600, replace=False).astype(np.uint32)
    hm = thm.create(cfg, device=CPU)
    _, ok_plain = thm.insert(hm, keys, keys)
    assert not bool(ok_plain.all())
    hm, ok = thm.insert_auto(hm, keys, keys)
    assert bool(ok.all()) and hm.config.num_buckets > cfg.num_buckets
    v, f = thm.probe(hm, keys)
    assert bool(f.all()) and np.array_equal(v.numpy(), keys)
    st = thm.stats(hm)
    assert st["live_entries"] == 600 and st["max_chain"] <= hm.config.max_chain


def test_max_load_factor_proactive_grow():
    cfg = HashMemConfig(num_buckets=4, slots_per_page=32, overflow_pages=4,
                        max_chain=4, backend="ref", max_load_factor=0.5)
    keys = np.arange(1, 200, dtype=np.uint32)          # 199 > 0.5 * 256
    hm, ok = thm.insert_auto(thm.create(cfg, device=CPU), keys, keys)
    assert bool(ok.all()) and hm.config.num_buckets > 4
    assert thm.stats(hm)["load_factor"] <= 0.5
