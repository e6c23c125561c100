"""Parity of the port's rebuild path (``grow``, ``compact``, ``rebuild_check``,
``compact_due``) and of the per-element ``insert_scan`` with the JAX
package: same keys in, bit-equal leaves out (planes included for bit-serial
tables), equal ok masks and ``events``. Tolerance 0."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashmap as jhm

from repro_torch.core import hashmap as thm
from repro_torch.core import layout as tlayout

from hashmap_cases import assert_same_state
import torch_threads
import resize_cases
from resize_cases import assert_same_probes, both, jcfg, small

_jitted_jax = resize_cases._jitted_jax

one_thread = torch_threads.one_thread


def churned(cfg, seed=0):
    """Both tables after an insert that overflows chains and a delete of a
    quarter of the keys (duplicate queries included)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 300, 200).astype(np.uint32)
    vals = rng.integers(1, 2**32, 200, dtype=np.uint64).astype(np.uint32)
    t, j = both(cfg, keys, vals)
    dk = keys[rng.choice(200, 50)]
    t, tf = thm.delete(t, dk)
    j, jf = jhm.delete(j, jnp.asarray(dk))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert_same_state(t, j)
    return t, j, keys


@pytest.mark.parametrize("backend", ["perf", "bitserial"])
def test_grow_and_compact_match_jax(backend):
    t, j, keys = churned(small(backend, key_bits=32 if backend == "perf"
                               else 16))
    tg, jg = thm.grow(t), jhm.grow(j)
    assert tg.config == t.config.__class__(**dataclasses.asdict(jg.config))
    assert_same_state(tg, jg)
    assert thm.stats(tg)["tombstones"] == 0
    tc, jc = thm.compact(t), jhm.compact(j)
    assert_same_state(tc, jc)
    assert thm.stats(tc)["tombstones"] == 0
    assert thm.stats(tc)["live_entries"] == thm.stats(t)["live_entries"]
    t4, j4 = thm.grow(t, factor=4), jhm.grow(j, factor=4)
    assert_same_state(t4, j4)
    assert_same_probes(t4, j4, keys)
    if backend == "bitserial":
        for hm in (tg, tc, t4):
            assert torch.equal(hm.planes, tlayout.pack_bitplanes(
                hm.key_pages, hm.config.key_bits))


def test_rebuild_check_matches_jax():
    t, j, _ = churned(small("perf"))
    for new in (t.config, dataclasses.replace(t.config, num_buckets=16),
                dataclasses.replace(t.config, num_buckets=2, overflow_pages=2,
                                    max_chain=2)):
        got = thm.rebuild_check(t, new)
        want = jhm.rebuild_check(j, jcfg(new))
        assert got == want
    assert not thm.rebuild_check(t, dataclasses.replace(
        t.config, num_buckets=2, overflow_pages=2, max_chain=2))["fits"]


@pytest.mark.parametrize("chain_len", [0, 1, 4])
def test_compact_due_matches_jax(chain_len):
    """Tombstones around the 25% share of 1024 slots, with and without the
    chain trigger (the churned table has chains of 2 pages)."""
    cfg = small("perf", compact_tombstone_frac=0.25,
                compact_chain_len=chain_len)
    t, j, _ = churned(cfg)
    for tombstones in (0, 1, 256, 257):
        for kw in (dict(), dict(fraction=False), dict(chain=False)):
            assert thm.compact_due(t, tombstones, **kw) == \
                jhm.compact_due(j, tombstones, **kw), (tombstones, kw)
    assert thm.compact_due(t, 257) and not thm.compact_due(t, 0)
    assert thm.compact_due(t, 1, fraction=False) == (chain_len == 1)


@pytest.mark.parametrize("backend", ["perf", "bitserial"])
def test_insert_scan_matches_jax(backend):
    """The per-element reference, up to arena refusals: equal ok masks and
    leaves (planes included)."""
    cfg = dataclasses.replace(small(backend), overflow_pages=6)
    rng = np.random.default_rng(4)
    t, j = both(cfg)
    for _ in range(3):
        ks = rng.integers(0, 40, 120).astype(np.uint32)
        vs = rng.integers(1, 2**32, 120, dtype=np.uint64).astype(np.uint32)
        t, tok = thm.insert_scan(t, ks, vs)
        j, jok = jhm.insert_scan(j, jnp.asarray(ks), jnp.asarray(vs))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert_same_state(t, j)
    assert not tok.numpy().all()                  # the arena ran out
