"""Parity of the PyTorch port's hashing, config and workload generators with
the JAX package: every hash bit-equal over the full uint32 range, including
the reserved floor and the sentinels."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import hashmem_paper as jpaper
from repro.core import hashing as jh
from repro.data import kv_synth as jkv

from repro_torch import configs as tconfigs
from repro_torch.core import hashing as th
from repro_torch.data import kv_synth as tkv

from model import murmur3_fmix_np

SPECIAL = [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFEF,
           0xFFFFFFF0, 0xFFFFFFF1, 0xFFFFFFFD, 0xFFFFFFFE, 0xFFFFFFFF]


def _keys(n=200_000, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([np.asarray(SPECIAL, np.uint32), k])


def _t(keys):
    return th.as_u32(keys, "cpu")


def _np(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("fn", sorted(th.HASH_FNS))
@pytest.mark.parametrize("salt", [0x9E3779B9, 0, 0xFFFFFFFF, 0x68E31DA4])
def test_hash_fns_match_jax(fn, salt):
    keys = _keys()
    want = np.asarray(jh.HASH_FNS[fn](jnp.asarray(keys), salt))
    got = _np(th.HASH_FNS[fn](_t(keys), salt))
    np.testing.assert_array_equal(got, want)
    if fn == "murmur3_fmix":
        np.testing.assert_array_equal(got, murmur3_fmix_np(keys, salt))


@pytest.mark.parametrize("fn", sorted(th.HASH_FNS))
@pytest.mark.parametrize("num_buckets", [1, 3, 64, 1000, 1 << 18])
def test_hash_to_bucket_matches_jax(fn, num_buckets):
    keys = _keys(50_000, seed=num_buckets)
    want = np.asarray(jh.hash_to_bucket(jnp.asarray(keys), num_buckets, fn))
    got = th.hash_to_bucket(_t(keys), num_buckets, fn)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    want2 = np.asarray(jh.hash_to_bucket2(jnp.asarray(keys), num_buckets, fn))
    np.testing.assert_array_equal(
        th.hash_to_bucket2(_t(keys), num_buckets, fn).numpy(), want2)


def test_bucket_hash_matches_numpy_mirror():
    keys = _keys()
    want = murmur3_fmix_np(keys) % np.uint32(1 << 18)
    np.testing.assert_array_equal(
        th.hash_to_bucket(_t(keys), 1 << 18).numpy(), want)


@pytest.mark.parametrize("bits", [1, 4, 8, 16])
def test_fingerprint_and_prefix_match_jax(bits):
    keys = _keys(20_000, seed=bits)
    np.testing.assert_array_equal(
        _np(th.fingerprint(_t(keys), bits)),
        np.asarray(jh.fingerprint(jnp.asarray(keys), bits)))
    np.testing.assert_array_equal(
        th.hash_prefix(_t(keys), bits).numpy(),
        np.asarray(jh.hash_prefix(jnp.asarray(keys), bits)))


def test_as_u32_accepts_every_carrier():
    keys = _keys(1000)
    want = keys.astype(np.int64)
    for x in (keys, keys.astype(np.int64), torch.from_numpy(keys.view(np.int32)),
              torch.from_numpy(keys.astype(np.int64)),
              torch.from_numpy(keys.view(np.int32)).view(torch.uint32)):
        got = th.as_u32(x, "cpu")
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def test_sentinels_and_key_checks_match_jax():
    assert th.EMPTY_KEY == int(jh.EMPTY_KEY)
    assert th.TOMBSTONE_KEY == int(jh.TOMBSTONE_KEY)
    assert th.MAX_USER_KEY == jh.MAX_USER_KEY
    assert th.RESERVED_KEY_FLOOR == jh.RESERVED_KEY_FLOOR
    assert (th.FP_SALT, th.B2_SALT) == (jh.FP_SALT, jh.B2_SALT)
    th.validate_user_keys(np.array([0, 0xFFFFFFEF], np.uint32))
    for bad in (0xFFFFFFF0, 0xFFFFFFFF):
        keys = np.array([5, bad], np.uint32)
        with pytest.raises(ValueError) as want:
            jh.validate_user_keys(keys)
        with pytest.raises(ValueError) as got:
            th.validate_user_keys(torch.from_numpy(keys.view(np.int32)))
        assert str(got.value) == str(want.value)
    for n in (1, 2, 1 << 18):
        assert th.bits_used(n) == jh.bits_used(n)
    with pytest.raises(ValueError):
        th.bits_used(3)


def test_config_matches_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jbase.HashMemConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfigs.HashMemConfig)}
    assert tf == jf
    for name in ("PAPER_HASHMEM", "SCALED_HASHMEM"):
        assert dataclasses.asdict(getattr(tconfigs, name)) == \
            dataclasses.asdict(getattr(jpaper, name))
    assert tconfigs.PAPER_WORKLOAD == jbase.PAPER_WORKLOAD
    assert tconfigs.PAPER_HASHMEM.num_pages == jpaper.PAPER_HASHMEM.num_pages


def test_kv_synth_matches_jax():
    for n in (1000, 50_000):
        tk, tv = tkv.kv_dataset(n, seed=3)
        jk, jv = jkv.kv_dataset(n, seed=3)
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tv, jv)
        assert len(np.unique(tk)) == n and tk.max() < th.RESERVED_KEY_FLOOR
        tq, ti = tkv.probe_set(tk, 0.1)
        jq, ji = jkv.probe_set(jk, 0.1)
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_array_equal(ti, ji)
    dup = np.random.default_rng(4).integers(0, 5000, 20_000).astype(np.uint32)
    np.testing.assert_array_equal(tkv._sorted_unique(dup), np.unique(dup))
    assert tkv._sorted_unique(dup[:0]).size == 0
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(tkv._unique_keys_large(rng_t, 20_000),
                                  jkv._unique_keys_large(rng_j, 20_000))
