"""Parity of the port's bit-plane lane (``repro_torch.core.layout``) with the
JAX package's: packing, unpacking, the batched incremental update, and the
PageStore writes that keep the planes in step with the key lane.  Inputs
come from numpy with a seed; every comparison is exact (tolerance 0, all
state is integer)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as jlayout
from repro.core.hashing import TOMBSTONE_KEY

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm
from repro_torch.core import layout as tlayout
from repro_torch.kernels import ops

import torch_threads

one_thread = torch_threads.one_thread


def t32(a):
    """numpy uint32 -> int32 tensor with the same bits."""
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def u32(t):
    return t.numpy().view(np.uint32)


def rand_keys(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("key_bits", [4, 8, 16, 32])
def test_pack_unpack_match_jax(key_bits):
    rng = np.random.default_rng(key_bits)
    kp = rand_keys(rng, (12, 96))
    kp[0, :5] = [0xFFFFFFFF, 0xFFFFFFFE, 0, 1, 0x80000000]
    want = np.asarray(jlayout.pack_bitplanes(jnp.asarray(kp), key_bits))
    got = tlayout.pack_bitplanes(t32(kp), key_bits)
    assert got.dtype == torch.int32 and got.shape == (12, key_bits, 3)
    np.testing.assert_array_equal(u32(got), want)
    back = tlayout.unpack_bitplanes(got, key_bits)
    np.testing.assert_array_equal(
        u32(back), np.asarray(jlayout.unpack_bitplanes(jnp.asarray(want),
                                                       key_bits)))
    mask = np.uint32(0xFFFFFFFF if key_bits == 32 else (1 << key_bits) - 1)
    np.testing.assert_array_equal(u32(back), kp & mask)      # round trip
    assert torch.equal(ops.bitplane_rebuild(t32(kp), key_bits), got)


def test_pack_in_page_blocks_matches_whole(monkeypatch):
    rng = np.random.default_rng(3)
    kp = t32(rand_keys(rng, (37, 64)))
    whole = tlayout.pack_bitplanes(kp, 32)
    monkeypatch.setattr(tlayout, "PACK_BYTES", 5 * 64 * 32 * 8)   # 5 pages
    assert torch.equal(tlayout.pack_bitplanes(kp, 32), whole)


@pytest.mark.parametrize("key_bits", [4, 8, 16, 32])
@pytest.mark.parametrize("oob", [0, 6])
def test_update_matches_jax(key_bits, oob):
    """Unique in-range (page, slot) writes, several per word, plus writes to
    page ids past the pool (dropped)."""
    rng = np.random.default_rng(10 * key_bits + oob)
    P, S, B = 9, 128, 70
    planes = np.asarray(jlayout.pack_bitplanes(
        jnp.asarray(rand_keys(rng, (P, S))), key_bits))
    flat = rng.choice(P * S, B, replace=False)
    pages = np.concatenate([flat // S, P + rng.integers(0, 3, oob)])
    slots = np.concatenate([flat % S, rng.integers(0, S, oob)])
    pages, slots = pages.astype(np.int32), slots.astype(np.int32)
    keys = rand_keys(rng, B + oob)
    want = np.asarray(jlayout.update_bitplanes_batch(
        jnp.asarray(planes), jnp.asarray(pages), jnp.asarray(slots),
        jnp.asarray(keys), key_bits))
    before = t32(planes)
    got = ops.bitplane_update(before, torch.from_numpy(pages),
                              torch.from_numpy(slots), t32(keys), key_bits)
    np.testing.assert_array_equal(u32(got), want)
    np.testing.assert_array_equal(u32(before), planes)       # not in place


def test_update_with_no_writes_in_range():
    planes = t32(np.full((2, 8, 2), 0x5A5A5A5A, np.uint32))
    got = tlayout.update_bitplanes_batch(
        planes, torch.tensor([2, 5], dtype=torch.int32),
        torch.tensor([1, 2], dtype=torch.int32), t32(np.array([1, 2])), 8)
    assert torch.equal(got, planes)


def _writes(rng, P, S, B, oob=0):
    """The ``tests/test_pagestore.py`` write sets: B unique (page, slot)
    targets and ``oob`` out-of-range pages at the end."""
    flat = rng.choice(P * S, size=B, replace=False)
    pages = (flat // S).astype(np.int32)
    slots = (flat % S).astype(np.int32)
    if oob:
        pages = np.concatenate([pages, np.full(oob, P, np.int32)])
        slots = np.concatenate([slots, np.zeros(oob, np.int32)])
    keys = rng.integers(0, 2**31, pages.size).astype(np.uint32)
    vals = rng.integers(0, 2**31, pages.size).astype(np.uint32)
    return pages, slots, keys, vals


def _stores(P=8, S=64, key_bits=32):
    return (tlayout.empty_store(P, S, key_bits, "cpu", with_planes=True),
            jlayout.empty_store(P, S, key_bits, with_planes=True))


def assert_same_store(t, j):
    np.testing.assert_array_equal(u32(t.pool), np.asarray(j.pool))
    np.testing.assert_array_equal(u32(t.planes), np.asarray(j.planes))


@pytest.mark.parametrize("key_bits", [8, 32])
def test_empty_store_planes_match_jax(key_bits):
    t, j = _stores(P=5, S=96, key_bits=key_bits)
    assert t.planes.shape == (5, key_bits, 3)
    assert_same_store(t, j)
    assert tlayout.empty_store(5, 96, device="cpu").planes is None


@pytest.mark.parametrize("key_bits", [8, 32])
def test_write_slots_keeps_planes_as_jax(key_bits):
    """The fused write against independent key/value scatters, and planes
    against JAX's and against the planes of the written key lane."""
    rng = np.random.default_rng(key_bits)
    t, j = _stores(key_bits=key_bits)
    pages, slots, keys, vals = _writes(rng, 8, 64, 48, oob=4)
    tout = t.write_slots(torch.from_numpy(pages), torch.from_numpy(slots),
                         t32(keys), t32(vals))
    jout = j.write_slots(*map(jnp.asarray, (pages, slots, keys, vals)))
    assert_same_store(tout, jout)
    want_k = np.asarray(j.key_pages.at[pages, slots].set(keys, mode="drop"))
    want_v = np.asarray(j.val_pages.at[pages, slots].set(vals, mode="drop"))
    np.testing.assert_array_equal(u32(tout.key_pages), want_k)
    np.testing.assert_array_equal(u32(tout.val_pages), want_v)
    assert torch.equal(tout.planes,
                       tlayout.pack_bitplanes(tout.key_pages, key_bits))
    np.testing.assert_array_equal(u32(t.planes), np.asarray(j.planes))


def test_write_keys_tombstones_keep_planes():
    """Tombstone writes rewrite the key lane only, and the planes follow;
    the ``plane_pages`` override drops duplicate targets from the plane
    update as delete does."""
    rng = np.random.default_rng(2)
    t, j = _stores()
    pages, slots, keys, vals = _writes(rng, 8, 64, 32)
    t = t.write_slots(torch.from_numpy(pages), torch.from_numpy(slots),
                      t32(keys), t32(vals))
    j = j.write_slots(*map(jnp.asarray, (pages, slots, keys, vals)))
    tomb = np.full(8, TOMBSTONE_KEY, np.uint32)
    tout = t.write_keys(torch.from_numpy(pages[:8]),
                        torch.from_numpy(slots[:8]), t32(tomb))
    jout = j.write_keys(jnp.asarray(pages[:8]), jnp.asarray(slots[:8]),
                        jnp.asarray(tomb))
    assert_same_store(tout, jout)
    np.testing.assert_array_equal(u32(tout.val_pages), u32(t.val_pages))
    np.testing.assert_array_equal(
        u32(tlayout.unpack_bitplanes(tout.planes, 32)), u32(tout.key_pages))
    # duplicate targets: the second copy of each is dropped from the planes
    dp = np.concatenate([pages[:4], pages[:4]])
    ds = np.concatenate([slots[:4], slots[:4]])
    plane_pages = np.where(np.arange(8) < 4, dp, 8).astype(np.int32)
    tout = t.write_keys(torch.from_numpy(dp), torch.from_numpy(ds),
                        t32(tomb), plane_pages=torch.from_numpy(plane_pages))
    jout = j.write_keys(jnp.asarray(dp), jnp.asarray(ds), jnp.asarray(tomb),
                        plane_pages=jnp.asarray(plane_pages))
    assert_same_store(tout, jout)
    assert torch.equal(tout.planes, tlayout.pack_bitplanes(tout.key_pages, 32))


@pytest.mark.parametrize("fn", ["pack", "empty", "create"])
def test_slots_not_multiple_of_32_raise(fn):
    with pytest.raises(ValueError, match="multiple of 32"):
        if fn == "pack":
            tlayout.pack_bitplanes(t32(np.zeros((4, 40), np.uint32)), 32)
        elif fn == "empty":
            tlayout.empty_store(4, 40, 32, "cpu", with_planes=True)
        else:
            thm.create(HashMemConfig(num_buckets=4, slots_per_page=40,
                                     overflow_pages=4, backend="bitserial"),
                       device="cpu")


def test_plane_width_must_match_key_bits():
    planes = t32(np.zeros((4, 8, 2), np.uint32))
    with pytest.raises(ValueError, match="planes hold 8 bits"):
        tlayout.update_bitplanes_batch(planes, [0], [0], [1], key_bits=16)
    with pytest.raises(ValueError, match="planes hold 8 bits"):
        tlayout.unpack_bitplanes(planes, 32)


@pytest.mark.parametrize("write", ["slots", "keys"])
def test_wrapped_and_out_of_range_ids_match_jax(write):
    """JAX's ``mode="drop"`` scatters index by NumPy's rule: a page in
    [-P, -1] wraps to P + id, a slot in [-S, -1] to S + id, and any other
    id out of range drops the write.  Pool, planes and fingerprints must
    follow it, for ``write_slots`` and for ``write_keys``."""
    P, S = 4, 64
    pages = np.array([-1, 1, -4, -2, 2, 2, 4, -5, 2, 1, 9], np.int32)
    slots = np.array([3, -2, -64, 10, 64, 200, 5, 5, -65, 40, 7], np.int32)
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**31, pages.size).astype(np.uint32)
    vals = rng.integers(0, 2**31, pages.size).astype(np.uint32)
    t = tlayout.empty_store(P, S, 32, "cpu", with_planes=True, fp_bits=8)
    j = jlayout.empty_store(P, S, 32, with_planes=True, fp_bits=8)
    if write == "slots":
        tout = t.write_slots(torch.from_numpy(pages), torch.from_numpy(slots),
                             t32(keys), t32(vals))
        jout = j.write_slots(*map(jnp.asarray, (pages, slots, keys, vals)))
    else:
        tout = t.write_keys(torch.from_numpy(pages), torch.from_numpy(slots),
                            t32(keys))
        jout = j.write_keys(*map(jnp.asarray, (pages, slots, keys)))
    assert_same_store(tout, jout)
    np.testing.assert_array_equal(u32(tout.fprints), np.asarray(jout.fprints))
    kp = u32(tout.key_pages)
    assert kp[3, 3] == keys[0] and kp[1, 62] == keys[1] \
        and kp[0, 0] == keys[2] and kp[2, 10] == keys[3]
    assert (kp != 0xFFFFFFFF).sum() == 5              # six writes dropped
    assert torch.equal(tout.fprints, tlayout.pack_fprints(tout.key_pages, 8))
