"""Parity of the port's bit-plane lane (``repro_torch.core.layout``) with the
JAX package's: packing and unpacking, also in page blocks, the planes of an
empty store, and the shape refusals. Exact (integer state)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as jlayout

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm
from repro_torch.core import layout as tlayout
from repro_torch.kernels import ops

import torch_threads
from bitplanes_cases import _stores, assert_same_store, rand_keys, t32, u32

one_thread = torch_threads.one_thread


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


@pytest.mark.parametrize("key_bits", [8, 32])
def test_empty_store_planes_match_jax(key_bits):
    t, j = _stores(P=5, S=96, key_bits=key_bits)
    assert t.planes.shape == (5, key_bits, 3)
    assert_same_store(t, j)
    assert tlayout.empty_store(5, 96, device="cpu").planes is None


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
