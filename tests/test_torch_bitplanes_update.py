"""Parity of the port's batched incremental bit-plane update with the JAX
package's, at every key width, with writes in and out of range. Exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as jlayout

from repro_torch.core import layout as tlayout
from repro_torch.kernels import ops

import torch_threads
from bitplanes_cases import rand_keys, t32, u32

one_thread = torch_threads.one_thread


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
