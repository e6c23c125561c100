"""The shared part of the port's bit-plane parity tests: uint32 carriers and
seeded keys."""
import numpy as np
import torch

from repro.core import layout as jlayout

from repro_torch.core import layout as tlayout


def t32(a):
    """numpy uint32 -> int32 tensor with the same bits."""
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def u32(t):
    return t.numpy().view(np.uint32)


def rand_keys(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _stores(P=8, S=64, key_bits=32):
    return (tlayout.empty_store(P, S, key_bits, "cpu", with_planes=True),
            jlayout.empty_store(P, S, key_bits, with_planes=True))


def assert_same_store(t, j):
    np.testing.assert_array_equal(u32(t.pool), np.asarray(j.pool))
    np.testing.assert_array_equal(u32(t.planes), np.asarray(j.planes))
