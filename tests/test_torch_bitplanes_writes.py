"""Parity of the port's PageStore writes with the JAX package's: they keep the
planes in step with the key lane, through tombstones and wrapped or
out-of-range ids. Exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as jlayout
from repro.core.hashing import TOMBSTONE_KEY

from repro_torch.core import layout as tlayout

import torch_threads
from bitplanes_cases import _stores, assert_same_store, t32, u32

one_thread = torch_threads.one_thread


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
