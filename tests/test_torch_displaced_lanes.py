"""Parity of the port's fingerprint lane and stash with the JAX package: the
lanes through ``empty_store``/``write_slots``/``write_keys``, the
fingerprint pre-pass (``_fp_filter``, also in blocks smaller than the
batch), ``resolve_pages_displaced`` and ``stash_probe``. Tolerance 0: all
state is integer."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashmap as jhm
from repro.core import layout as jlayout
from repro.core.hashing import fingerprint as j_fingerprint

from repro_torch.core import hashmap as thm
from repro_torch.core import layout as tlayout

from hashmap_cases import assert_same_state, j_build, jcfg
import torch_threads
from displaced_cases import CPU, dcfg, fp_table

one_thread = torch_threads.one_thread


def t32(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32))


def u32(t):
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# The lanes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fp_bits", [1, 8, 12])
def test_lanes_through_empty_store_and_writes(fp_bits):
    """``empty_store`` makes the same fingerprint, stash and depth lanes;
    ``write_slots`` and ``write_keys`` (with a ``plane_pages`` override)
    keep ``fprints`` as JAX's do, writes past the pool dropped."""
    rng = np.random.default_rng(fp_bits)
    P, S = 6, 64
    t = tlayout.empty_store(P, S, 32, CPU, fp_bits=fp_bits, stash_slots=5,
                            local_depth=3)
    j = jlayout.empty_store(P, S, 32, fp_bits=fp_bits, stash_slots=5,
                            local_depth=3)
    for name in ("fprints", "stash", "stash_fill", "local_depth"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        np.testing.assert_array_equal(a.view(b.dtype), b, err_msg=name)
    assert t.fp_bits == j.fp_bits == fp_bits
    flat = rng.choice(P * S, 90, replace=False)
    pages = np.concatenate([flat // S, [P, P + 2]]).astype(np.int32)
    slots = np.concatenate([flat % S, [0, 5]]).astype(np.int32)
    keys = rng.integers(0, 2**32, 92, dtype=np.uint64).astype(np.uint32)
    t = t.write_slots(torch.from_numpy(pages), torch.from_numpy(slots),
                      t32(keys), t32(keys))
    j = j.write_slots(*map(jnp.asarray, (pages, slots, keys, keys)))
    np.testing.assert_array_equal(u32(t.fprints), np.asarray(j.fprints))
    tomb = np.full(10, 0xFFFFFFFE, np.uint32)
    pp = pages[:10].copy()
    pp[3] = P                                    # dropped from the lane only
    t = t.write_keys(torch.from_numpy(pages[:10]), torch.from_numpy(slots[:10]),
                     t32(tomb), plane_pages=torch.from_numpy(pp))
    j = j.write_keys(jnp.asarray(pages[:10]), jnp.asarray(slots[:10]),
                     jnp.asarray(tomb), plane_pages=jnp.asarray(pp))
    np.testing.assert_array_equal(u32(t.pool), np.asarray(j.pool))
    np.testing.assert_array_equal(u32(t.fprints), np.asarray(j.fprints))
    want = jlayout.pack_bitplanes(j_fingerprint(j.pool[..., 0], fp_bits),
                                  fp_bits)
    got = tlayout.pack_fprints(t.key_pages, fp_bits)
    np.testing.assert_array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("pairs", [None, 7])
def test_fp_filter_matches_jax(pairs, monkeypatch):
    """Random (Q, 5) schedules with holes and page ids past the pool; with
    ``pairs`` the pre-pass works in blocks of 7 (query, page) pairs.  At
    fp_bits = 6 and 5 the OR over planes halves an odd count of planes."""
    t, j, keys, rng = fp_table(fp_bits=6 if pairs else 5)
    if pairs:
        monkeypatch.setattr(thm, "FP_PAIRS", pairs)
    P = t.config.num_pages
    q = np.concatenate([keys[rng.choice(900, 150)],
                        rng.choice(0xFFFFFFF0, 50).astype(np.uint32)])
    pages = rng.integers(-1, P + 3, (200, 5)).astype(np.int32)
    pages[rng.random((200, 5)) < 0.3] = -1
    got = thm._fp_filter(t.store, q, torch.from_numpy(pages))
    want = jhm._fp_filter(j.store, jnp.asarray(q), jnp.asarray(pages))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == -1).sum() > (pages == -1).sum()   # it filtered
    empty = thm._fp_filter(t.store, q[:0], torch.from_numpy(pages[:0]))
    assert empty.shape == (0, 5)


@pytest.mark.parametrize("hash_fn", ["murmur3_fmix", "identity"])
def test_resolve_pages_displaced_matches_jax(hash_fn):
    """The [H1 direct] + [H2 chain] schedule; under ``identity`` H2 == H1
    and the H2 head is blanked."""
    cfg = dcfg("perf", hash_fn=hash_fn, num_buckets=16)
    rng = np.random.default_rng(4)
    keys = rng.choice(4000, 1500, replace=False).astype(np.uint32)
    t = thm.build(cfg, keys, keys, device=CPU)
    j = j_build(jcfg(cfg), jnp.asarray(keys), jnp.asarray(keys))
    assert_same_state(t, j)
    got = thm.resolve_pages_displaced(t, keys).numpy()
    want = np.asarray(jhm.resolve_pages_displaced(j, jnp.asarray(keys)))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (1500, cfg.max_chain + 1)
    b1 = rng.integers(0, 16, 1500)
    np.testing.assert_array_equal(
        thm.resolve_pages_displaced(t, keys, torch.from_numpy(b1)).numpy(),
        np.asarray(jhm.resolve_pages_displaced(j, jnp.asarray(keys),
                                               jnp.asarray(b1))))
    if hash_fn == "identity":
        assert (got[:, 1] == -1).all()


@pytest.mark.parametrize("used", [6, 8])
def test_stash_probe_matches_jax(used):
    """Duplicates in the stash (the oldest wins), a tombstone, EMPTY slots
    (``used`` = 6) or none (``used`` = 8), and queries equal to EMPTY_KEY
    and TOMBSTONE_KEY."""
    rng = np.random.default_rng(7)
    stash = np.full((8, 2), 0xFFFFFFFF, np.uint32)
    stash[:, 1] = 0
    stash[:used, 0] = [11, 12, 11, 0xFFFFFFFE, 13, 12, 40, 11][:used]
    stash[:used, 1] = rng.integers(1, 2**32, used, dtype=np.uint64)
    q = np.array([11, 12, 13, 14, 0xFFFFFFFF, 0xFFFFFFFE, 40, 0], np.uint32)
    t = tlayout.empty_store(2, 32, 32, CPU, stash_slots=8)
    t.stash = t32(stash)
    j = dataclasses.replace(jlayout.empty_store(2, 32, 32, stash_slots=8),
                            stash=jnp.asarray(stash))
    tv, tf = thm.stash_probe(t, q)
    jv, jf = jhm.stash_probe(j, jnp.asarray(q))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy().astype(np.uint32), np.asarray(jv))
    assert tv[0] == int(stash[0, 1]) and not tf[3]
    assert bool(tf[4]) == (used < 8)
