"""The port's HashMem tables against the JAX package's on the CPU: JAX tables
carried in through ``from_numpy``, the device rules, and the resize knobs'
validation."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashmap as jhm

from repro_torch.core import hashmap as thm
from repro_torch.kernels.probe_perf import probe_pages_perf

import torch_threads
from hashmap_cases import (
    CPU, SMALL, assert_same_probe, assert_same_state, build_case, j_build,
    j_delete, j_insert, jax_leaves, jcfg)

one_thread = torch_threads.one_thread


def test_from_numpy_of_jax_table_matches():
    cfg, keys, vals = build_case("murmur_chains")
    j = j_build(jcfg(cfg), jnp.asarray(keys[:8000]), jnp.asarray(vals[:8000]))
    t = thm.from_numpy(cfg, jax_leaves(j), device=CPU)
    assert_same_state(t, j)
    q = np.concatenate([keys[::7], keys[8000:]])
    with pytest.raises(KeyError):                # a bit-serial table needs planes
        thm.from_numpy(dataclasses.replace(cfg, backend="bitserial"),
                       jax_leaves(j), device=CPU)
    assert_same_probe(t, j, q)
    t, tok = thm.insert(t, keys[8000:], vals[8000:])
    j, jok = j_insert(j, jnp.asarray(keys[8000:]), jnp.asarray(vals[8000:]))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    t, tf = thm.delete(t, keys[:300])
    j, jf = j_delete(j, jnp.asarray(keys[:300]))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert_same_state(t, j)
    assert_same_probe(t, j, q)
    with pytest.raises(ValueError):
        thm.from_numpy(dataclasses.replace(cfg, num_buckets=32),
                       jax_leaves(j), device=CPU)


def test_from_numpy_of_jax_bitserial_table_probes_identically():
    """A bit-serial table built by JAX at key_bits=16 crosses over with its
    planes, probes as JAX's bit-serial backend does, and mutates as JAX's
    does."""
    cfg, keys, vals = build_case("murmur_chains")
    cfg = dataclasses.replace(cfg, backend="bitserial", key_bits=16)
    j = j_build(jcfg(cfg), jnp.asarray(keys[:8000]), jnp.asarray(vals[:8000]))
    t = thm.from_numpy(cfg, jax_leaves(j), device=CPU)
    assert_same_state(t, j)
    q = np.concatenate([keys[::7], keys[8000:]])
    tv, tf = thm.probe(t, q)
    jv, jf = jhm.probe(j, jnp.asarray(q))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy().astype(np.uint32), np.asarray(jv))
    t, _ = thm.insert(t, keys[8000:], vals[8000:])
    j, _ = j_insert(j, jnp.asarray(keys[8000:]), jnp.asarray(vals[8000:]))
    t, _ = thm.delete(t, keys[:300])
    j, _ = j_delete(j, jnp.asarray(keys[:300]))
    assert_same_state(t, j)


def test_cpu_table_never_launches_the_kernel():
    cfg, keys, vals = build_case("identity_forced_chains")
    before = probe_pages_perf.launches
    t = thm.build(cfg, keys, vals, device=CPU)
    thm.probe(t, keys)
    thm.delete(t, keys[:5])
    assert probe_pages_perf.launches == before


def test_no_device_means_the_card():
    """Entry points default to CUDA; without a card they raise instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    keys = np.arange(10, dtype=np.uint32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thm.create(SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thm.build(SMALL, keys, keys)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thm.from_numpy(SMALL, thm.to_numpy(thm.create(SMALL, device=CPU)))


@pytest.mark.parametrize("change,match", [
    (dict(resize="incremental"), "unknown resize"),
    (dict(resize="extendible", displacement=True), "extendible"),
    (dict(resize="extendible", stash_slots=32), "extendible"),
    (dict(resize="extendible", num_buckets=6), "power-of-two"),
    (dict(resize="extendible", fingerprint_bits=8, num_buckets=6),
     "power-of-two"),
])
def test_resize_knob_validation_matches_jax(change, match):
    """``create`` refuses what the JAX package's ``_check_resize`` refuses,
    with the same message; an unknown backend is refused too."""
    cfg = dataclasses.replace(SMALL, **change)
    with pytest.raises(ValueError, match=match) as t_err:
        thm.create(cfg, device=CPU)
    with pytest.raises(ValueError, match=match) as j_err:
        jhm.create(jcfg(cfg))
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError):
        thm.create(dataclasses.replace(SMALL, resize="sideways"), device=CPU)
    with pytest.raises(ValueError):
        thm.create(dataclasses.replace(SMALL, backend="cam"), device=CPU)


def test_rebuild_mode_accepts_every_lane():
    """Rebuild mode takes displacement, fingerprints and a stash, on a
    directory that is not a power of two: both packages create the same
    empty table, every lane included."""
    cfg = dataclasses.replace(SMALL, displacement=True, fingerprint_bits=8,
                              stash_slots=32, num_buckets=6)
    assert_same_state(thm.create(cfg, device=CPU), jhm.create(jcfg(cfg)))
