"""Parity of the port's HashMem ``build`` and ``probe`` with the JAX package's
on the CPU: every build case, bit-serial builds included, and the
``DictModel`` oracle."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashmap as jhm

from repro_torch.core import hashmap as thm
from repro_torch.core import layout as tlayout

from model import DictModel
import torch_threads
from hashmap_cases import (
    BUILD_CASES, CPU, _unique, assert_same_probe, assert_same_state,
    build_case, j_build, jcfg)

one_thread = torch_threads.one_thread


@pytest.mark.parametrize("case", BUILD_CASES)
def test_build_and_probe_match_jax(case):
    cfg, keys, vals = build_case(case)
    t = thm.build(cfg, keys, vals, device=CPU)
    j = j_build(jcfg(cfg), jnp.asarray(keys), jnp.asarray(vals))
    assert_same_state(t, j)
    np.testing.assert_array_equal(
        thm.resolve_pages(t, keys).numpy(),
        np.asarray(jhm.resolve_pages(j, jnp.asarray(keys))))
    np.testing.assert_array_equal(thm.chain_lengths(t).numpy(),
                                  np.asarray(jhm.chain_lengths(j)))
    assert thm.max_chain_len(t) == jhm.max_chain_len(j)
    rng = np.random.default_rng(1)
    q = np.concatenate([keys[rng.choice(len(keys), 500)],
                        _unique(rng, 100)])
    v, f = assert_same_probe(t, j, q)
    for backend in ("perf", "ref"):
        tv, tf = thm.probe(t, q, backend=backend)
        np.testing.assert_array_equal(tf.numpy(), f)
        np.testing.assert_array_equal(tv.numpy().astype(np.uint32), v)
    ts, js = thm.stats(t), jhm.stats(j)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    assert int(thm.live_count(t)) == int(jhm.live_count(j))
    assert float(thm.load_factor(t)) == float(jhm.load_factor(j))
    tc, jc = thm.build_check(cfg, keys), jhm.build_check(jcfg(cfg), keys)
    for k in jc:
        np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)


def test_build_agrees_with_dict_model():
    cfg, keys, vals = build_case("duplicates")
    t = thm.build(cfg, keys, vals, device=CPU)
    model = DictModel()
    model.insert(keys, vals, np.ones(len(keys), bool))
    q = np.unique(keys)
    ev, ef = model.probe(q)
    v, f = thm.probe(t, q)
    np.testing.assert_array_equal(f.numpy(), ef)
    np.testing.assert_array_equal(v.numpy(), ev)


@pytest.mark.parametrize("case", ["murmur_chains", "duplicates",
                                  "arena_too_small"])
def test_bitserial_build_matches_jax(case):
    """A bit-serial table: equal leaves, planes included, and every backend
    of the port probes as JAX's bit-serial backend does."""
    cfg, keys, vals = build_case(case)
    cfg = dataclasses.replace(cfg, backend="bitserial")
    t = thm.build(cfg, keys, vals, device=CPU)
    j = j_build(jcfg(cfg), jnp.asarray(keys), jnp.asarray(vals))
    assert_same_state(t, j)
    assert torch.equal(t.planes, tlayout.pack_bitplanes(t.key_pages, 32))
    q = np.concatenate([keys[::9], _unique(np.random.default_rng(2), 100)])
    jv, jf = jhm.probe(j, jnp.asarray(q), backend="bitserial")
    for backend in ("bitserial", "ref", "perf", "area"):
        tv, tf = thm.probe(t, q, backend=backend)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tv.numpy().astype(np.uint32),
                                      np.asarray(jv))
