"""Parity of the port's extendible resize with the JAX package: the cases of
``tests/test_extendible.py`` through both packages.  ``double_directory``
as a pointer copy and its refusal, ``split_group``'s four statuses and its
locality, splits instead of rebuilds, FIFO order across splits, a rebuild
resetting the directory, the churn differential on four backends, and the
``insert_auto`` budgets.  After every step both tables must hold equal
leaves (``local_depth`` included), equal configs, ``stats`` and ``events``,
and equal ok/found/probe results; tolerance 0 (integer state).

The JAX side runs its host-level loops as they are, with two of its module
functions swapped for jitted forms so that the file stays cheap:
``insert_with_buckets`` pads each batch to a power of two with
``valid=False`` (pads write nothing and claim nothing, per its contract)
and ``grow`` is compiled once per config.

Shared by the ``tests/test_torch_extendible_*.py`` files.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import hashmap as jhm

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm

from hashmap_cases import assert_same_state, jcfg

CPU = "cpu"

j_iwb = jax.jit(jhm.insert_with_buckets)
j_grow = jax.jit(jhm.grow, static_argnames=("factor", "bucket_fn"))
j_delete = jax.jit(jhm.delete)
j_probe = jax.jit(lambda hm, q: jhm.probe(hm, q, backend="ref"))


def padded_insert_with_buckets(hm, keys, vals, b, valid=None):
    n = keys.shape[0]
    m = max(8, 1 << (n - 1).bit_length())

    def pad(a, fill):
        a = jnp.asarray(a)
        return jnp.concatenate([a, jnp.full((m - n,), fill, a.dtype)])

    v = jnp.ones((n,), bool) if valid is None else jnp.asarray(valid)
    hm2, ok = j_iwb(hm, pad(keys, 0), pad(vals, 0), pad(b, 0), pad(v, False))
    return hm2, ok[:n]


@pytest.fixture(autouse=True)
def jitted_jax_loops(monkeypatch):
    monkeypatch.setattr(jhm, "insert_with_buckets", padded_insert_with_buckets)
    monkeypatch.setattr(jhm, "grow", j_grow)


def ecfg(**kw) -> HashMemConfig:
    """``tests/test_extendible.py``'s ``_cfg``."""
    base = dict(num_buckets=8, slots_per_page=4, overflow_pages=120,
                max_chain=4, backend="ref", auto_grow=True,
                resize="extendible", max_load_factor=1.0)
    base.update(kw)
    return HashMemConfig(**base)


def assert_same(t, j):
    """Equal configs, leaves and stats."""
    assert t.config == HashMemConfig(**dataclasses.asdict(j.config))
    assert_same_state(t, j)
    ts, js = thm.stats(t), jhm.stats(j)
    assert ts.keys() == js.keys()
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def both(cfg):
    return thm.create(cfg, device=CPU), jhm.create(jcfg(cfg))


def both_insert(t, j, keys, vals, how="insert"):
    """One insert entry point through both packages: equal oks."""
    if how == "insert":
        t, tok = thm.insert(t, keys, vals)
        j, jok = jhm.insert(j, jnp.asarray(keys), jnp.asarray(vals))
        tev = jev = None
    else:
        tev, jev = {}, {}
        t, tok = getattr(thm, how)(t, keys, vals, events=tev)
        j, jok = getattr(jhm, how)(j, jnp.asarray(keys), jnp.asarray(vals),
                                   events=jev)
        assert tev == jev
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    return t, j, tok.numpy(), tev


def probe_both(t, j, q):
    tv, tf = thm.probe(t, q)
    jv, jf = j_probe(j, jnp.asarray(q))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy().astype(np.uint32), np.asarray(jv))
    return tv.numpy().astype(np.uint32), tf.numpy()
