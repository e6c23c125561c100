"""Parity of the port's routing (``_Route``) with the JAX package's on uniform
batches, and the unfused route's overflow."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rlu as jrlu

from repro_torch.core import rlu as trlu

import torch_threads
from rlu_parity_cases import _j_routes, _route_batch

one_thread = torch_threads.one_thread


@pytest.mark.parametrize("drop_invalid", [False, True])
@pytest.mark.parametrize("cap", ["q_local", "need", "need+3"])
@pytest.mark.parametrize("skew", [False], ids=["uniform"])
def test_route_matches_jax(skew, cap, drop_invalid):
    D, ql = 4, 24
    cfg, q = _route_batch(D, ql, skew, seed=5 + skew, pads=7)
    owner = trlu.owner_of_np(q, cfg, D, "highbits")
    need = trlu.routing_cap(q, cfg, D, "highbits", quantum=1) \
        if drop_invalid else int(np.bincount(
            (np.arange(q.size) // ql) * D + owner, minlength=D * D).max())
    c = {"q_local": ql, "need": need, "need+3": need + 3}[cap]
    c = min(c, ql) if cap != "need+3" else c
    pad = int(trlu.ROUTE_PAD)
    rt = trlu._Route(torch.from_numpy(q.astype(np.int64)),
                     torch.from_numpy(owner.astype(np.int64)), D, c, pad,
                     drop_invalid)
    jrts = _j_routes(q, owner, D, c, pad, drop_invalid)
    np.testing.assert_array_equal(
        rt.send.numpy(), np.stack([np.asarray(r.send) for r in jrts]))
    if drop_invalid:
        np.testing.assert_array_equal(
            rt.counts().numpy(), np.stack([np.asarray(r.counts())
                                           for r in jrts]))
    # results at the destinations, (D_dst, D_src * c), routed back
    rng = np.random.default_rng(1)
    res = rng.integers(0, 2**31, (D, D * c)).astype(np.int64)
    flag = rng.random((D, D * c)) < 0.6
    got_v = rt.gather_back(torch.from_numpy(res.reshape(-1))).numpy()
    got_f = rt.gather_back(torch.from_numpy(flag.reshape(-1))).numpy()
    want_v, want_f = [], []
    for s, r in enumerate(jrts):
        back_v = jnp.asarray(res[:, s * c:(s + 1) * c].astype(np.uint32))
        back_f = jnp.asarray(flag[:, s * c:(s + 1) * c])
        want_v.append(np.asarray(r.gather_back(back_v)))
        want_f.append(np.asarray(r.gather_back(back_f, mask_overflow=True)))
    np.testing.assert_array_equal(got_v, np.concatenate(want_v))
    np.testing.assert_array_equal(got_f, np.concatenate(want_f))


def test_unfused_route_overflow_keeps_the_last_in_capacity_entry():
    """The documented divergence (ROADMAP Queue 3): source block 0 sends
    [11, 12, 13, 14] with owners [0, 0, 0, 1] at c = 2.  JAX's unfused
    route scatters the overflowed 13 to slot c - 1 as a pad and loses 12
    (``rlu.py:303-305``); the port keeps 12 in slot 1 and drops only 13.
    Every other position agrees with JAX."""
    pad = int(jrlu.EMPTY_KEY)
    q = np.array([11, 12, 13, 14, 21, 22, 23, 24], np.uint32)
    owner = np.array([0, 0, 0, 1, 1, 1, 0, 0], np.int32)
    rt = trlu._Route(torch.from_numpy(q.astype(np.int64)),
                     torch.from_numpy(owner.astype(np.int64)), 2, 2, pad)
    jrts = _j_routes(q, owner, 2, 2, pad, False)
    want = np.stack([np.asarray(r.send) for r in jrts])
    got = rt.send.numpy()
    np.testing.assert_array_equal(want[0], [[11, pad], [14, pad]])
    np.testing.assert_array_equal(got[0], [[11, 12], [14, pad]])
    assert (got != want).sum() == 1                   # only query 12's slot
    np.testing.assert_array_equal(got[1], want[1])
    found = rt.gather_back(torch.ones(8, dtype=torch.bool)).numpy()
    jfound = np.concatenate([np.asarray(r.gather_back(
        jnp.ones((2, 2), bool), mask_overflow=True)) for r in jrts])
    np.testing.assert_array_equal(found, [1, 1, 0, 1, 1, 1, 1, 1])
    np.testing.assert_array_equal(jfound, [1, 1, 0, 1, 1, 1, 1, 1])
    vals = rt.gather_back(torch.arange(8)).numpy()
    assert vals[2] == 0                               # dropped: value 0
