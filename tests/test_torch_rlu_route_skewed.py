"""Parity of the port's routing (``_Route``) with the JAX package's on skewed
batches, and ``routing_cap``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rlu as jrlu

from repro_torch.core import rlu as trlu

from hashmap_cases import jcfg
import torch_threads
from rlu_parity_cases import _j_routes, _route_batch

one_thread = torch_threads.one_thread


@pytest.mark.parametrize("drop_invalid", [False, True])
@pytest.mark.parametrize("cap", ["q_local", "need", "need+3"])
@pytest.mark.parametrize("skew", [True], ids=["skewed"])
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


@pytest.mark.parametrize("case", ["random", "tiny", "one_shard", "all_pads",
                                  "mod"])
def test_routing_cap_matches_jax(case):
    D = 4
    cfg, q = _route_batch(D, 64, case == "one_shard", seed=11, pads=5)
    shard_by = "mod" if case == "mod" else "highbits"
    if case == "tiny":                       # Q_local < quantum
        q = q[:3 * D]
    if case == "all_pads":
        q = np.full(8 * D, trlu.ROUTE_PAD, np.uint32)
    for quantum in (1, 8, 16):
        want = jrlu.routing_cap(q, jcfg(cfg), D, shard_by, quantum=quantum)
        assert trlu.routing_cap(q, cfg, D, shard_by,
                                quantum=quantum) == want
    if case == "one_shard":
        assert trlu.routing_cap(q, cfg, D, shard_by) == 64
    if case == "tiny":
        assert trlu.routing_cap(q, cfg, D, shard_by) == 3
