"""The shared part of the port's probe parity tests: the shapes, the port's
inputs from numpy, a numpy loop over the lane contract, and the check of
every probe path against JAX's."""
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import layout as jlayout
from repro.kernels import ref as jref
from repro.kernels.probe_perf import probe_pages_perf as jax_perf

from repro_torch.core import layout as tlayout
from repro_torch.kernels import ref as tref

SHAPES = [(16, 128, 32, 1), (32, 256, 64, 4), (8, 512, 16, 2),
          (64, 128, 128, 3)]


def lanes_oracle(kp, vp, queries, pages):
    """numpy loop over the contract: first chain step, then lowest slot."""
    P = kp.shape[0]
    out = np.zeros((len(queries), 4), np.uint32)
    for i, q in enumerate(queries):
        for p in pages[i]:
            if p < 0:
                continue
            hit = np.flatnonzero(kp[min(p, P - 1)] == q)
            if hit.size:
                out[i] = (vp[min(p, P - 1), hit[0]], 1, p, hit[0])
                break
    return out


def t_pool(kp, vp):
    return tlayout.interleave(torch.from_numpy(kp.view(np.int32)),
                              torch.from_numpy(vp.view(np.int32)))


def t_q(q):
    return torch.from_numpy(np.ascontiguousarray(q).view(np.int32))


def t_pages(pages):
    return torch.from_numpy(np.ascontiguousarray(pages, np.int32))


def check_all(kp, vp, q, pages, interpret=True):
    """Port plain probe == numpy oracle lanes == JAX ref (== JAX perf)."""
    got = tref.probe_pages_ref(t_pool(kp, vp), t_q(q), t_pages(pages))
    got = got.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, lanes_oracle(kp, vp, q, pages))
    pool = jlayout.interleave(jnp.asarray(kp), jnp.asarray(vp))
    jq, jp = jnp.asarray(q), jnp.asarray(pages)
    impls = [jref.probe_pages_ref]
    if interpret:
        impls.append(lambda *a: jax_perf(*a, interpret=True))
    for fn in impls:
        v, f = fn(pool, jq, jp)
        np.testing.assert_array_equal(got[:, 1] != 0, np.asarray(f))
        np.testing.assert_array_equal(got[:, 0], np.asarray(v))
    return got
