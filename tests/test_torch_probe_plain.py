"""Parity of the port's plain probe with the JAX package's ``probe_pages_ref``
and its Pallas ``probe_pages_perf`` in interpret mode, and with a numpy loop
over the lane contract, on every shape; the plain version in chunks and the
CPU dispatch. All state is integer, so every comparison is exact (tolerance
0). The CUDA kernel is held against the plain version on the card by
``chip_smoke.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core import layout as tlayout
from repro_torch.core import probe as tprobe
from repro_torch.kernels import ops, ref as tref
from repro_torch.kernels.probe_perf import probe_pages_perf

from test_kernels_probe import make_pool, make_queries
import torch_threads
from probe_cases import SHAPES, check_all, t_pages, t_pool, t_q

one_thread = torch_threads.one_thread


@pytest.mark.parametrize("P,S,Q,C", SHAPES)
def test_plain_probe_matches_jax(P, S, Q, C):
    rng = np.random.default_rng(P * 1000 + S + Q + C)
    kp, vp, live = make_pool(rng, P, S)
    q, pages = make_queries(rng, kp, vp, live, Q, C, P)
    got = check_all(kp, vp, q, pages)
    assert got[:, 1].sum() >= Q // 2


def test_plain_probe_chunks_agree(monkeypatch):
    rng = np.random.default_rng(11)
    kp, vp, live = make_pool(rng, 32, 256)
    q, pages = make_queries(rng, kp, vp, live, 97, 4, 32)
    whole = tref.probe_pages_ref(t_pool(kp, vp), t_q(q), t_pages(pages))
    monkeypatch.setattr(tref, "GATHER_BYTES", 5 * 4 * 256 * 8)   # 5 queries
    chunked = tref.probe_pages_ref(t_pool(kp, vp), t_q(q), t_pages(pages))
    assert torch.equal(whole, chunked)


def test_cpu_dispatch_takes_plain_version():
    rng = np.random.default_rng(5)
    kp, vp, live = make_pool(rng, 16, 128)
    q, pages = make_queries(rng, kp, vp, live, 32, 2, 16)
    args = t_pool(kp, vp), t_q(q), t_pages(pages)
    store = tlayout.empty_store(16, 128, device="cpu")
    store.pool = args[0]
    before = probe_pages_perf.launches
    want = tref.probe_pages_ref(*args)
    for backend in ("perf", "ref"):
        assert torch.equal(tprobe.probe_lanes(store, *args[1:], backend),
                           want)
    assert torch.equal(ops.probe_perf(*args), want)
    assert probe_pages_perf.launches == before     # no kernel on the CPU
    with pytest.raises(ValueError, match="unknown probe backend"):
        tprobe.probe_lanes(store, *args[1:], "cam")
