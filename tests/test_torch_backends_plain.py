"""Parity of the port's ``area`` and ``bitserial`` probe backends with the JAX
package: the plain versions the CPU runs (``probe_pages_ref`` for the area
kernel, ``probe_bitplanes_ref`` for the bit-serial one) against JAX's
oracles and its Pallas ``probe_pages_area`` / ``probe_pages_bitserial`` in
interpret mode, and against a numpy loop over the lane contract. All state
is integer, so every comparison is exact (tolerance 0). The CUDA kernels are
held against these plain versions on the card by ``chip_smoke.py``."""
import numpy as np
import pytest

from test_kernels_probe import make_pool, make_queries
from probe_cases import SHAPES
import torch_threads
from backends_cases import check_backend

one_thread = torch_threads.one_thread


@pytest.mark.parametrize("backend", ["area", "bitserial"])
@pytest.mark.parametrize("P,S,Q,C", SHAPES)
def test_plain_versions_match_jax(backend, P, S, Q, C):
    rng = np.random.default_rng(P * 1000 + S + Q + C)
    kp, vp, live = make_pool(rng, P, S)
    q, pages = make_queries(rng, kp, vp, live, Q, C, P)
    got = check_backend(backend, kp, vp, q, pages)
    assert got[:, 1].sum() >= Q // 2
