"""Serving parity with the JAX package: ``LoadGen`` streams of YCSB A, B and
C drawn for draw as JAX's."""
import numpy as np
import pytest

from repro import serving as jserving

from repro_torch import serving as tserving

import serving_parity_cases
from serving_parity_cases import _stream
import torch_threads

one_thread = torch_threads.one_thread
jitted_jax_loops = serving_parity_cases.jitted_jax_loops


@pytest.mark.parametrize("record_count", [1024, 100_000])
@pytest.mark.parametrize("wl", list("ABC"))
def test_loadgen_streams_equal_jax(wl, record_count):
    t = _stream(tserving, wl, record_count, 48)
    j = _stream(jserving, wl, record_count, 48)
    assert t[0] == j[0]
    for a, b in zip(t[1], j[1]):
        np.testing.assert_array_equal(a, b)
    assert t[2:] == j[2:]
