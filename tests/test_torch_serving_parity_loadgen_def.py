"""Serving parity with the JAX package: ``LoadGen`` streams of YCSB D, E and
F drawn for draw as JAX's, and the zipfian weights re-cached mid-stream."""
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
@pytest.mark.parametrize("wl", list("DEF"))
def test_loadgen_streams_equal_jax(wl, record_count):
    t = _stream(tserving, wl, record_count, 48)
    j = _stream(jserving, wl, record_count, 48)
    assert t[0] == j[0]
    for a, b in zip(t[1], j[1]):
        np.testing.assert_array_equal(a, b)
    assert t[2:] == j[2:]


@pytest.mark.parametrize("record_count", [1024, 100_000])
def test_loadgen_recache_point_equal_jax(record_count):
    """An insert-heavy "latest" stream grows the key range past 1.25x the
    cached size, so the zipfian weights (and the port's CDF) are rebuilt
    mid-stream; the draws stay equal across it."""
    n_req = record_count // 3 // 4 + 8          # > 25% of the range inserted
    spec = dict(mix={"insert": 0.96, "read": 0.04}, ops_per_request=4)
    t = _stream(tserving, "D", record_count, n_req, spec)
    j = _stream(jserving, "D", record_count, n_req, spec)
    assert t[2] > record_count * 1.25
    assert t[3] > record_count                  # re-cached
    assert t[0] == j[0] and t[2:] == j[2:]
