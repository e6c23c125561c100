"""The port's workload leaves against the JAX package's: ``churn_workload``,
``zipfian_workload`` (default, custom and YCSB mixes) and
``dictionary_words`` (``data/kv_synth.py``), and the paper's ``WORKLOAD``
and ``DDR4_TIMING`` (``configs/hashmem_paper.py``).  Both are numpy: the
same seeds must give the same streams, arrays and dicts, exactly.
``dictionary_words`` is a Python loop, so it runs at a small n."""
import numpy as np
import pytest

from repro.configs import hashmem_paper as jpaper
from repro.data import kv_synth as jkv

from repro_torch.configs import hashmem_paper as tpaper
from repro_torch.data import kv_synth as tkv


def assert_same_stream(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (op, k, v), (jop, jk, jv) in zip(got, want):
        assert op == jop
        assert k.dtype == jk.dtype
        np.testing.assert_array_equal(k, jk)
        if jv is None:
            assert v is None
        else:
            assert v.dtype == jv.dtype
            np.testing.assert_array_equal(v, jv)


@pytest.mark.parametrize("kw", [
    dict(n_ops=200),
    dict(n_ops=150, keyspace=97, insert_batch=3, delete_batch=5,
         probe_batch=7, p_insert=0.2, p_delete=0.6, seed=11)])
def test_churn_workload_matches_jax(kw):
    assert_same_stream(tkv.churn_workload(**kw), jkv.churn_workload(**kw))


@pytest.mark.parametrize("kw", [
    dict(n_ops=200),
    dict(n_ops=120, keyspace=300, theta=0.6, mix={"probe": 3, "delete": 1},
         seed=5),
    *[dict(n_ops=80, keyspace=512, workload=w, seed=2) for w in "ABCDEF"]])
def test_zipfian_workload_matches_jax(kw):
    assert_same_stream(tkv.zipfian_workload(**kw),
                       jkv.zipfian_workload(**kw))


@pytest.mark.parametrize("n, seed", [(2000, 3), (500, 8)])
def test_dictionary_words_match_jax(n, seed):
    got = tkv.dictionary_words(n, seed)
    want = jkv.dictionary_words(n, seed)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert np.unique(got).size == n and int(got.max()) < 0xFFFFFFF0


def test_data_package_exports_match_jax():
    from repro_torch import data
    assert data.dictionary_words is tkv.dictionary_words
    assert data.kv_dataset is tkv.kv_dataset


@pytest.mark.parametrize("name", ["WORKLOAD", "DDR4_TIMING"])
def test_paper_workload_and_timing_match_jax(name):
    got, want = getattr(tpaper, name), getattr(jpaper, name)
    assert got == want and type(got) is dict
    assert got is not want
