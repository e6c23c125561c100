"""The port's synthetic LM data pipeline (``repro_torch.data.pipeline``) gives
the JAX package's batches bit for bit: every step, seed and shard, for the
dense, encoder-decoder and VLM layouts, and through the prefetch iterator."""
import itertools

import numpy as np
import pytest

from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import SyntheticLMData as JSyntheticLMData

from repro_torch.configs import ShapeConfig, smoke_config
from repro_torch.data import SyntheticLMData

ARCHS = ["llama3-8b", "whisper-tiny", "internvl2-2b"]


def pair(arch, seed, shard_index=0, num_shards=1, batch=4, seq=32):
    kw = dict(seed=seed, shard_index=shard_index, num_shards=num_shards)
    return (JSyntheticLMData(j_smoke_config(arch),
                             JShapeConfig("t", seq, batch, "train"), **kw),
            SyntheticLMData(smoke_config(arch),
                            ShapeConfig("t", seq, batch, "train"), **kw))


def assert_same(want: dict, got: dict):
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_batch_at_equals_jax(arch, seed):
    jd, td = pair(arch, seed)
    for step in (0, 1, 7):
        assert_same(jd.batch_at(step), td.batch_at(step))


@pytest.mark.parametrize("shard_index", [0, 1])
def test_shards_equal_jax(shard_index):
    jd, td = pair("llama3-8b", 5, shard_index=shard_index, num_shards=2)
    assert td.local_batch == 2
    for step in (0, 1, 7):
        assert_same(jd.batch_at(step), td.batch_at(step))


def test_prefetch_iterator_equals_jax():
    jd, td = pair("qwen3-8b", 2)
    got = list(itertools.islice(td.iterator(3), 4))
    want = [jd.batch_at(s) for s in range(3, 7)]
    for w, g in zip(want, got):
        assert_same(w, g)
    td.close()
