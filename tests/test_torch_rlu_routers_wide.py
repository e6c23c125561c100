"""Parity of the port's shard routers with the JAX package's, on four and eight
shards."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rlu as jrlu

from repro_torch.configs import HashMemConfig
from repro_torch.core import rlu as trlu

from hashmap_cases import jcfg
import torch_threads
from rlu_parity_cases import HASHES

one_thread = torch_threads.one_thread


# ---------------------------------------------------------------------------
# Routers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hash_fn", HASHES)
@pytest.mark.parametrize("D", [4, 8])
def test_routers_match_jax(D, hash_fn):
    cfg = HashMemConfig(num_buckets=48, hash_fn=hash_fn)
    rng = np.random.default_rng(D)
    keys = np.concatenate([rng.integers(0, 2**32, 4000, dtype=np.uint64)
                           .astype(np.uint32),
                           np.array([0, 1, 0xFFFFFFF0, 0xFFFFFFFE,
                                     0xFFFFFFFF], np.uint32)])
    jk, tk = jnp.asarray(keys), torch.from_numpy(keys.view(np.int32))
    jc = jcfg(cfg)
    for shard_by in trlu.SHARD_ROUTERS:
        want_o = np.asarray(jrlu.owner_of(jk, jc, D, shard_by))
        np.testing.assert_array_equal(
            trlu.owner_of(tk, cfg, D, shard_by).numpy(), want_o)
        np.testing.assert_array_equal(
            trlu.owner_of_np(keys, cfg, D, shard_by), want_o)
        np.testing.assert_array_equal(
            jrlu.owner_of_np(keys, jc, D, shard_by), want_o)
        jo, jl = jrlu.owner_and_local_bucket(jk, jc, D, shard_by)
        to, tl = trlu.owner_and_local_bucket(keys, cfg, D, shard_by)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        grown = dataclasses.replace(cfg, num_buckets=96)
        np.testing.assert_array_equal(
            trlu._local_bucket_fn(D, shard_by)(tk, grown).numpy(),
            np.asarray(jrlu._local_bucket_fn(D, shard_by)(jk, jcfg(grown))))
        assert to.max() < D
