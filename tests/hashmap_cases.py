"""The JAX-side helpers of the port's HashMem parity tests: jitted JAX
entry points, the config carried across, and leaf-by-leaf state checks."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import HashMemConfig as JaxConfig
from repro.core import hashmap as jhm

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm

from model import murmur3_fmix_np

CPU = "cpu"

# the JAX functions under test, compiled once per table shape
j_build = jax.jit(jhm.build, static_argnums=0)
j_probe = jax.jit(partial(jhm.probe, backend="ref"))
j_insert = jax.jit(jhm.insert)
j_delete = jax.jit(jhm.delete)


def jcfg(cfg: HashMemConfig) -> JaxConfig:
    return JaxConfig(**dataclasses.asdict(cfg))


def jax_leaves(hm) -> dict:
    out = {"pool": np.asarray(hm.store.pool),
           "page_next": np.asarray(hm.page_next),
           "page_fill": np.asarray(hm.page_fill),
           "free_top": np.asarray(hm.free_top),
           "bucket_head": np.asarray(hm.bucket_head)}
    for name in ("planes", "fprints", "stash", "stash_fill", "local_depth"):
        if getattr(hm.store, name) is not None:
            out[name] = np.asarray(getattr(hm.store, name))
    return out


def assert_same_state(thm_table, jhm_table):
    got, want = thm.to_numpy(thm_table), jax_leaves(jhm_table)
    assert set(got) == set(want) == set(thm.leaf_names(thm_table.config))
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def assert_same_probe(t, j, queries):
    tv, tf = thm.probe(t, queries)
    jv, jf = j_probe(j, jnp.asarray(queries))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy().astype(np.uint32), np.asarray(jv))
    return tv.numpy().astype(np.uint32), tf.numpy()


SMALL = HashMemConfig(num_buckets=64, slots_per_page=128, overflow_pages=64,
                      max_chain=4)


def _unique(rng, n, hi=0xFFFFFFF0):
    return rng.choice(hi, size=n, replace=False).astype(np.uint32)


def one_bucket_keys(n, num_buckets):
    """n distinct keys that share one murmur3_fmix bucket."""
    cand = np.arange(1, 1 << 21, dtype=np.uint32)
    keys = cand[murmur3_fmix_np(cand) % np.uint32(num_buckets) == 5][:n]
    assert len(keys) == n
    return keys


def build_case(name):
    """(config, keys, vals) for each build scenario."""
    rng = np.random.default_rng(BUILD_CASES.index(name))
    if name == "murmur_chains":          # ~1.1 pages/bucket: some overflow
        keys = _unique(rng, 9000)
        cfg = SMALL
    elif name == "mult_shift_skew":
        keys = (np.arange(6000, dtype=np.uint32) * np.uint32(64))
        cfg = dataclasses.replace(SMALL, hash_fn="mult_shift")
    elif name == "identity_forced_chains":   # 3 buckets take every key
        keys = (rng.choice(3000, 1500, replace=False).astype(np.uint32) * 64
                + rng.integers(0, 3, 1500).astype(np.uint32))
        cfg = dataclasses.replace(SMALL, hash_fn="identity", max_chain=8)
    elif name == "mined_one_bucket":
        keys = one_bucket_keys(300, 64)
        cfg = SMALL
    elif name == "duplicates":
        base = _unique(rng, 3000)
        keys = rng.choice(base, 8000)                # every key several times
        cfg = SMALL
    elif name == "arena_too_small":      # overflow pages and chains dropped
        keys = _unique(rng, 14000)
        cfg = dataclasses.replace(SMALL, overflow_pages=8, max_chain=3)
    else:
        raise KeyError(name)
    vals = rng.integers(0, 2**32, size=len(keys), dtype=np.uint64) \
        .astype(np.uint32)
    return cfg, keys, vals


BUILD_CASES = ["murmur_chains", "mult_shift_skew", "identity_forced_chains",
               "mined_one_bucket", "duplicates", "arena_too_small"]
