"""The shared part of the port's checkpoint tests: the JAX hashmap's table
calls jitted while a file runs, trees and their checks, and the JAX train
state."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import HashMemConfig as JHashMemConfig
from repro.core import hashmap as jhashmap
from repro.models import model as jmodel
from repro.optim import init_opt_state as j_init_opt_state

from repro_torch.configs import HashMemConfig
from repro_torch.models import model
from repro_torch.models.layers import flatten_tree

from model import mine_bucket_colliding_keys
from test_checkpoint import _displaced_cfg as _j_displaced_cfg
from paged_kv_cases import jitted_jax_page_table

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_tables():
    """The JAX hashmap calls the tables below make, jitted (eager JAX
    compiles every primitive anew), and its probe."""
    mp = jitted_jax_page_table()
    mp.setattr(jhashmap, "probe", jax.jit(jhashmap.probe,
                                          static_argnames=("backend",)))
    yield
    mp.undo()


def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((16, 8), generator=g),
            "b": {"c": torch.arange(10, dtype=torch.int32),
                  "d": torch.tensor(3.5)}}


# ---------------------------------------------------------------------------
# JAX saves, the port restores
# ---------------------------------------------------------------------------
def j_train_state(cfg, oc, seed=0):
    params = jmodel.init_params(cfg, jax.random.PRNGKey(seed))
    opt = j_init_opt_state(params, oc)
    # moments that are not zeros, so the restore is seen to carry them
    opt["m"] = jax.tree.map(lambda p: (p * 0.5).astype(opt_dtype(oc)), params)
    opt["v"] = jax.tree.map(lambda p: (p * p).astype(opt_dtype(oc)), params)
    opt["step"] = jnp.int32(17)
    return {"params": params, "opt": opt}


def opt_dtype(oc):
    return jnp.bfloat16 if oc.state_dtype == "bfloat16" else jnp.float32


def port_moments(pd) -> dict:
    """A ParamDict of moments as {JAX path: array}, layers stacked, bits of
    bfloat16 as uint16."""
    out = {}
    for path, (names, stacked) in model.jax_leaves(pd).items():
        ts = [pd[n] for n in names]
        ts = [t.view(torch.int16).numpy().view(np.uint16)
              if t.dtype == torch.bfloat16 else t.numpy() for t in ts]
        out[path] = np.stack(ts) if stacked else ts[0]
    return out


def j_moments(tree) -> dict:
    return flatten_tree(jax.tree.map(
        lambda x: np.asarray(x).view(np.uint16)
        if x.dtype == jnp.bfloat16 else np.asarray(x), tree))


def j_table_leaves(jhm) -> dict:
    st = jhm.store
    out = {"bucket_head": jhm.bucket_head}
    for f in ("pool", "planes", "page_next", "page_fill", "free_top",
              "fprints", "stash", "stash_fill", "local_depth"):
        if getattr(st, f) is not None:
            out[f] = getattr(st, f)
    return {k: np.asarray(v) for k, v in out.items()}


def port_cfg(jcfg) -> HashMemConfig:
    import dataclasses
    return HashMemConfig(**dataclasses.asdict(jcfg))


@functools.cache
def displaced_jax_table(scale: int):
    """JAX's displaced table of 36 keys colliding on one bucket, valued
    ``scale`` times 1..36 (built once a module: JAX's tables are values)."""
    jcfg = _j_displaced_cfg()
    keys = mine_bucket_colliding_keys(36, jcfg.num_buckets, same_b2=True)
    vals = np.arange(1, 37, dtype=np.uint32) * scale
    jhm, ok = jhashmap.insert(jhashmap.create(jcfg), jnp.asarray(keys),
                              jnp.asarray(vals))
    assert bool(np.asarray(ok).all())
    return jcfg, keys, jhm


@functools.cache
def extendible_jax_table():
    jcfg = JHashMemConfig(num_buckets=8, slots_per_page=4, overflow_pages=120,
                          max_chain=2, backend="ref", auto_grow=True,
                          resize="extendible", max_load_factor=1.0)
    keys = mine_bucket_colliding_keys(20, jcfg.num_buckets, same_b2=False)
    events: dict = {}
    jhm, ok = jhashmap.insert_extendible(
        jhashmap.create(jcfg), jnp.asarray(keys),
        jnp.arange(1, 21, dtype=jnp.uint32), events=events)
    assert bool(np.asarray(ok).all()) and events.get("splits", 0) >= 1
    return jhm, keys
