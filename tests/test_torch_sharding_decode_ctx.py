"""The port's decode geometry (``models.model.make_decode_ctx``) against the
JAX package's on every mesh of ``tests/sharding_cases.py``."""
import math

import pytest

from repro.configs import ServeConfig as JServeConfig
from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import model as jmodel

from repro_torch.configs import ServeConfig, ShapeConfig, smoke_config
from repro_torch.distributed import sharding, steps
from repro_torch.models import model

import torch_threads
from sharding_cases import MESHES, amesh, shape_of

one_thread = torch_threads.one_thread

CTX_FIELDS = ("page_tokens", "n_pages", "pool_pages", "batch_axes",
              "channel_axes", "pages_per_shard")

GEOMETRY = [("llama3-8b", 256, 32, 4), ("llama3-8b", 100, 16, 3),
            ("qwen3-8b", 4096, 32, 16), ("qwen3-8b", 64, 32, 1),
            ("h2o-danube-1.8b", 8192, 32, 2), ("h2o-danube-1.8b", 40, 8, 2),
            ("jamba-v0.1-52b", 32, 64, 8)]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_make_decode_ctx_matches_jax(mesh):
    """The geometry of every case, and a rank's pool slice: the pools'
    spec splits the pages over every axis, ``pages_per_shard`` a rank."""
    for arch, horizon, pt, B in GEOMETRY:
        jcfg, cfg = j_smoke_config(arch), smoke_config(arch)
        jctx = jmodel.make_decode_ctx(jcfg, JServeConfig(
            model=jcfg, shape=JShapeConfig("t", horizon, B, "decode"),
            kv_page_tokens=pt), B, mesh=amesh(mesh))
        ctx = model.make_decode_ctx(cfg, ServeConfig(
            model=cfg, shape=ShapeConfig("t", horizon, B, "decode"),
            kv_page_tokens=pt), B, mesh=shape_of(mesh))
        key = (arch, horizon, pt, B)
        assert {f: getattr(ctx, f) for f in CTX_FIELDS} == \
            {f: getattr(jctx, f) for f in CTX_FIELDS}, key
        assert ctx.sharded == jctx.sharded and not ctx.ranked
        n = math.prod(shape_of(mesh).values())
        assert ctx.pages_per_shard * n == ctx.pool_pages
        pool = (ctx.pool_pages, ctx.page_tokens, cfg.num_kv_heads,
                cfg.head_dim)
        spec = sharding.spec_for(shape_of(mesh), steps._STATE_AXES[
            ("k_pool", 4)], pool)
        assert spec[0] == tuple(a for a in MESHES[mesh][1]
                                if shape_of(mesh)[a] > 0)
        assert sharding.local_shape(pool, spec, shape_of(mesh)) == \
            (ctx.pages_per_shard,) + pool[1:]
