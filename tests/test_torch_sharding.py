"""The port's sharding rules (``repro_torch.distributed.sharding``), decode
state placement (``distributed.steps.decode_state_specs``) and decode
geometry (``models.model.make_decode_ctx``) against the JAX package's, on
``jax.sharding.AbstractMesh`` shapes (1, 4), (2, 2), (4, 1), (2, 4) and
("pod", "data", "model") = (2, 2, 2), and on the production shapes: no
ranks, no devices.  Every arch of ``configs``, at its smoke and its
published size: the logical axes and shapes of every leaf equal JAX's, and
JAX's ``param_specs`` equals the port's on the (2, 2) mesh (JAX's runs an
``eval_shape`` of the whole init, a second or so an arch), and JAX's
``spec_for`` of JAX's own axes equals the port's ``param_specs`` on every
other mesh.  Specs compare as ``tuple(PartitionSpec)``."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import ServeConfig as JServeConfig
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.distributed import sharding as jsh
from repro.distributed import steps as jsteps
from repro.launch import mesh as jmesh
from repro.models import model as jmodel
from repro.models import transformer as jtransformer

from repro_torch.configs import (ARCHS, ServeConfig, ShapeConfig, get_config,
                                 smoke_config)
from repro_torch.distributed import sharding, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model, transformer

import torch_threads

one_thread = torch_threads.one_thread

MESHES = {"1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CTX_FIELDS = ("page_tokens", "n_pages", "pool_pages", "batch_axes",
              "channel_axes", "pages_per_shard")


def amesh(name):
    return AbstractMesh(*MESHES[name])


def shape_of(name) -> dict:
    sizes, axes = MESHES[name]
    return dict(zip(axes, sizes))


def flat_specs(tree) -> dict:
    """{"a/b/c": tuple(spec)} of a JAX spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {"/".join(p.key for p in path): tuple(s) for path, s in leaves}


def flat_leaves(tree, is_leaf=None) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(p.key for p in path): v for path, v in leaves}


def configs(arch, size):
    if size == "smoke":
        return j_smoke_config(arch), smoke_config(arch)
    return j_get_config(arch), get_config(arch)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_and_mesh_axes_match_jax(mesh):
    """Random logical axes and shapes, divisible or not, on each mesh."""
    rng = np.random.default_rng(len(mesh))
    names = list(sharding.RULES) + ["unknown"]
    am = amesh(mesh)
    for name in names:
        assert sharding.mesh_axes_for(shape_of(mesh), name) == \
            jsh.mesh_axes_for(am, name)
    for _ in range(300):
        n = int(rng.integers(1, 5))
        axes = tuple(rng.choice(names, n))
        shape = tuple(int(x) for x in rng.choice([1, 2, 3, 4, 6, 8, 16, 24],
                                                 n))
        assert sharding.spec_for(shape_of(mesh), axes, shape) == \
            tuple(jsh.spec_for(am, jax_axes(axes), shape)), (axes, shape)


def jax_axes(axes):
    from repro.models.layers import Axes
    return Axes(tuple(axes))


@pytest.mark.parametrize("size", ["smoke", "published"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_shapes_and_specs_match_jax(arch, size):
    jcfg, cfg = configs(arch, size)
    want_axes = flat_leaves(jmodel.param_axes(jcfg),
                            is_leaf=lambda x: isinstance(x, tuple))
    assert model.param_axes(cfg) == {k: tuple(v)
                                     for k, v in want_axes.items()}
    jspecs = flat_specs(jsh.param_specs(jcfg, amesh("2x2")))
    shapes = model.param_shapes(cfg)
    assert set(shapes) == set(want_axes) == set(jspecs)
    assert sharding.param_specs(cfg, shape_of("2x2")) == jspecs
    for name in MESHES:
        am = amesh(name)
        want = {k: tuple(jsh.spec_for(am, a, shapes[k]))
                for k, a in want_axes.items()}
        assert sharding.param_specs(cfg, shape_of(name)) == want, name
    for multi_pod in (False, True):
        prod = make_production_mesh(multi_pod=multi_pod)
        assert prod == shape_of_jax(multi_pod)
        got = sharding.param_specs(cfg, prod)
        assert got == {k: tuple(jsh.spec_for(FakeMesh(prod), a, shapes[k]))
                       for k, a in want_axes.items()}


class FakeMesh:
    """The two attributes of a mesh that JAX's ``spec_for`` reads, for the
    production shapes (256 and 512 devices are not here)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def shape_of_jax(multi_pod):
    """The shape JAX's ``make_production_mesh`` asks ``jax.make_mesh``
    for."""
    seen = {}

    def fake(shape, axes):
        seen.update(zip(axes, shape))
    orig = jmesh._make_mesh_compat
    jmesh._make_mesh_compat = fake
    try:
        jmesh.make_production_mesh(multi_pod=multi_pod)
    finally:
        jmesh._make_mesh_compat = orig
    return seen


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_and_batch_specs_match_jax(mesh):
    am = amesh(mesh)
    for B in (1, 2, 3, 4, 6, 8, 16):
        got = sharding.batch_spec(shape_of(mesh), B)
        assert got == jsh.batch_spec(am, B), B
        batch = {"tokens": np.zeros((B, 8), np.int32),
                 "labels": np.zeros((B, 8), np.int32),
                 "patch_embeds": np.zeros((B, 4, 16), np.float32)}
        want = {k: tuple(v) for k, v in
                jsh.batch_specs(None, am, batch).items()}
        assert sharding.batch_specs(None, shape_of(mesh), batch) == want


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


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["qwen3-8b", "olmoe-1b-7b",
                                  "jamba-v0.1-52b", "xlstm-1.3b"])
def test_decode_state_specs_match_jax(arch, mesh):
    """Each layer's states, placed as JAX places its stacked ones (the
    pools by page over the whole mesh, the recurrent states by batch)."""
    jcfg, cfg = j_smoke_config(arch), smoke_config(arch)
    B, horizon, pt = 4, 64, 8
    jctx = jmodel.make_decode_ctx(jcfg, JServeConfig(
        model=jcfg, shape=JShapeConfig("t", horizon, B, "decode"),
        kv_page_tokens=pt), B, mesh=amesh(mesh))
    jstates = jax.eval_shape(lambda: jtransformer.init_decode_states(
        jcfg, B, jctx, jnp.float32))
    want = flat_specs(jsteps.decode_state_specs(jstates, amesh(mesh)))
    ctx = model.make_decode_ctx(cfg, ServeConfig(
        model=cfg, shape=ShapeConfig("t", horizon, B, "decode"),
        kv_page_tokens=pt), B, mesh=shape_of(mesh))
    states = transformer.init_decode_states(cfg, B, ctx, torch.float32,
                                            device="cpu")
    got = steps.decode_state_specs(states, shape_of(mesh))
    unit = transformer.scan_unit_size(cfg)
    for i, layer in enumerate(got):
        for name, spec in layer.items():
            w = want[f"j{i % unit}/{name}"]
            assert w[:1] in ((), (None,)), w
            assert spec == w[1:], (i, name)
