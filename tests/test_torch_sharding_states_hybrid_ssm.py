"""The port's decode state placement (``distributed.steps.decode_state_specs``)
against the JAX package's for jamba-v0.1-52b and xlstm-1.3b on every mesh of
``tests/sharding_cases.py``."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ServeConfig as JServeConfig
from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.distributed import steps as jsteps
from repro.models import model as jmodel
from repro.models import transformer as jtransformer

from repro_torch.configs import ServeConfig, ShapeConfig, smoke_config
from repro_torch.distributed import steps
from repro_torch.models import model, transformer

import torch_threads
from sharding_cases import MESHES, amesh, flat_specs, shape_of

one_thread = torch_threads.one_thread


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b"])
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
