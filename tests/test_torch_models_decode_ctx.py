"""Parity of the port's model zoo with the JAX package's: ``make_decode_ctx``,
with and without a mesh. The tolerances are in ``tests/models_cases.py``."""
import pytest

from repro.configs import ServeConfig as JServeConfig
from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.mesh import make_mesh
from repro.models import model as jmodel

from repro_torch.configs import ServeConfig, ShapeConfig, smoke_config
from repro_torch.models import model

import torch_threads
import models_cases
from models_cases import CTX_FIELDS

no_grad = models_cases.no_grad

one_thread = torch_threads.one_thread


@pytest.mark.parametrize("arch,horizon,pt,batch", [
    ("llama3-8b", 256, 32, 4), ("llama3-8b", 100, 16, 3),
    ("h2o-danube-1.8b", 8192, 32, 2), ("h2o-danube-1.8b", 40, 8, 2)])
@pytest.mark.parametrize("with_mesh", [False, True])
def test_make_decode_ctx_matches_jax(arch, horizon, pt, batch, with_mesh):
    """The same geometry as JAX's without a mesh and on JAX's serving
    default, a (1, 1) ("data", "model") mesh (the sliding window bounds
    h2o-danube's horizon to window + page)."""
    jcfg, cfg = j_smoke_config(arch), smoke_config(arch)
    jscfg = JServeConfig(model=jcfg, shape=JShapeConfig("t", horizon, batch,
                                                        "decode"),
                         kv_page_tokens=pt)
    scfg = ServeConfig(model=cfg, shape=ShapeConfig("t", horizon, batch,
                                                    "decode"),
                       kv_page_tokens=pt)
    jmesh = make_mesh((1, 1), ("data", "model")) if with_mesh else None
    jctx = jmodel.make_decode_ctx(jcfg, jscfg, batch, mesh=jmesh)
    ctx = model.make_decode_ctx(cfg, scfg, batch,
                                mesh=dict(jmesh.shape) if with_mesh else None)
    assert {f: getattr(ctx, f) for f in CTX_FIELDS} == \
        {f: getattr(jctx, f) for f in CTX_FIELDS}
    assert jctx.sharded == with_mesh
    if cfg.sliding_window:
        assert ctx.n_pages <= (cfg.sliding_window + pt) // pt + 1
