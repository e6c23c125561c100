"""Parity of the port's model zoo with the JAX package's: ``forward`` and
``decode_step`` logits and KV pools of h2o-danube-1.8b under a sliding
window and of qwen3-8b in bfloat16, and ``make_decode_ctx`` on more than one
shard. The tolerances are in ``tests/models_cases.py``."""
import pytest

from repro.configs import ServeConfig as JServeConfig
from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import model as jmodel

from repro_torch.configs import ServeConfig, ShapeConfig, smoke_config
from repro_torch.models import model

import torch_threads
import models_cases
from models_cases import CTX_FIELDS

no_grad = models_cases.no_grad
run = models_cases.run_fixture(*models_cases.SCENARIOS[4:6])
test_forward_logits_match_jax = models_cases.test_forward_logits_match_jax
test_decode_logits_and_pools_match_jax = models_cases.test_decode_logits_and_pools_match_jax
test_port_decode_matches_port_forward = models_cases.test_port_decode_matches_port_forward

one_thread = torch_threads.one_thread


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2), (1, 4)])
def test_make_decode_ctx_on_more_than_one_shard_matches_jax(shape):
    """A mesh of more than one shard gives JAX's geometry: batch groups
    where the batch divides, the page halved while the channels outnumber
    a sequence's pages, pages and pool rounded up to the channels and
    shards (``tests/test_torch_sharding.py`` covers more meshes)."""
    from jax.sharding import AbstractMesh
    jmesh = AbstractMesh(shape, ("data", "model"))
    for arch, horizon, pt, batch in [("llama3-8b", 64, 8, 4),
                                     ("llama3-8b", 100, 64, 3),
                                     ("h2o-danube-1.8b", 40, 8, 2)]:
        jcfg, cfg = j_smoke_config(arch), smoke_config(arch)
        jctx = jmodel.make_decode_ctx(jcfg, JServeConfig(
            model=jcfg, shape=JShapeConfig("t", horizon, batch, "decode"),
            kv_page_tokens=pt), batch, mesh=jmesh)
        ctx = model.make_decode_ctx(cfg, ServeConfig(
            model=cfg, shape=ShapeConfig("t", horizon, batch, "decode"),
            kv_page_tokens=pt), batch, mesh=dict(jmesh.shape))
        assert {f: getattr(ctx, f) for f in CTX_FIELDS} == \
            {f: getattr(jctx, f) for f in CTX_FIELDS}
        assert ctx.sharded and jctx.sharded
