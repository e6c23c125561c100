"""Parity of the port's model zoo with the JAX package's: ``forward`` and
``decode_step`` logits and KV pools of phi4-mini-3.8b and h2o-danube-1.8b,
and the moe and hybrid families built and run. The tolerances are in
``tests/models_cases.py``."""
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import model, transformer

import torch_threads
import models_cases
from models_cases import CPU

no_grad = models_cases.no_grad
run = models_cases.run_fixture(*models_cases.SCENARIOS[2:4])
test_forward_logits_match_jax = models_cases.test_forward_logits_match_jax
test_decode_logits_and_pools_match_jax = models_cases.test_decode_logits_and_pools_match_jax
test_port_decode_matches_port_forward = models_cases.test_port_decode_matches_port_forward

one_thread = torch_threads.one_thread


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-v0.1-52b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_and_hybrid_families_build_and_run(arch):
    """The moe and hybrid families build, run forward and decode one step,
    with the MoE aux terms."""
    cfg = smoke_config(arch)
    m = model.init_params(cfg, device=CPU)
    x, aux = model.forward(m, cfg, {"tokens": torch.zeros((1, 16),
                                                          dtype=torch.int64)})
    assert x.shape == (1, 16, cfg.d_model) and bool(torch.isfinite(x).all())
    assert set(aux) == {"moe_aux", "moe_z", "moe_dropped"}
    states = transformer.init_decode_states(
        cfg, 2, transformer.DecodeCtx(8, 2, 4), device=CPU)
    kinds = [transformer.layer_kind(cfg, i) for i in range(cfg.num_layers)]
    assert [set(s) for s in states] == [
        {"k_pool", "v_pool"} if k == "attn" else {"conv", "ssm"}
        for k in kinds]
    logits, _ = model.decode_step(
        m, cfg, states, torch.zeros((2, 1), dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32),
        torch.arange(4, dtype=torch.int32).reshape(2, 2),
        transformer.DecodeCtx(8, 2, 4))
    assert logits.shape == (2, 1, cfg.padded_vocab)
