"""Parity of the port's model zoo with the JAX package's: ``forward`` and
``decode_step`` logits and KV pools of llama3-8b and qwen3-8b, and the ssm,
encdec and vlm families built and run. The tolerances are in
``tests/models_cases.py``."""
import pytest
import torch

from repro_torch.configs import ShapeConfig, smoke_config
from repro_torch.models import model, transformer

import torch_threads
import models_cases
from models_cases import CPU

no_grad = models_cases.no_grad
run = models_cases.run_fixture(*models_cases.SCENARIOS[0:2])
test_forward_logits_match_jax = models_cases.test_forward_logits_match_jax
test_decode_logits_and_pools_match_jax = models_cases.test_decode_logits_and_pools_match_jax
test_port_decode_matches_port_forward = models_cases.test_port_decode_matches_port_forward

one_thread = torch_threads.one_thread


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "whisper-tiny",
                                  "internvl2-2b"])
def test_remaining_families_build_and_run(arch):
    """The ssm, encdec and vlm families (which raised NotImplementedError
    before they were ported) build, run forward and decode one step; their
    decode states are the mLSTM/sLSTM states, or the paged pools and the
    cross K/V."""
    cfg = smoke_config(arch)
    m = model.init_params(cfg, device=CPU)
    specs = model.input_specs(cfg, ShapeConfig("t", 16, 1, "train"))
    batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
             specs.items()}
    x, aux = model.forward(m, cfg, batch)
    S = 16
    assert x.shape == (1, S, cfg.d_model) and bool(torch.isfinite(x).all())
    assert aux == {}
    ctx = transformer.DecodeCtx(8, 2, 4)
    frames = torch.zeros((2, 8, cfg.d_model)) if cfg.is_encoder_decoder \
        else None
    states = model.init_decode_states(m, cfg, 2, ctx, enc_frames=frames)
    want = [{"k_pool", "v_pool", "ek", "ev"}] * cfg.num_layers \
        if cfg.is_encoder_decoder else [
            {"mlstm": {"C", "n", "m"}, "slstm": {"c", "n", "h", "m"},
             "attn": {"k_pool", "v_pool"}}[transformer.layer_kind(cfg, i)]
            for i in range(cfg.num_layers)]
    assert [set(s) for s in states] == want
    logits, _ = model.decode_step(
        m, cfg, states, torch.zeros((2, 1), dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32),
        torch.arange(4, dtype=torch.int32).reshape(2, 2), ctx)
    assert logits.shape == (2, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
