"""Parity of the port's model families with the JAX package's: internvl2-2b,
and ``count_params`` of the ssm, encdec and vlm full configs, in float32 on
the same parameters and inputs. The cases and tolerances are in
``tests/families_cases.py``."""
import pytest

from repro.configs import get_config as j_get_config
from repro.models import model as jmodel

from repro_torch.configs import get_config
from repro_torch.models import model

import torch_threads
import families_cases

no_grad = families_cases.no_grad
rest = families_cases.rest_fixture("internvl2-2b")
test_remaining_families_forward_logits_match_jax = families_cases.test_remaining_families_forward_logits_match_jax
test_remaining_families_loss_fn_matches_jax = families_cases.test_remaining_families_loss_fn_matches_jax
test_remaining_families_decode_step_matches_jax = families_cases.test_remaining_families_decode_step_matches_jax
test_remaining_families_decode_matches_forward = families_cases.test_remaining_families_decode_matches_forward
test_remaining_families_params_round_trip = families_cases.test_remaining_families_params_round_trip

one_thread = torch_threads.one_thread

# ---------------------------------------------------------------------------
# The ssm, encdec and vlm families
# ---------------------------------------------------------------------------
REST = ["xlstm-1.3b", "whisper-tiny", "internvl2-2b"]

# full configs: 48 layers d 2048; 4 + 4 layers d 384; 24 layers d 2048
FULL_COUNTS = {"xlstm-1.3b": 1_491_748_864, "whisper-tiny": 36_486_912,
               "internvl2-2b": 1_889_634_304}


@pytest.mark.parametrize("arch", REST)
def test_count_params_of_the_remaining_families_match_jax(arch):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    n = model.count_params(cfg)
    assert n == jmodel.count_params(jcfg) == FULL_COUNTS[arch]
    assert model.count_params(cfg, True) == n == cfg.param_count() == \
        cfg.active_param_count()
