"""Parity of the port's model families with the JAX package's: jamba-v0.1-52b,
and ``count_params`` of the moe and hybrid full configs, in float32 on the
same parameters and inputs. The cases and tolerances are in
``tests/families_cases.py``."""
import pytest

from repro.configs import get_config as j_get_config
from repro.models import model as jmodel

from repro_torch.configs import get_config
from repro_torch.models import model

import torch_threads
import families_cases

no_grad = families_cases.no_grad
fam = families_cases.fam_fixture("jamba-v0.1-52b")
test_forward_logits_match_jax = families_cases.test_forward_logits_match_jax
test_loss_fn_and_aux_match_jax = families_cases.test_loss_fn_and_aux_match_jax
test_decode_step_matches_jax_step_by_step = families_cases.test_decode_step_matches_jax_step_by_step
test_decode_matches_forward = families_cases.test_decode_matches_forward
test_params_round_trip_on_the_unit_trees = families_cases.test_params_round_trip_on_the_unit_trees

one_thread = torch_threads.one_thread

ARCHS = ["olmoe-1b-7b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_full_configs_match_jax(arch):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    for active in (False, True):
        assert model.count_params(cfg, active) == \
            jmodel.count_params(jcfg, active)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.active_param_count() < cfg.param_count()
