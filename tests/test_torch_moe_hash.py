"""Parity of the port's MoE FFN with the JAX package's under
``router_mode="hash"``, at ``smoke_config`` of olmoe-1b-7b, jamba-v0.1-52b
and llama4-maverick-400b-a17b; the cases and tolerances are in
``tests/moe_cases.py``."""
from repro.configs import smoke_config as j_smoke_config
from repro.models import moe as jmoe

from repro_torch.configs import smoke_config
from repro_torch.models import moe

import torch_threads
import moe_cases
from moe_cases import ARCHS

case = moe_cases.case_fixture(*((a, "hash") for a in moe_cases.ARCHS))
test_routing_and_keep_masks_exact = moe_cases.test_routing_and_keep_masks_exact
test_outputs_and_aux_match_jax = moe_cases.test_outputs_and_aux_match_jax
test_gradients_match_jax = moe_cases.test_gradients_match_jax

one_thread = torch_threads.one_thread


def test_capacity_matches_jax():
    for arch in ARCHS:
        jcfg, cfg = j_smoke_config(arch), smoke_config(arch)
        for T in (1, 7, 16, 32, 4096):
            assert moe._capacity(cfg, T) == jmoe._capacity(jcfg, T)
