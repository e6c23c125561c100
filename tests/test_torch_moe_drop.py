"""Parity of the port's MoE FFN with the JAX package's under a drop case
(``capacity_factor`` 0.25), at ``smoke_config`` of olmoe-1b-7b,
jamba-v0.1-52b and llama4-maverick-400b-a17b; the cases and tolerances are
in ``tests/moe_cases.py``."""
import torch_threads
import moe_cases

case = moe_cases.case_fixture(*((a, "drop") for a in moe_cases.ARCHS))
test_routing_and_keep_masks_exact = moe_cases.test_routing_and_keep_masks_exact
test_outputs_and_aux_match_jax = moe_cases.test_outputs_and_aux_match_jax
test_gradients_match_jax = moe_cases.test_gradients_match_jax

one_thread = torch_threads.one_thread
