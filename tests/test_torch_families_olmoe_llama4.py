"""Parity of the port's model families with the JAX package's: olmoe-1b-7b and
llama4-maverick-400b-a17b, in float32 on the same parameters and inputs. The
cases and tolerances are in ``tests/families_cases.py``."""
import torch_threads
import families_cases

no_grad = families_cases.no_grad
fam = families_cases.fam_fixture("olmoe-1b-7b", "llama4-maverick-400b-a17b")
test_forward_logits_match_jax = families_cases.test_forward_logits_match_jax
test_loss_fn_and_aux_match_jax = families_cases.test_loss_fn_and_aux_match_jax
test_decode_step_matches_jax_step_by_step = families_cases.test_decode_step_matches_jax_step_by_step
test_decode_matches_forward = families_cases.test_decode_matches_forward
test_params_round_trip_on_the_unit_trees = families_cases.test_params_round_trip_on_the_unit_trees

one_thread = torch_threads.one_thread
