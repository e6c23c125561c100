"""Parity of the port's model families with the JAX package's: xlstm-1.3b and
whisper-tiny, in float32 on the same parameters and inputs. The cases and
tolerances are in ``tests/families_cases.py``."""
import torch_threads
import families_cases

no_grad = families_cases.no_grad
rest = families_cases.rest_fixture("xlstm-1.3b", "whisper-tiny")
test_remaining_families_forward_logits_match_jax = families_cases.test_remaining_families_forward_logits_match_jax
test_remaining_families_loss_fn_matches_jax = families_cases.test_remaining_families_loss_fn_matches_jax
test_remaining_families_decode_step_matches_jax = families_cases.test_remaining_families_decode_step_matches_jax
test_remaining_families_decode_matches_forward = families_cases.test_remaining_families_decode_matches_forward
test_remaining_families_params_round_trip = families_cases.test_remaining_families_params_round_trip

one_thread = torch_threads.one_thread
