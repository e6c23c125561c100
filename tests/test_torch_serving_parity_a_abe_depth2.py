"""Serving parity with the JAX package, scenario ``a_ABE_depth2``: YCSB A, B
and E on one shard at pipeline depth 2. The scenario and its six tests are
in ``tests/serving_parity_cases.py``."""
import serving_parity_cases as cases
import torch_threads

one_thread = torch_threads.one_thread
jitted_jax_loops = cases.jitted_jax_loops
scenario = cases.scenario_fixture("a_ABE_depth2")
test_results_equal = cases.test_results_equal
test_schedule_equal = cases.test_schedule_equal
test_deterministic_metrics_equal = cases.test_deterministic_metrics_equal
test_tables_equal = cases.test_tables_equal
test_schedule_replays_against_dict_model = \
    cases.test_schedule_replays_against_dict_model
test_scenarios_exercise_their_paths = cases.test_scenarios_exercise_their_paths
