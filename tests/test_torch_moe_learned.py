"""Parity of the port's MoE FFN with the JAX package's under learned routing,
at ``smoke_config`` of olmoe-1b-7b, jamba-v0.1-52b and
llama4-maverick-400b-a17b; the cases and tolerances are in
``tests/moe_cases.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import moe

import torch_threads
import moe_cases
from moe_cases import t

case = moe_cases.case_fixture(*((a, "learned") for a in moe_cases.ARCHS))
test_routing_and_keep_masks_exact = moe_cases.test_routing_and_keep_masks_exact
test_outputs_and_aux_match_jax = moe_cases.test_outputs_and_aux_match_jax
test_gradients_match_jax = moe_cases.test_gradients_match_jax

one_thread = torch_threads.one_thread


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_is_jax_scatter_add(dtype):
    """The combine adds a token's k rows in JAX's CPU scatter-add order:
    bit-equal to a jitted ``zeros.at[t_s].add(contrib)``."""
    rng = np.random.default_rng(8)
    T, k, E, d = 64, 4, 8, 32
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    order, _, _ = moe.dispatch(smoke_config("olmoe-1b-7b"), t(idx), T)
    t_s = np.repeat(np.arange(T), k)[order.numpy()]
    c = (rng.standard_normal((T * k, d)) * 10).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax.jit(lambda c: jnp.zeros((T, d), jdt).at[t_s].add(
        c.astype(jdt)))(c).astype(jnp.float32)
    got = moe.combine(t(c).to(tdt), order, T, k)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want))
