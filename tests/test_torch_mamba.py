"""Parity of the port's mamba block (``repro_torch.models.mamba``) with the
JAX package's ``models/mamba.py`` at ``smoke_config("jamba-v0.1-52b")``
(d_model 128, d_inner 256, N 16, conv width 4), on the same parameters
(JAX's ``init`` carried across) and inputs: the chunked scan ``apply`` at
chunks 4 and 16, the in-chunk ``associative_scan``, ``decode_step`` and its
states step by step, and the port's chunked scan against its own
recurrence (JAX's ``tests/test_blocks.py::
test_mamba_chunked_equals_recurrent``).

Tolerances, float32.  The port's scan is JAX's ``lax.associative_scan``
recursion, the same combines on the same halves; XLA's CPU compiler
contracts ``a2 * b1 + b2`` into a fused multiply-add, so under ``jax.jit``
the scan differs in the last bits (observed <= 9.6e-7 at L = 64 on values
of std ~1, the products bit-equal).  ``apply`` and ``decode_step`` outputs
within rtol 1e-5, atol 1e-6 (observed <= 6.8e-8 on outputs of std 0.07);
the SSM state within 1e-5 of its largest magnitude (observed 5.6e-7 of
it); the conv state, a copy of the inputs, exact.  Chunked against
recurrent: JAX's own rtol 2e-4, atol 2e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import mamba as jmamba
from repro.models.layers import split_params

from repro_torch.configs import smoke_config
from repro_torch.models import mamba

import torch_threads

one_thread = torch_threads.one_thread

B, S = 2, 32
TOL = dict(rtol=1e-5, atol=1e-6)


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.fixture(scope="module", autouse=True)
def no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def block():
    jcfg = j_smoke_config("jamba-v0.1-52b")
    cfg = smoke_config("jamba-v0.1-52b")
    jp, _ = split_params(jmamba.init(jax.random.PRNGKey(2), jcfg))
    m = mamba.Mamba(cfg, device="cpu")
    for name, p in m.named_parameters():
        p.copy_(t(jp[name]))
    x = (np.random.default_rng(3).standard_normal((B, S, cfg.d_model))
         * 0.5).astype(np.float32)
    return jcfg, cfg, jp, m, x


def test_init_constants_match_jax():
    jcfg = j_smoke_config("jamba-v0.1-52b")
    cfg = smoke_config("jamba-v0.1-52b")
    jp, _ = split_params(jmamba.init(jax.random.PRNGKey(0), jcfg))
    m = mamba.init(cfg, torch.Generator().manual_seed(0), "cpu")
    for name in ("A_log", "dt_bias", "D", "conv_b"):
        np.testing.assert_array_equal(getattr(m, name).detach().numpy(),
                                      np.asarray(jp[name]), name)
    for name, p in m.named_parameters():
        assert tuple(p.shape) == jp[name].shape, name


@pytest.mark.parametrize("L", [2, 7, 64])
def test_associative_scan_is_jax_s(L):
    rng = np.random.default_rng(L)
    a = rng.uniform(0.5, 1.0, (2, L, 8, 4)).astype(np.float32)
    b = rng.standard_normal((2, L, 8, 4)).astype(np.float32)

    def comb(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]
    ja, jb = jax.jit(lambda a, b: jax.lax.associative_scan(
        comb, (a, b), axis=1))(a, b)
    ta, tb = mamba.associative_scan(t(a), t(b))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("chunk", [4, 16])
def test_apply_matches_jax(block, chunk):
    jcfg, cfg, jp, m, x = block
    want = np.asarray(jax.jit(lambda p, x: jmamba.apply(
        p, jcfg, x, chunk=chunk))(jp, jnp.asarray(x)))
    got = mamba.apply(m, cfg, t(x), chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_step_matches_jax(block):
    jcfg, cfg, jp, m, x = block
    step = jax.jit(lambda p, st, x: jmamba.decode_step(p, jcfg, st, x))
    jst, st = jmamba.init_state(jcfg, B), mamba.init_state(cfg, B,
                                                           device="cpu")
    for i in range(S):
        jy, jst = step(jp, jst, jnp.asarray(x[:, i:i + 1]))
        y, st = mamba.decode_step(m, cfg, st, t(x[:, i:i + 1]))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_array_equal(st["conv"].numpy(),
                                      np.asarray(jst["conv"]))
        js = np.asarray(jst["ssm"])
        assert np.abs(st["ssm"].numpy() - js).max() <= \
            1e-5 * np.abs(js).max(), i


def test_decode_conv_state_takes_the_input_dtype(block):
    """JAX's ``_conv`` returns the state in the activations' dtype, so a
    bfloat16 step turns the float32 zeros of ``init_state`` bfloat16."""
    jcfg, cfg, jp, m, x = block
    jy, jst = jmamba.decode_step(jp, jcfg, jmamba.init_state(jcfg, B),
                                 jnp.asarray(x[:, :1], jnp.bfloat16))
    y, st = mamba.decode_step(m, cfg, mamba.init_state(cfg, B, device="cpu"),
                              t(x[:, :1]).to(torch.bfloat16))
    assert jst["conv"].dtype == jnp.bfloat16 and \
        st["conv"].dtype == torch.bfloat16
    assert jst["ssm"].dtype == jnp.float32 and st["ssm"].dtype == torch.float32
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16


def test_chunked_equals_recurrent(block):
    _, cfg, _, m, x = block
    y_c = mamba.apply(m, cfg, t(x), chunk=8)
    st = mamba.init_state(cfg, B, device="cpu")
    ys = []
    for i in range(S):
        y, st = mamba.decode_step(m, cfg, st, t(x[:, i:i + 1]))
        ys.append(y)
    np.testing.assert_allclose(y_c.numpy(), torch.cat(ys, 1).numpy(),
                               rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match="multiple"):
        mamba.apply(m, cfg, t(x), chunk=12)
