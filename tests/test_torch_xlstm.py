"""Parity of the port's xLSTM blocks (``repro_torch.models.xlstm``) with the
JAX package's ``models/xlstm.py`` at ``smoke_config("xlstm-1.3b")``
(d_model 128, 4 heads of 32, sLSTM post-MLP 192 wide), on the same
parameters (JAX's ``init_mlstm``/``init_slstm`` carried across) and inputs:
``apply_mlstm`` at chunks 4, 16 and 64 and with ``mlstm_scan_groups=2``
(the two-level remat), each with its gradients against ``jax.grad``;
``apply_slstm`` and its gradients; ``decode_mlstm`` and ``decode_slstm``
and their states step by step; and, in the port alone, the chunked forms
against the recurrences (JAX's ``tests/test_blocks.py``).

Tolerances, float32, from the summation orders of the einsums and the
cumulative sums: outputs within rtol = atol = 5e-4, JAX's decode
tolerance (observed <= 1.7e-6 on outputs up to 2.7 in magnitude);
gradients within 1e-5 of their leaf's largest magnitude (observed <=
3.1e-6 of it); the decode states within rtol = atol = 5e-4 (observed <=
1.7e-6 on states up to 4.5).  Chunked against recurrent in the port:
JAX's own rtol 2e-4, atol 2e-5 (observed <= 5.7e-7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import xlstm as jxlstm
from repro.models.layers import split_params

from repro_torch.configs import smoke_config
from repro_torch.models import xlstm

import torch_threads

one_thread = torch_threads.one_thread

B, S = 2, 64
TOL = dict(rtol=5e-4, atol=5e-4)
GRAD_TOL = 1e-5


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.fixture(scope="module", autouse=True)
def no_grad():
    with torch.no_grad():
        yield


def carried(cls, cfg, jp):
    m = cls(cfg, device="cpu")
    for name, p in m.named_parameters():
        p.copy_(t(jp[name]))
    return m


@pytest.fixture(scope="module")
def blocks():
    jcfg = j_smoke_config("xlstm-1.3b")
    cfg = smoke_config("xlstm-1.3b")
    jm, _ = split_params(jxlstm.init_mlstm(jax.random.PRNGKey(0), jcfg))
    js, _ = split_params(jxlstm.init_slstm(jax.random.PRNGKey(4), jcfg))
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
    w = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, js=js, x=x, w=w,
                m=carried(xlstm.MLSTM, cfg, jm),
                s=carried(xlstm.SLSTM, cfg, js))


def grads_match(module, jgrads, jgx, gx):
    for name, p in module.named_parameters():
        want = np.asarray(jgrads[name])
        assert np.abs(p.grad.numpy() - want).max() <= \
            GRAD_TOL * np.abs(want).max(), name
    want = np.asarray(jgx)
    assert np.abs(gx.numpy() - want).max() <= GRAD_TOL * np.abs(want).max()


def port_value_and_grad(module, fn, x, w):
    """fn(module, x) and the gradients of sum(fn * w) by the parameters
    (left in ``.grad``) and by x."""
    with torch.enable_grad():
        module.zero_grad(set_to_none=True)
        tx = t(x).requires_grad_(True)
        y = fn(module, tx)
        (y * t(w)).sum().backward()
    return y.detach(), tx.grad


MLSTM_CASES = {"chunk4": (4, 0), "chunk16": (16, 0), "chunk64": (64, 0),
               "groups2": (None, 2)}


@pytest.mark.parametrize("case", sorted(MLSTM_CASES))
def test_apply_mlstm_and_grads_match_jax(blocks, case):
    chunk, groups = MLSTM_CASES[case]
    jcfg = blocks["jcfg"].replace(mlstm_scan_groups=groups)
    cfg = blocks["cfg"].replace(mlstm_scan_groups=groups)
    x, w = blocks["x"], blocks["w"]

    @jax.jit
    def jax_side(p, x):
        def f(p, x):
            y = jxlstm.apply_mlstm(p, jcfg, x, chunk=chunk)
            return jnp.sum(y * w), y
        (_, y), g = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(p, x)
        return y, g
    jy, (jg, jgx) = jax_side(blocks["jm"], jnp.asarray(x))
    m = blocks["m"]
    y, gx = port_value_and_grad(
        m, lambda p, x: xlstm.apply_mlstm(p, cfg, x, chunk=chunk), x, w)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    grads_match(m, jg, jgx, gx)


def test_apply_slstm_and_grads_match_jax(blocks):
    jcfg, cfg, x, w = blocks["jcfg"], blocks["cfg"], blocks["x"], blocks["w"]

    @jax.jit
    def jax_side(p, x):
        def f(p, x):
            y = jxlstm.apply_slstm(p, jcfg, x)
            return jnp.sum(y * w), y
        (_, y), g = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(p, x)
        return y, g
    jy, (jg, jgx) = jax_side(blocks["js"], jnp.asarray(x))
    s = blocks["s"]
    y, gx = port_value_and_grad(
        s, lambda p, x: xlstm.apply_slstm(p, cfg, x), x, w)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    grads_match(s, jg, jgx, gx)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_states_match_jax_step_by_step(blocks, kind):
    jcfg, cfg, x = blocks["jcfg"], blocks["cfg"], blocks["x"]
    jp, p = (blocks["jm"], blocks["m"]) if kind == "mlstm" else \
        (blocks["js"], blocks["s"])
    jdec = getattr(jxlstm, f"decode_{kind}")
    dec = getattr(xlstm, f"decode_{kind}")
    step = jax.jit(lambda p, st, x: jdec(p, jcfg, st, x))
    jst = getattr(jxlstm, f"init_{kind}_state")(jcfg, B)
    st = getattr(xlstm, f"init_{kind}_state")(cfg, B, device="cpu")
    assert set(st) == set(jst)
    for i in range(16):
        jy, jst = step(jp, jst, jnp.asarray(x[:, i:i + 1]))
        y, st = dec(p, cfg, st, t(x[:, i:i + 1]))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        for name, v in st.items():
            assert v.dtype == torch.float32 and \
                v.shape == jst[name].shape, name
            np.testing.assert_allclose(v.numpy(), np.asarray(jst[name]),
                                       **TOL, err_msg=f"step {i} {name}")


def test_chunked_forms_equal_the_recurrences(blocks):
    cfg, x = blocks["cfg"], t(blocks["x"])
    for kind, apply, kw in (("mlstm", xlstm.apply_mlstm, dict(chunk=16)),
                            ("slstm", xlstm.apply_slstm, {})):
        p = blocks["m"] if kind == "mlstm" else blocks["s"]
        y_c = apply(p, cfg, x, **kw)
        st = getattr(xlstm, f"init_{kind}_state")(cfg, B, device="cpu")
        ys = []
        for i in range(S):
            y, st = getattr(xlstm, f"decode_{kind}")(p, cfg, st,
                                                     x[:, i:i + 1])
            ys.append(y)
        np.testing.assert_allclose(y_c.numpy(), torch.cat(ys, 1).numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=kind)
    with pytest.raises(ValueError, match="multiple"):
        xlstm.apply_mlstm(blocks["m"], cfg, x, chunk=24)


def test_init_matches_jax_s_shapes_and_constants():
    jcfg, cfg = j_smoke_config("xlstm-1.3b"), smoke_config("xlstm-1.3b")
    g = torch.Generator().manual_seed(0)
    for jinit, init in ((jxlstm.init_mlstm, xlstm.init_mlstm),
                        (jxlstm.init_slstm, xlstm.init_slstm)):
        jp, _ = split_params(jinit(jax.random.PRNGKey(0), jcfg))
        p = init(cfg, g, "cpu")
        assert {n: tuple(v.shape) for n, v in p.named_parameters()} == \
            {n: v.shape for n, v in jp.items()}
        for name in ("gn_scale", "bg"):
            if name in jp:
                np.testing.assert_array_equal(
                    getattr(p, name).numpy(), np.asarray(jp[name]), name)
