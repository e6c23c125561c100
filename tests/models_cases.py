"""Parity of the port's dense model zoo (``repro_torch.models``) with the
JAX package's: the layers, SwiGLU, attention, the parameter bridge, and
``forward`` / ``decode_step`` logits and KV pools of the four dense archs at
``smoke_config``, on the same parameters (JAX's init carried across by
``params_from_numpy``) and the same tokens.

Tolerances.  float32: rtol = atol = 5e-4, the JAX package's own tolerance
for decode against forward (``tests/test_paged_kv.py``); both sides compute
in float32 and differ only in summation order (observed <= 1.1e-6 on logits
of std 0.23, 4.1e-6 on the pools).  bfloat16 (activations, weights cast per
einsum as in JAX): atol 0.05 on logits only.  bfloat16 keeps 8 significant
bits (steps of 2^-8 = 0.39% relative), and the two frameworks round at
different points (XLA fuses float32 chains of norm, RoPE and SiLU), so one
rounding step apart anywhere in the 4 layers moves a logit; observed max
0.0115 on logits of std 0.23.  Integer state and the parameter round trip
are exact.

Three ``tests/test_torch_models_*.py`` files bind ``run`` to two of the
scenarios each, and the three tests below of that fixture.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ServeConfig as JServeConfig
from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import model as jmodel

from repro_torch.configs import ServeConfig, ShapeConfig, smoke_config
from repro_torch.models import model

CPU = "cpu"
TOL = dict(rtol=5e-4, atol=5e-4)
BF16_ATOL = 0.05
DENSE = ["llama3-8b", "qwen3-8b", "phi4-mini-3.8b", "h2o-danube-1.8b"]
B, S, PT = 2, 32, 8


@pytest.fixture(scope="module", autouse=True)
def no_grad():
    """The models' parameters carry gradients (the training stack); these
    tests compare values, so they build no autograd graph."""
    with torch.no_grad():
        yield


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


# ---------------------------------------------------------------------------
# forward and decode_step against JAX, per arch (JAX side once each)
# ---------------------------------------------------------------------------
SCENARIOS = [(a, "float32", 0) for a in DENSE] + [
    ("h2o-danube-1.8b", "float32", 12),   # a window the 32 steps pass
    ("qwen3-8b", "bfloat16", 0)]


def _scenario_id(s):
    return f"{s[0]}-{s[1]}" + (f"-window{s[2]}" if s[2] else "")


def run_fixture(*params):
    """The module-scoped ``run`` fixture over ``params``, (arch, dtype, window)
    scenarios: JAX's and the port's forward and decode on one draw."""
    @pytest.fixture(scope="module", params=params, ids=_scenario_id)
    def run(request):
        """JAX forward logits, decode logits at every step and the final pools;
        the same through the port on the same parameters and tokens."""
        arch, dtype, window = request.param
        kw = dict(remat=False, dtype=dtype)
        if window:
            kw["sliding_window"] = window
        jcfg = j_smoke_config(arch).replace(**kw)
        cfg = smoke_config(arch).replace(**kw)
        # the port's draw carried to JAX (JAX's eager init takes seconds a
        # config; test_params_from_numpy_round_trip carries JAX's tree across)
        tree = model.params_to_numpy(model.init_params(cfg, 0, CPU))
        jp = jax.tree.map(jnp.asarray, tree)
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                   (B, S)).astype(np.int32)
        jfull = np.asarray(jax.jit(lambda p, tk: jmodel.logits_fn(
            p, jcfg, jmodel.forward(p, jcfg, {"tokens": tk})[0]))(
            jp, jnp.asarray(tokens)))
        jscfg = JServeConfig(model=jcfg, shape=JShapeConfig("t", S, B, "decode"),
                             kv_page_tokens=PT)
        jctx = jmodel.make_decode_ctx(jcfg, jscfg, B)
        js = jmodel.init_decode_states(jp, jcfg, B, jctx, kv_dtype=jnp.float32)
        bt = np.arange(B * jctx.n_pages, dtype=np.int32).reshape(B, jctx.n_pages)
        step = jax.jit(lambda p, s, tk, pos, b: jmodel.decode_step(
            p, jcfg, s, tk, pos, b, jctx))
        jdec = []
        for i in range(S):
            lg, js = step(jp, js, jnp.asarray(tokens[:, i:i + 1]),
                          jnp.full((B,), i, jnp.int32), jnp.asarray(bt))
            jdec.append(np.asarray(lg[:, 0]))
        want = dict(full=jfull, dec=np.stack(jdec),
                    k_pool=np.asarray(js["j0"]["k_pool"]),
                    v_pool=np.asarray(js["j0"]["v_pool"]))

        m = model.params_from_numpy(cfg, tree, device=CPU)
        x, aux = model.forward(m, cfg, {"tokens": t(tokens)})
        assert aux == {}
        scfg = ServeConfig(model=cfg, shape=ShapeConfig("t", S, B, "decode"),
                           kv_page_tokens=PT)
        ctx = model.make_decode_ctx(cfg, scfg, B)
        states = model.init_decode_states(m, cfg, B, ctx, kv_dtype=torch.float32)
        dec = []
        for i in range(S):
            lg, states = model.decode_step(m, cfg, states, t(tokens[:, i:i + 1]),
                                           torch.full((B,), i, dtype=torch.int32),
                                           t(bt), ctx)
            dec.append(lg[:, 0].numpy())
        got = dict(full=model.logits_fn(m, cfg, x).numpy(), dec=np.stack(dec),
                   k_pool=np.stack([s["k_pool"].numpy() for s in states]),
                   v_pool=np.stack([s["v_pool"].numpy() for s in states]))
        got["table_tokens"] = ctx.n_pages * PT
        return dtype, cfg, want, got
    return run


def test_forward_logits_match_jax(run):
    dtype, cfg, want, got = run
    assert got["full"].shape == (B, S, cfg.padded_vocab)
    if dtype == "float32":
        np.testing.assert_allclose(got["full"], want["full"], **TOL)
    else:
        np.testing.assert_allclose(got["full"], want["full"], rtol=0,
                                   atol=BF16_ATOL)


def test_decode_logits_and_pools_match_jax(run):
    dtype, cfg, want, got = run
    if dtype == "float32":
        np.testing.assert_allclose(got["dec"], want["dec"], **TOL)
        for name in ("k_pool", "v_pool"):
            np.testing.assert_allclose(got[name], want[name], **TOL,
                                       err_msg=name)
    else:
        np.testing.assert_allclose(got["dec"], want["dec"], rtol=0,
                                   atol=BF16_ATOL)


def test_port_decode_matches_port_forward(run):
    """JAX's test_decode_matches_forward on the port alone (float32; in
    bfloat16 the paged cache holds float32 KV where forward keeps bf16).
    A sliding-window table spans window + one page: past its end JAX drops
    the appends (and so does the port, held to JAX above), so decode and
    forward are compared over the positions the table holds."""
    dtype, cfg, want, got = run
    n = got["table_tokens"]
    assert n == S or cfg.sliding_window
    dec = got["dec"].transpose(1, 0, 2)[:, :n]
    got = dict(got, full=got["full"][:, :n])
    if dtype == "float32":
        np.testing.assert_allclose(dec, got["full"], **TOL)
    else:
        np.testing.assert_allclose(dec, got["full"], rtol=0, atol=BF16_ATOL)


# ---------------------------------------------------------------------------
# Decode contexts and families
# ---------------------------------------------------------------------------
CTX_FIELDS = ("page_tokens", "n_pages", "pool_pages", "batch_axes",
              "channel_axes", "pages_per_shard")
