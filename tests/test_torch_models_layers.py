"""Parity of the port's model zoo with the JAX package's: the norms and RoPE,
SwiGLU, chunked and decode attention, and the parameter bridge. The
tolerances are in ``tests/models_cases.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import model as jmodel

from repro_torch.configs import smoke_config
from repro_torch.models import attention, layers, mlp, model

import torch_threads
import models_cases
from models_cases import CPU, TOL, t

no_grad = models_cases.no_grad

one_thread = torch_threads.one_thread


_TREES: dict = {}


def j_params_tree(cfg, seed=0):
    """JAX's parameters of ``cfg`` from ``PRNGKey(seed)`` as numpy, drawn
    once a module for every config that draws the same ones: JAX's init
    reads ``param_dtype`` but not ``dtype``, ``sliding_window`` or
    ``remat``.  A fresh top-level dict each call (the nested leaves are
    shared, and no test writes them)."""
    key = (cfg.replace(dtype="float32", sliding_window=0, remat=False), seed)
    if key not in _TREES:
        _TREES[key] = jax.tree.map(
            np.asarray, jmodel.init_params(cfg, jax.random.PRNGKey(seed)))
    return dict(_TREES[key])


# ---------------------------------------------------------------------------
# Layers, SwiGLU, attention
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_and_rope(rng, dtype):
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32) * 3
    scale = rng.standard_normal(32).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 5)).astype(np.int32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x, jdt), t(x).to(tdt)
    pairs = [
        (jlayers.rms_norm(jx, {"scale": jnp.asarray(scale)}),
         layers.rms_norm(tx, t(scale))),
        (jlayers.head_rms_norm(jx, jnp.asarray(scale)),
         layers.head_rms_norm(tx, t(scale))),
        (jlayers.rope(jx, jnp.asarray(pos), 1_000_000.0),
         layers.rope(tx, t(pos), 1_000_000.0)),
    ]
    for want, got in pairs:
        assert got.dtype == tdt
        w = np.asarray(want.astype(jnp.float32))
        g = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, **TOL)
        else:   # one bf16 rounding step of the output (|x| < 32)
            np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=2 ** -7)


def test_swiglu(rng):
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in (("gate", (16, 24)), ("up", (16, 24)),
                      ("down", (24, 16)))}
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    m = mlp.SwiGLU(16, 24, CPU)
    for k, v in p.items():
        getattr(m, k).data.copy_(t(v))
    want = jmlp.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x))
    np.testing.assert_allclose(mlp.swiglu(m, t(x)).numpy(), np.asarray(want),
                               **TOL)


def _attn_case(rng, cfg):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    jp = {"wq": rng.standard_normal((d, H, hd)), "wk":
          rng.standard_normal((d, K, hd)), "wv": rng.standard_normal((d, K, hd)),
          "wo": rng.standard_normal((H, hd, d)), "q_scale":
          rng.standard_normal(hd), "k_scale": rng.standard_normal(hd)}
    jp = {k: (v / np.sqrt(d)).astype(np.float32) for k, v in jp.items()}
    if not cfg.qk_norm:
        del jp["q_scale"], jp["k_scale"]
    p = attention.Attention(cfg, CPU)
    for k, v in jp.items():
        getattr(p, k).data.copy_(t(v))
    return {k: jnp.asarray(v) for k, v in jp.items()}, p


@pytest.mark.parametrize("window,chunk", [(0, 16), (0, 12), (9, 16)])
def test_qkv_out_proj_chunked_attention(rng, window, chunk):
    """Causal and sliding-window chunked attention, a chunk that does not
    divide the KV length (gcd), and the projections with QK-norm."""
    cfg = smoke_config("qwen3-8b").replace(sliding_window=window,
                                           attn_chunk=chunk)
    jcfg = j_smoke_config("qwen3-8b").replace(sliding_window=window,
                                              attn_chunk=chunk)
    jp, p = _attn_case(rng, cfg)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    jq, jk, jv = jattn.qkv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    q, k, v = attention.qkv(p, cfg, t(x), t(pos))
    for a, b in ((q, jq), (k, jk), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    jo = jattn.chunked_attention(jq, jk, jv, jcfg)
    o = attention.chunked_attention(q, k, v, cfg)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(attention.out_proj(p, cfg, o).numpy(),
                               np.asarray(jattn.out_proj(jp, jcfg, jo)), **TOL)


@pytest.mark.parametrize("window", [0, 6])
def test_decode_attention_dense(rng, window):
    cfg = smoke_config("llama3-8b").replace(sliding_window=window)
    jcfg = j_smoke_config("llama3-8b").replace(sliding_window=window)
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = rng.standard_normal((3, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((3, 20, K, hd)).astype(np.float32)
    vc = rng.standard_normal((3, 20, K, hd)).astype(np.float32)
    n = np.asarray([1, 13, 20], np.int32)
    want = jattn.decode_attention_dense(jnp.asarray(q), jnp.asarray(kc),
                                        jnp.asarray(vc), jnp.asarray(n), jcfg)
    got = attention.decode_attention_dense(t(q), t(kc), t(vc), t(n), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# The parameter bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-8b", "phi4-mini-3.8b"])
def test_params_from_numpy_round_trip(arch):
    """JAX tree -> port -> JAX tree is exact, names and shapes included
    (qwen3: QK-norm scales; phi4: tied embeddings, no head)."""
    tree = j_params_tree(j_smoke_config(arch))
    m = model.params_from_numpy(smoke_config(arch), tree, device=CPU)
    back = model.params_to_numpy(m)
    flat_a = layers.flatten_tree(tree)
    flat_b = layers.flatten_tree(back)
    assert set(flat_a) == set(flat_b)
    for k in flat_a:
        np.testing.assert_array_equal(flat_b[k], flat_a[k], err_msg=k)
    assert ("head" in flat_a) == (arch == "qwen3-8b")
    tree["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        model.params_from_numpy(smoke_config(arch), tree, device=CPU)


def test_init_params_is_seeded_and_shaped():
    cfg = smoke_config("qwen3-8b")
    a = model.init_params(cfg, seed=3, device=CPU)
    b = model.init_params(cfg, seed=3, device=CPU)
    c = model.init_params(cfg, seed=4, device=CPU)
    ta, tb, tc = (layers.flatten_tree(model.params_to_numpy(m))
                  for m in (a, b, c))
    want = layers.flatten_tree(j_params_tree(j_smoke_config("qwen3-8b")))
    assert {k: v.shape for k, v in ta.items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(np.array_equal(ta[k], tb[k]) for k in ta)
    assert not np.array_equal(ta["embed"], tc["embed"])
    assert abs(float(ta["embed"].std()) - 0.02) < 1e-3
    wq = ta["stacks/j0/attn/wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 5e-3
    assert all(p.requires_grad for p in a.parameters())   # trainable
