"""Parity of the port's paged KV cache (``repro_torch.core.paged_kv``) with
the JAX package's: ``append``, ``prefill_pages`` and
``paged_decode_attention`` on the same inputs (the duplicate-write case of
idle decode slots, and writes past a sliding-window table, included), and
JAX's channel-sharded sublayer at one channel (the ``(1, 1)`` mesh its
serving CLI uses) against the port's gather path.

Tolerance: pools written by ``append``/``prefill_pages`` are exact (a
scatter of the same float32 values); attention outputs rtol = atol = 5e-4,
the JAX package's own tolerance for paged decode (float32 on both sides,
summation order apart)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import paged_kv as jkv
from repro.launch.mesh import make_mesh
from repro.models import model as jmodel
from repro.models import transformer as jtransformer

from repro_torch.configs import smoke_config
from repro_torch.core import paged_kv as tkv
from repro_torch.models import attention
from repro_torch.models import transformer as ttransformer

import torch_threads
import paged_kv_cases
from paged_kv_cases import CPU

_jitted_page_table = paged_kv_cases._jitted_page_table
_no_grad = paged_kv_cases._no_grad

one_thread = torch_threads.one_thread

TOL = dict(rtol=5e-4, atol=5e-4)


def t(a):
    return torch.from_numpy(np.array(a))


def pools(rng, P=12, pt=4, K=2, hd=8):
    k = rng.standard_normal((P, pt, K, hd)).astype(np.float32)
    v = rng.standard_normal((P, pt, K, hd)).astype(np.float32)
    return k, v


# ---------------------------------------------------------------------------
# The cache functions
# ---------------------------------------------------------------------------
APPEND_CASES = {
    # distinct tail pages
    "distinct": ([[0, 1, 2], [3, 4, 5], [6, 7, 8]], [0, 5, 11]),
    # idle rows 1 and 3 keep a stale table on pages recycled to rows 0 and
    # 2 at the same (page, offset): the last row in batch order lands
    "duplicates": ([[0, 1, 2], [0, 9, 2], [6, 7, 8], [0, 7, 10], [6, 7, 8]],
                   [1, 1, 6, 6, 6]),
    # a window-bounded table of 3 pages: positions 12+ lie past it and JAX
    # drops those writes (one of them shares row 0's page)
    "past_table": ([[0, 1, 2], [3, 4, 5], [0, 1, 2]], [13, 2, 4]),
}


@pytest.mark.parametrize("case", sorted(APPEND_CASES))
def test_append_matches_jax(case):
    rng = np.random.default_rng(3)
    bt, pos = (np.asarray(a, np.int32) for a in APPEND_CASES[case])
    kp, vp = pools(rng)
    kn = rng.standard_normal((len(pos), 1, 2, 8)).astype(np.float32)
    vn = rng.standard_normal((len(pos), 1, 2, 8)).astype(np.float32)
    jk, jv = jkv.append(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
                        jnp.asarray(pos), jnp.asarray(kn), jnp.asarray(vn))
    tk, tv = t(kp), t(vp)
    ok, ov = tkv.append(tk, tv, t(bt), t(pos), t(kn), t(vn))
    assert ok is tk and ov is tv          # written in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if case == "duplicates":   # the winners are the last rows in order
        np.testing.assert_array_equal(tk.numpy()[0, 1], kn[1, 0])
        np.testing.assert_array_equal(tk.numpy()[7, 2], kn[4, 0])
    if case == "past_table":   # nothing written for row 0
        assert (tk.numpy() != kp).any(axis=(2, 3)).sum() == 2


def test_prefill_pages_matches_jax():
    rng = np.random.default_rng(4)
    kp, vp = pools(rng)
    B, S = 3, 8
    k = rng.standard_normal((B, S, 2, 8)).astype(np.float32)
    v = rng.standard_normal((B, S, 2, 8)).astype(np.float32)
    bt = np.asarray([[5, 2, 0], [11, 3, 0], [7, 9, 0]], np.int32)
    jk, jv = jkv.prefill_pages(jnp.asarray(kp), jnp.asarray(vp),
                               jnp.asarray(bt), jnp.asarray(k), jnp.asarray(v))
    tk, tv = tkv.prefill_pages(t(kp), t(vp), t(bt), t(k), t(v))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("window", [0, 5])
def test_paged_decode_attention_matches_jax(window):
    rng = np.random.default_rng(5)
    cfg = smoke_config("llama3-8b").replace(sliding_window=window)
    jcfg = j_smoke_config("llama3-8b").replace(sliding_window=window)
    kp, vp = pools(rng, K=4, hd=32)
    q = rng.standard_normal((3, 1, 4, 32)).astype(np.float32)
    bt = np.asarray([[0, 4, 8], [1, 5, 9], [11, 2, 6]], np.int32)
    pos = np.asarray([0, 6, 11], np.int32)
    want = jkv.paged_decode_attention(jnp.asarray(q), jnp.asarray(kp),
                                      jnp.asarray(vp), jnp.asarray(bt),
                                      jnp.asarray(pos), jcfg)
    got = tkv.paged_decode_attention(t(q), t(kp), t(vp), t(bt), t(pos), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", ["distinct", "duplicates"])
def test_sharded_sublayer_at_one_channel_equals_gather(case):
    """JAX's serving CLI decodes on a (1, 1) mesh: ``ctx.sharded`` is True
    and each attention layer runs ``append_sharded`` and
    ``decode_attention_sharded`` inside ``shard_map`` at Dm = 1.  Its pools
    and output equal JAX's gather path and the port's (same geometry),
    duplicate writes of idle rows included."""
    rng = np.random.default_rng(6)
    jcfg = j_smoke_config("qwen3-8b").replace(dtype="float32")
    cfg = smoke_config("qwen3-8b").replace(dtype="float32")
    rows, pos = APPEND_CASES[case]
    B, pt = len(pos), 4
    jscfg = JServeConfig(model=jcfg, shape=JShapeConfig("t", 12, B, "decode"),
                         kv_page_tokens=pt)
    ctx_gather = jmodel.make_decode_ctx(jcfg, jscfg, B)
    ctx_sharded = jmodel.make_decode_ctx(
        jcfg, jscfg, B, mesh=make_mesh((1, 1), ("data", "model")))
    assert ctx_sharded.sharded and not ctx_gather.sharded
    for f in ("page_tokens", "n_pages", "pool_pages"):
        assert getattr(ctx_sharded, f) == getattr(ctx_gather, f)
    P = ctx_gather.pool_pages
    bt = np.asarray(rows, np.int32) % P
    pos = np.asarray(pos, np.int32)
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (d, H, hd), "wk": (d, K, hd), "wv": (d, K, hd),
              "wo": (H, hd, d), "q_scale": (hd,), "k_scale": (hd,)}
    p = attention.Attention(cfg, CPU)
    jp = {}
    for k, shape in shapes.items():
        a = (rng.standard_normal(shape) / np.sqrt(d)).astype(np.float32)
        getattr(p, k).data.copy_(t(a))
        jp[k] = jnp.asarray(a)
    sublayer = jax.jit(jtransformer._paged_attn_sub, static_argnums=(1, 6))
    kp, vp = pools(rng, P=P, pt=pt, K=cfg.num_kv_heads, hd=cfg.head_dim)
    h = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    out = {}
    for name, ctx in (("gather", ctx_gather), ("sharded", ctx_sharded)):
        state = {"k_pool": jnp.asarray(kp), "v_pool": jnp.asarray(vp)}
        sub, st = sublayer(jp, jcfg, jnp.asarray(h), state, jnp.asarray(bt),
                           jnp.asarray(pos), ctx)
        out[name] = [np.asarray(x) for x in (sub, st["k_pool"],
                                             st["v_pool"])]
    state = {"k_pool": t(kp), "v_pool": t(vp)}
    sub, st = ttransformer._paged_attn_sub(p, cfg, t(h), state, t(bt), t(pos),
                                           None)
    port = [sub.numpy(), st["k_pool"].numpy(), st["v_pool"].numpy()]
    for a, b in zip(out["sharded"][1:], out["gather"][1:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(out["sharded"][0], out["gather"][0], **TOL)
    for a, b in zip(port, out["sharded"]):
        np.testing.assert_allclose(a, b, **TOL)
