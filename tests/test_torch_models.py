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
are exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ServeConfig as JServeConfig
from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.mesh import make_mesh
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import model as jmodel

from repro_torch.configs import (SHAPES, ServeConfig, ShapeConfig, get_config,
                                 smoke_config)
from repro_torch.models import attention, layers, mlp, model, transformer

import torch_threads

one_thread = torch_threads.one_thread

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
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-8b", "phi4-mini-3.8b",
                                  "h2o-danube-1.8b", "olmoe-1b-7b",
                                  "jamba-v0.1-52b", "xlstm-1.3b",
                                  "whisper-tiny", "internvl2-2b",
                                  "llama4-maverick-400b-a17b"])
def test_configs_copied_verbatim(arch):
    from repro.configs import get_config as j_get_config
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))
    assert dataclasses.asdict(smoke_config(arch)) == \
        dataclasses.asdict(j_smoke_config(arch))
    assert get_config(arch).padded_vocab == j_get_config(arch).padded_vocab


def test_shapes_and_param_count():
    from repro.configs.base import SHAPES as J_SHAPES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    for arch in DENSE:
        cfg = smoke_config(arch)
        assert cfg.param_count() == jmodel.count_params(j_smoke_config(arch))
    # Qwen3-8B at its published widths (vocabulary padded to 152064), from
    # shapes alone on both sides
    from repro.configs import get_config as j_get_config
    assert get_config("qwen3-8b").param_count() == \
        jmodel.count_params(j_get_config("qwen3-8b")) == 8_191_783_936


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


# ---------------------------------------------------------------------------
# forward and decode_step against JAX, per arch (JAX side once each)
# ---------------------------------------------------------------------------

SCENARIOS = [(a, "float32", 0) for a in DENSE] + [
    ("h2o-danube-1.8b", "float32", 12),   # a window the 32 steps pass
    ("qwen3-8b", "bfloat16", 0)]


def _scenario_id(s):
    return f"{s[0]}-{s[1]}" + (f"-window{s[2]}" if s[2] else "")


@pytest.fixture(scope="module", params=SCENARIOS, ids=_scenario_id)
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


@pytest.mark.parametrize("arch,horizon,pt,batch", [
    ("llama3-8b", 256, 32, 4), ("llama3-8b", 100, 16, 3),
    ("h2o-danube-1.8b", 8192, 32, 2), ("h2o-danube-1.8b", 40, 8, 2)])
@pytest.mark.parametrize("with_mesh", [False, True])
def test_make_decode_ctx_matches_jax(arch, horizon, pt, batch, with_mesh):
    """The same geometry as JAX's without a mesh and on JAX's serving
    default, a (1, 1) ("data", "model") mesh (the sliding window bounds
    h2o-danube's horizon to window + page)."""
    jcfg, cfg = j_smoke_config(arch), smoke_config(arch)
    jscfg = JServeConfig(model=jcfg, shape=JShapeConfig("t", horizon, batch,
                                                        "decode"),
                         kv_page_tokens=pt)
    scfg = ServeConfig(model=cfg, shape=ShapeConfig("t", horizon, batch,
                                                    "decode"),
                       kv_page_tokens=pt)
    jmesh = make_mesh((1, 1), ("data", "model")) if with_mesh else None
    jctx = jmodel.make_decode_ctx(jcfg, jscfg, batch, mesh=jmesh)
    ctx = model.make_decode_ctx(cfg, scfg, batch,
                                mesh=dict(jmesh.shape) if with_mesh else None)
    assert {f: getattr(ctx, f) for f in CTX_FIELDS} == \
        {f: getattr(jctx, f) for f in CTX_FIELDS}
    assert jctx.sharded == with_mesh
    if cfg.sliding_window:
        assert ctx.n_pages <= (cfg.sliding_window + pt) // pt + 1


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2), (1, 4)])
def test_make_decode_ctx_on_more_than_one_shard_matches_jax(shape):
    """A mesh of more than one shard gives JAX's geometry: batch groups
    where the batch divides, the page halved while the channels outnumber
    a sequence's pages, pages and pool rounded up to the channels and
    shards (``tests/test_torch_sharding.py`` covers more meshes)."""
    from jax.sharding import AbstractMesh
    jmesh = AbstractMesh(shape, ("data", "model"))
    for arch, horizon, pt, batch in [("llama3-8b", 64, 8, 4),
                                     ("llama3-8b", 100, 64, 3),
                                     ("h2o-danube-1.8b", 40, 8, 2)]:
        jcfg, cfg = j_smoke_config(arch), smoke_config(arch)
        jctx = jmodel.make_decode_ctx(jcfg, JServeConfig(
            model=jcfg, shape=JShapeConfig("t", horizon, batch, "decode"),
            kv_page_tokens=pt), batch, mesh=jmesh)
        ctx = model.make_decode_ctx(cfg, ServeConfig(
            model=cfg, shape=ShapeConfig("t", horizon, batch, "decode"),
            kv_page_tokens=pt), batch, mesh=dict(jmesh.shape))
        assert {f: getattr(ctx, f) for f in CTX_FIELDS} == \
            {f: getattr(jctx, f) for f in CTX_FIELDS}
        assert ctx.sharded and jctx.sharded


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "whisper-tiny",
                                  "internvl2-2b"])
def test_remaining_families_build_and_run(arch):
    """The ssm, encdec and vlm families (which raised NotImplementedError
    before they were ported) build, run forward and decode one step; their
    decode states are the mLSTM/sLSTM states, or the paged pools and the
    cross K/V."""
    cfg = smoke_config(arch)
    m = model.init_params(cfg, device=CPU)
    specs = model.input_specs(cfg, ShapeConfig("t", 16, 1, "train"))
    batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
             specs.items()}
    x, aux = model.forward(m, cfg, batch)
    S = 16
    assert x.shape == (1, S, cfg.d_model) and bool(torch.isfinite(x).all())
    assert aux == {}
    ctx = transformer.DecodeCtx(8, 2, 4)
    frames = torch.zeros((2, 8, cfg.d_model)) if cfg.is_encoder_decoder \
        else None
    states = model.init_decode_states(m, cfg, 2, ctx, enc_frames=frames)
    want = [{"k_pool", "v_pool", "ek", "ev"}] * cfg.num_layers \
        if cfg.is_encoder_decoder else [
            {"mlstm": {"C", "n", "m"}, "slstm": {"c", "n", "h", "m"},
             "attn": {"k_pool", "v_pool"}}[transformer.layer_kind(cfg, i)]
            for i in range(cfg.num_layers)]
    assert [set(s) for s in states] == want
    logits, _ = model.decode_step(
        m, cfg, states, torch.zeros((2, 1), dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32),
        torch.arange(4, dtype=torch.int32).reshape(2, 2), ctx)
    assert logits.shape == (2, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-v0.1-52b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_and_hybrid_families_build_and_run(arch):
    """The moe and hybrid families build, run forward and decode one step,
    with the MoE aux terms."""
    cfg = smoke_config(arch)
    m = model.init_params(cfg, device=CPU)
    x, aux = model.forward(m, cfg, {"tokens": torch.zeros((1, 16),
                                                          dtype=torch.int64)})
    assert x.shape == (1, 16, cfg.d_model) and bool(torch.isfinite(x).all())
    assert set(aux) == {"moe_aux", "moe_z", "moe_dropped"}
    states = transformer.init_decode_states(
        cfg, 2, transformer.DecodeCtx(8, 2, 4), device=CPU)
    kinds = [transformer.layer_kind(cfg, i) for i in range(cfg.num_layers)]
    assert [set(s) for s in states] == [
        {"k_pool", "v_pool"} if k == "attn" else {"conv", "ssm"}
        for k in kinds]
    logits, _ = model.decode_step(
        m, cfg, states, torch.zeros((2, 1), dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32),
        torch.arange(4, dtype=torch.int32).reshape(2, 2),
        transformer.DecodeCtx(8, 2, 4))
    assert logits.shape == (2, 1, cfg.padded_vocab)
