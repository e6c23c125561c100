"""Parity of the port's encoder-decoder family (``repro_torch.models.
encdec`` with ``layers.layer_norm``, ``layers.sinusoid_positions`` and
``mlp.gelu_mlp``) with the JAX package's, at ``smoke_config("whisper-
tiny")`` (2 encoder and 2 decoder layers, d_model 128, 4 heads of 32, GELU
MLP 256 wide) in float32, on the same parameters (JAX's ``init_params``
carried across by ``params_from_numpy``): 96 stub frames, whose 64-token
attention chunk becomes JAX's gcd chunk of 32, and 16 decoder tokens.
``encode``, ``cross_kv`` and ``decode_train``; ``init_decode_states(...,
enc_frames=)`` and ``decode_step`` step by step over 16 tokens, the logits,
the paged self-KV pools and the cross K/V; decode against ``decode_train``
in the port; and the layers themselves.

Tolerances.  float32 outputs, logits and states within rtol = atol =
5e-4, JAX's own decode tolerance (observed <= 3.6e-6 for the encoder
output, the cross K/V and the decoder's hidden states, of magnitude up to
7.2; <= 3.4e-6 on logits and states against JAX over 16 steps, <= 4.5e-7
decode against ``decode_train``).  The layer norm and the GELU MLP within
1e-5 in float32 (observed <= 5.8e-7) and one bfloat16 rounding step in
bfloat16; ``sinusoid_positions`` exactly JAX's float32 array (numpy
float64 angles, cast once)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ServeConfig as JServeConfig
from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import model as jmodel

from repro_torch.configs import ServeConfig, ShapeConfig, smoke_config
from repro_torch.models import encdec, layers, mlp, model

CPU = "cpu"
TOL = dict(rtol=5e-4, atol=5e-4)
B, S_ENC, S_DEC, PT = 2, 96, 16, 8


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.fixture(scope="module", autouse=True)
def no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and PyTorch's thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wh():
    jcfg = j_smoke_config("whisper-tiny").replace(dtype="float32")
    cfg = smoke_config("whisper-tiny").replace(dtype="float32")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S_DEC)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S_DEC, dtype=np.int32), (B, S_DEC))

    @jax.jit
    def jax_side(p):
        enc = jencdec.encode(p["stacks"], jcfg, jnp.asarray(frames))
        ek, ev = jencdec.cross_kv(p["stacks"], jcfg, enc)
        xd = p["embed"][jnp.asarray(toks)]
        x = jencdec.decode_train(p["stacks"], jcfg, xd, enc,
                                 jnp.asarray(pos))
        return enc, ek, ev, x

    jenc, jek, jev, jx = jax_side(jp)
    jctx = jmodel.make_decode_ctx(jcfg, JServeConfig(
        jcfg, JShapeConfig("d", S_DEC, B, "decode"), kv_page_tokens=PT), B)
    ctx = model.make_decode_ctx(cfg, ServeConfig(
        cfg, ShapeConfig("d", S_DEC, B, "decode"), kv_page_tokens=PT), B)
    bt = np.arange(B * ctx.n_pages, dtype=np.int32).reshape(B, -1)
    step = jax.jit(lambda p, s, tk, i: jmodel.decode_step(
        p, jcfg, s, tk, i, jnp.asarray(bt), jctx))
    js = jmodel.init_decode_states(jp, jcfg, B, jctx, kv_dtype=jnp.float32,
                                   enc_frames=jnp.asarray(frames))
    jdec, jstates = [], []
    for i in range(S_DEC):
        lg, js = step(jp, js, jnp.asarray(toks[:, i:i + 1]),
                      jnp.full((B,), i, jnp.int32))
        jdec.append(np.asarray(lg[:, 0]))
        jstates.append(jax.tree.map(np.asarray, js))
    tree = jax.tree.map(np.asarray, jp)
    return dict(jcfg=jcfg, cfg=cfg, frames=frames, toks=toks, pos=pos,
                ctx=ctx, bt=bt, jenc=np.asarray(jenc), jek=np.asarray(jek),
                jev=np.asarray(jev), jx=np.asarray(jx), jdec=jdec,
                jstates=jstates, params=model.params_from_numpy(cfg, tree,
                                                                CPU))


# ---------------------------------------------------------------------------
# The layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 5, 48)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for centred in (True, False):
        norm = layers.LayerNorm(48, CPU) if centred else \
            layers.RMSNorm(48, CPU)
        norm.scale.copy_(t(scale))
        jp = {"scale": jnp.asarray(scale)}
        if centred:
            norm.bias.copy_(t(bias))
            jp["bias"] = jnp.asarray(bias)
        want = np.asarray(jlayers.layer_norm(jnp.asarray(x, jdt), jp)
                          .astype(jnp.float32))
        got = layers.layer_norm(t(x).to(tdt), norm)
        assert got.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5)
        else:   # one bf16 rounding step of the output
            np.testing.assert_allclose(got.float().numpy(), want,
                                       rtol=2 ** -7, atol=2 ** -6)
    got = norm(t(x))                     # the module's forward
    assert got.shape == x.shape


@pytest.mark.parametrize("S,d", [(1500, 384), (4096, 384), (7, 128)])
def test_sinusoid_positions_are_jax_s(S, d):
    got = layers.sinusoid_positions(S, d, CPU)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jlayers.sinusoid_positions(S, d)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax(dtype):
    rng = np.random.default_rng(3)
    p = mlp.init_gelu_mlp(32, 64, torch.Generator().manual_seed(0), CPU)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    jp = {"up": jnp.asarray(p.up.numpy()), "down": jnp.asarray(p.down.numpy())}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jmlp.gelu_mlp(jp, jnp.asarray(x, jdt))
                      .astype(jnp.float32))
    got = mlp.gelu_mlp(p, t(x).to(tdt))
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -6,
                                   atol=2 ** -6)
    # jax.nn.gelu is the tanh form by default
    z = torch.linspace(-6, 6, 97)
    np.testing.assert_allclose(mlp.gelu(z).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(z.numpy()))),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The stacks
# ---------------------------------------------------------------------------

def test_encode_and_cross_kv_match_jax(wh):
    p, cfg = wh["params"], wh["cfg"]
    enc = encdec.encode(p.encoder, cfg, t(wh["frames"]))
    np.testing.assert_allclose(enc.numpy(), wh["jenc"], **TOL)
    ek, ev = encdec.cross_kv(p.decoder, cfg, t(wh["jenc"]))
    assert ek.shape == wh["jek"].shape == (cfg.num_layers, B, S_ENC,
                                           cfg.num_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(ek.numpy(), wh["jek"], **TOL)
    np.testing.assert_allclose(ev.numpy(), wh["jev"], **TOL)


def test_decode_train_matches_jax(wh):
    p, cfg = wh["params"], wh["cfg"]
    xd = p.embed[t(wh["toks"]).long()]
    x = encdec.decode_train(p.decoder, cfg, xd, t(wh["jenc"]),
                            t(wh["pos"]))
    np.testing.assert_allclose(x.numpy(), wh["jx"], **TOL)
    # the model's forward is encode + decode_train
    got, aux = model.forward(p, cfg, {"frames": t(wh["frames"]),
                                      "dec_tokens": t(wh["toks"])})
    assert aux == {}
    np.testing.assert_allclose(got.numpy(), wh["jx"], **TOL)


def test_decode_step_matches_jax_step_by_step(wh):
    p, cfg, ctx = wh["params"], wh["cfg"], wh["ctx"]
    states = model.init_decode_states(p, cfg, B, ctx, kv_dtype=torch.float32,
                                      enc_frames=t(wh["frames"]))
    assert len(states) == cfg.num_layers
    for i in range(S_DEC):
        lg, states = model.decode_step(
            p, cfg, states, t(wh["toks"][:, i:i + 1]),
            torch.full((B,), i, dtype=torch.int32), t(wh["bt"]), ctx)
        np.testing.assert_allclose(lg[:, 0].numpy(), wh["jdec"][i], **TOL)
        js = wh["jstates"][i]
        for layer, s in enumerate(states):
            assert set(s) == set(js) == {"k_pool", "v_pool", "ek", "ev"}
            for name, v in s.items():
                np.testing.assert_allclose(
                    v.numpy(), js[name][layer], **TOL,
                    err_msg=f"step {i} layer {layer} {name}")


def test_decode_matches_decode_train(wh):
    p, cfg, ctx = wh["params"], wh["cfg"], wh["ctx"]
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (B, S_DEC)).astype(np.int32)
    states = model.init_decode_states(p, cfg, B, ctx, kv_dtype=torch.float32,
                                      enc_frames=t(wh["frames"]))
    dec = []
    for i in range(S_DEC):
        lg, states = model.decode_step(
            p, cfg, states, t(toks[:, i:i + 1]),
            torch.full((B,), i, dtype=torch.int32), t(wh["bt"]), ctx)
        dec.append(lg[:, 0])
    x, _ = model.forward(p, cfg, {"frames": t(wh["frames"]),
                                  "dec_tokens": t(toks)})
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(),
                               model.logits_fn(p, cfg, x).numpy(), **TOL)
    with pytest.raises(ValueError, match="enc_frames"):
        model.init_decode_states(p, cfg, B, ctx)
