"""Parity of the port's model families with the JAX package's, beyond the
dense one: the moe and hybrid families at ``smoke_config`` of olmoe-1b-7b
(4 MoE layers, 8 experts top-4, QK-norm), llama4-maverick-400b-a17b
(dense/MoE alternation in units of 2, a shared expert) and jamba-v0.1-52b
(one unit of 4: mamba, MoE on the odd layers, attention on layer 2); and
the ssm, encdec and vlm families at ``smoke_config`` of xlstm-1.3b (two
units of sLSTM + mLSTM, 32 tokens: two mLSTM chunks), whisper-tiny (2 + 2
layers over 32 stub frames) and internvl2-2b (8 patch embeddings before 24
tokens, the prefix labels -100).  In float32, on the same parameters
(the port's init carried to JAX, its tree held against JAX's
``init_params`` by path, shape and dtype) and inputs:
``forward`` logits, ``loss_fn`` with its MoE aux terms, ``decode_step``
logits and states step by step (whisper's from ``init_decode_states(...,
enc_frames=)``; internvl2 decodes tokens only, as JAX does), decode against
forward in the port, the parameter bridge on the ``stacks/j{j}`` and
``stacks/{encoder, decoder}`` trees, and ``count_params`` of the full
configs.

Tolerances.  float32 logits within rtol = atol = 5e-4, the JAX package's
own tolerance for decode against forward (observed <= 1.8e-6 on logits of
std ~0.23 against JAX over 16 steps, <= 1e-6 decode against forward; the
ssm, encdec and vlm families <= 5.1e-6 on logits against JAX, decode
against forward <= 8.6e-7 for whisper and internvl2 and 5.5e-5 for
xlstm, whose exponential gates carry rounding further); KV pools, the
mamba SSM states and the mLSTM/sLSTM states within 5e-4 too (observed
<= 5.4e-6; <= 1.5e-5 for xlstm's states of magnitude up to 6); the mamba
conv states,
copies of activations that agree to float32 rounding, within the same
bound (observed <= 4.9e-6).  ``loss_fn``: the loss, ``ce_loss``,
``moe_aux`` and ``moe_z`` within 1e-6 relative (observed <= 1.8e-7);
``moe_dropped`` exact.  The
parameter round trip and the parameter counts are exact.  Decode against
forward runs with ``capacity_factor`` raised to E (no token dropped on
either side), as JAX's ``test_decode_matches_forward`` does.

Each ``tests/test_torch_families_*.py`` file binds ``fam`` or ``rest`` to
some of the archs, and the five tests below of that fixture.
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
from repro.models import transformer as jtransformer

from repro_torch.configs import ServeConfig, ShapeConfig, smoke_config
from repro_torch.models import model, transformer
from repro_torch.models.layers import flatten_tree

CPU = "cpu"

TOL = dict(rtol=5e-4, atol=5e-4)
B, S, PT = 2, 16, 8


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.fixture(scope="module", autouse=True)
def no_grad():
    with torch.no_grad():
        yield


def tokens_np(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def fam_fixture(*params):
    """The module-scoped ``fam`` fixture over ``params``, moe and hybrid archs:
    JAX's and the port's outputs on one draw."""
    @pytest.fixture(scope="module", params=params)
    def fam(request):
        arch = request.param
        jcfg = j_smoke_config(arch).replace(dtype="float32")
        cfg = smoke_config(arch).replace(dtype="float32")
        # the port's init carried to JAX (JAX's own eager init takes seconds);
        # the round trip checks the tree against JAX's
        tree = model.params_to_numpy(model.init_params(cfg, 0, CPU))
        jp = jax.tree.map(jnp.asarray, tree)
        toks = tokens_np(cfg)
        labels = toks.copy()
        labels[0, :3] = -100
        jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}

        @jax.jit
        def jax_side(p):
            x, _ = jmodel.forward(p, jcfg, jb)
            return jmodel.logits_fn(p, jcfg, x), jmodel.loss_fn(p, jcfg, jb)
        jlogits, (jloss, jmet) = jax_side(jp)

        jctx = jmodel.make_decode_ctx(jcfg, JServeConfig(
            jcfg, JShapeConfig("d", S, B, "decode"), kv_page_tokens=PT), B)
        ctx = model.make_decode_ctx(cfg, ServeConfig(
            cfg, ShapeConfig("d", S, B, "decode"), kv_page_tokens=PT), B)
        bt = np.arange(B * ctx.n_pages, dtype=np.int32).reshape(B, -1)
        step = jax.jit(lambda p, s, tk, pos: jmodel.decode_step(
            p, jcfg, s, tk, pos, jnp.asarray(bt), jctx))
        js = jmodel.init_decode_states(jp, jcfg, B, jctx, kv_dtype=jnp.float32)
        jdec, jstates = [], []
        for i in range(S):
            lg, js = step(jp, js, jnp.asarray(toks[:, i:i + 1]),
                          jnp.full((B,), i, jnp.int32))
            jdec.append(np.asarray(lg[:, 0]))
            jstates.append(jax.tree.map(np.asarray, js))
        return dict(arch=arch, jcfg=jcfg, cfg=cfg, tree=tree, toks=toks,
                    labels=labels, ctx=ctx, bt=bt,
                    jlogits=np.asarray(jlogits), jloss=float(jloss),
                    jmet={k: float(v) for k, v in jmet.items()},
                    jdec=jdec, jstates=jstates,
                    params=model.params_from_numpy(cfg, tree, CPU))
    return fam


def test_forward_logits_match_jax(fam):
    p, cfg = fam["params"], fam["cfg"]
    x, aux = model.forward(p, cfg, {"tokens": t(fam["toks"])})
    np.testing.assert_allclose(model.logits_fn(p, cfg, x).numpy(),
                               fam["jlogits"], **TOL)
    assert set(aux) == {"moe_aux", "moe_z", "moe_dropped"}


def test_loss_fn_and_aux_match_jax(fam):
    loss, met = model.loss_fn(fam["params"], fam["cfg"],
                              {"tokens": t(fam["toks"]),
                               "labels": t(fam["labels"])})
    want = fam["jmet"]
    assert set(met) == set(want)
    assert abs(float(loss) - fam["jloss"]) <= 1e-6 * abs(fam["jloss"])
    for k in ("ce_loss", "moe_aux", "moe_z"):
        assert abs(float(met[k]) - want[k]) <= 1e-6 * abs(want[k]), k
    assert float(met["moe_dropped"]) == want["moe_dropped"]
    # the loss adds the aux terms to the cross-entropy, as in JAX
    assert abs(float(loss) - (float(met["ce_loss"]) + float(met["moe_aux"])
                              + float(met["moe_z"]))) <= 1e-6


def test_decode_step_matches_jax_step_by_step(fam):
    p, cfg, ctx = fam["params"], fam["cfg"], fam["ctx"]
    unit = transformer.scan_unit_size(cfg)
    states = model.init_decode_states(p, cfg, B, ctx, kv_dtype=torch.float32)
    for i in range(S):
        lg, states = model.decode_step(
            p, cfg, states, t(fam["toks"][:, i:i + 1]),
            torch.full((B,), i, dtype=torch.int32), t(fam["bt"]), ctx)
        np.testing.assert_allclose(lg[:, 0].numpy(), fam["jdec"][i], **TOL)
        js = fam["jstates"][i]
        for layer, s in enumerate(states):
            want = js[f"j{layer % unit}"]
            assert set(s) == set(want)
            for name, v in s.items():
                np.testing.assert_allclose(
                    v.numpy(), want[name][layer // unit], **TOL,
                    err_msg=f"step {i} layer {layer} {name}")


def test_decode_matches_forward(fam):
    cfg = fam["cfg"].replace(capacity_factor=float(fam["cfg"].num_experts))
    p, ctx = fam["params"], fam["ctx"]
    toks = tokens_np(cfg, seed=1)
    states = model.init_decode_states(p, cfg, B, ctx, kv_dtype=torch.float32)
    dec = []
    for i in range(S):
        lg, states = model.decode_step(
            p, cfg, states, t(toks[:, i:i + 1]),
            torch.full((B,), i, dtype=torch.int32), t(fam["bt"]), ctx)
        dec.append(lg[:, 0])
    x, aux = model.forward(p, cfg, {"tokens": t(toks)})
    assert float(aux["moe_dropped"]) == 0.0
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(),
                               model.logits_fn(p, cfg, x).numpy(), **TOL)


def test_params_round_trip_on_the_unit_trees(fam):
    cfg, tree = fam["cfg"], fam["tree"]
    unit = transformer.scan_unit_size(cfg)
    assert unit == jtransformer.scan_unit_size(fam["jcfg"])
    want = flatten_tree(tree)
    got = flatten_tree(model.params_to_numpy(fam["params"]))
    shapes = jax.eval_shape(lambda k: jmodel.init_params(fam["jcfg"], k),
                            jax.random.PRNGKey(0))
    jax_order = ["/".join(str(k.key) for k in path) for path, _ in
                 jax.tree_util.tree_leaves_with_path(shapes)]
    assert list(got) == list(want) == jax_order
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        k = "/".join(str(p.key) for p in path)
        assert got[k].shape == leaf.shape and got[k].dtype == leaf.dtype, k
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)
    assert {k.split("/")[1] for k in want if k.startswith("stacks")} == \
        {f"j{j}" for j in range(unit)}
    # a parameter's name says where its JAX leaf is
    for name, _ in fam["params"].named_parameters():
        path, u = model._jax_path(name)
        if u is not None:
            j = int(name.split(".")[2][1:])
            kind = transformer.layer_kind(cfg, u * unit + j)
            assert kind == jtransformer.layer_kind(fam["jcfg"], j)
            assert path.startswith(f"stacks/j{j}/")
    with pytest.raises(KeyError, match="lacks"):
        bad = dict(tree, extra=np.zeros(1, np.float32))
        model.params_from_numpy(cfg, bad, CPU)


S2 = 32


def batch_np(cfg, seed=0):
    """The family's inputs for S2 tokens (labels -100 on a vlm's prefix and
    on a few pads); the decoder tokens of ``decode_step``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S2)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S2)).astype(np.int32)
    labels[0, -3:] = -100
    if cfg.is_encoder_decoder:
        frames = rng.standard_normal((B, S2, cfg.d_model)).astype(np.float32)
        return {"frames": frames, "dec_tokens": toks, "labels": labels}
    if cfg.family == "vlm":
        P_ = cfg.num_prefix_embeds
        labels[:, :P_] = -100
        return {"patch_embeds": rng.standard_normal(
            (B, P_, cfg.d_model)).astype(np.float32),
            "tokens": toks[:, :S2 - P_], "labels": labels}
    return {"tokens": toks, "labels": labels}


def decode_tokens(batch):
    return batch.get("dec_tokens", batch.get("tokens"))


def tb(batch):
    return {k: t(v) for k, v in batch.items()}


def rest_fixture(*params):
    """The module-scoped ``rest`` fixture over ``params``, ssm, encdec and vlm
    archs: JAX's and the port's outputs on one draw."""
    @pytest.fixture(scope="module", params=params)
    def rest(request):
        arch = request.param
        jcfg = j_smoke_config(arch).replace(dtype="float32")
        cfg = smoke_config(arch).replace(dtype="float32")
        # the port's init carried to JAX (JAX's own init takes 3-4 s here);
        # the round trip checks the tree against JAX's
        tree = model.params_to_numpy(model.init_params(cfg, 0, CPU))
        jp = jax.tree.map(jnp.asarray, tree)
        batch = batch_np(cfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        @jax.jit
        def jax_side(p):
            x, _ = jmodel.forward(p, jcfg, jb)
            return jmodel.logits_fn(p, jcfg, x), jmodel.loss_fn(p, jcfg, jb)
        jlogits, (jloss, jmet) = jax_side(jp)

        # decode: the decoder tokens (whisper), the tokens alone (internvl2),
        # the whole sequence (xlstm)
        toks = decode_tokens(batch)
        n = toks.shape[1]
        jctx = jmodel.make_decode_ctx(jcfg, JServeConfig(
            jcfg, JShapeConfig("d", S2, B, "decode"), kv_page_tokens=PT), B)
        ctx = model.make_decode_ctx(cfg, ServeConfig(
            cfg, ShapeConfig("d", S2, B, "decode"), kv_page_tokens=PT), B)
        bt = np.arange(B * ctx.n_pages, dtype=np.int32).reshape(B, -1)
        step = jax.jit(lambda p, s, tk, pos: jmodel.decode_step(
            p, jcfg, s, tk, pos, jnp.asarray(bt), jctx))
        frames = jb.get("frames")
        js = jmodel.init_decode_states(jp, jcfg, B, jctx, kv_dtype=jnp.float32,
                                       enc_frames=frames)
        jdec, jstates = [], []
        for i in range(n):
            lg, js = step(jp, js, jnp.asarray(toks[:, i:i + 1]),
                          jnp.full((B,), i, jnp.int32))
            jdec.append(np.asarray(lg[:, 0]))
            jstates.append(jax.tree.map(np.asarray, js))
        return dict(arch=arch, jcfg=jcfg, cfg=cfg, tree=tree, batch=batch,
                    ctx=ctx, bt=bt, jlogits=np.asarray(jlogits),
                    jloss=float(jloss), jmet={k: float(v) for k, v in
                                              jmet.items()},
                    jdec=jdec, jstates=jstates,
                    params=model.params_from_numpy(cfg, tree, CPU))
    return rest


def port_decode(r, toks):
    p, cfg, ctx = r["params"], r["cfg"], r["ctx"]
    frames = r["batch"].get("frames")
    states = model.init_decode_states(
        p, cfg, B, ctx, kv_dtype=torch.float32,
        enc_frames=None if frames is None else t(frames))
    for i in range(toks.shape[1]):
        lg, states = model.decode_step(
            p, cfg, states, t(toks[:, i:i + 1]),
            torch.full((B,), i, dtype=torch.int32), t(r["bt"]), ctx)
        yield lg[:, 0], states


def test_remaining_families_forward_logits_match_jax(rest):
    p, cfg = rest["params"], rest["cfg"]
    x, aux = model.forward(p, cfg, tb(rest["batch"]))
    assert aux == {}
    np.testing.assert_allclose(model.logits_fn(p, cfg, x).numpy(),
                               rest["jlogits"], **TOL)


def test_remaining_families_loss_fn_matches_jax(rest):
    loss, met = model.loss_fn(rest["params"], rest["cfg"], tb(rest["batch"]))
    assert set(met) == set(rest["jmet"]) == {"ce_loss"}
    assert abs(float(loss) - rest["jloss"]) <= 1e-6 * abs(rest["jloss"])
    assert float(loss) == float(met["ce_loss"])


def test_remaining_families_decode_step_matches_jax(rest):
    cfg = rest["cfg"]
    unit = 1 if cfg.is_encoder_decoder else transformer.scan_unit_size(cfg)
    steps = port_decode(rest, decode_tokens(rest["batch"]))
    for i, (lg, states) in enumerate(steps):
        np.testing.assert_allclose(lg.numpy(), rest["jdec"][i], **TOL)
        js = rest["jstates"][i]
        for layer, s in enumerate(states):
            # JAX stacks the decoder's states on one layer axis, the
            # other families' by unit position
            want = js if cfg.is_encoder_decoder else js[f"j{layer % unit}"]
            assert set(s) == set(want)
            for name, v in s.items():
                np.testing.assert_allclose(
                    v.numpy(), want[name][layer // unit], **TOL,
                    err_msg=f"step {i} layer {layer} {name}")


def test_remaining_families_decode_matches_forward(rest):
    p, cfg = rest["params"], rest["cfg"]
    batch = batch_np(cfg, seed=1)
    toks = decode_tokens(batch)
    dec = torch.stack([lg for lg, _ in port_decode(
        dict(rest, batch=batch), toks)], 1)
    if cfg.family == "vlm":    # decode takes tokens only: no prefix
        batch = dict(batch, patch_embeds=np.zeros((B, 0, cfg.d_model),
                                                  np.float32))
    x, _ = model.forward(p, cfg, tb(batch))
    np.testing.assert_allclose(dec.numpy(),
                               model.logits_fn(p, cfg, x).numpy(), **TOL)


def test_remaining_families_params_round_trip(rest):
    cfg, tree = rest["cfg"], rest["tree"]
    want = flatten_tree(tree)
    got = flatten_tree(model.params_to_numpy(rest["params"]))
    shapes = jax.eval_shape(lambda k: jmodel.init_params(rest["jcfg"], k),
                            jax.random.PRNGKey(0))
    jax_order = ["/".join(str(k.key) for k in path) for path, _ in
                 jax.tree_util.tree_leaves_with_path(shapes)]
    assert list(got) == list(want) == jax_order
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        k = "/".join(str(p.key) for p in path)
        assert got[k].shape == leaf.shape and got[k].dtype == leaf.dtype, k
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)
    stacks = {k.split("/")[1] for k in want if k.startswith("stacks")}
    if cfg.is_encoder_decoder:
        assert stacks == {"encoder", "decoder"}
        assert "final_norm/bias" in want and "head" not in want
    else:
        assert stacks == {f"j{j}" for j in
                          range(transformer.scan_unit_size(cfg))}
    if cfg.family == "ssm":   # xLSTM blocks have no norm2 and no FFN
        assert not any("norm2" in k or "ffn" in k for k in want)
        assert {k.split("/")[2] for k in want if k.startswith("stacks")} \
            == {"norm1", "mlstm", "slstm"}
