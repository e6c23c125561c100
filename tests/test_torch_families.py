"""Parity of the port's moe and hybrid families with the JAX package's, at
``smoke_config`` of olmoe-1b-7b (4 MoE layers, 8 experts top-4, QK-norm),
llama4-maverick-400b-a17b (dense/MoE alternation in units of 2, a shared
expert) and jamba-v0.1-52b (one unit of 4: mamba, MoE on the odd layers,
attention on layer 2), in float32, on the same parameters (JAX's init
carried across by ``params_from_numpy``) and tokens: ``forward`` logits,
``loss_fn`` with its MoE aux terms, ``decode_step`` logits and states step
by step, decode against forward in the port, the parameter bridge on the
``stacks/j{j}`` trees, and ``count_params`` of the full configs.

Tolerances.  float32 logits within rtol = atol = 5e-4, the JAX package's
own tolerance for decode against forward (observed <= 1.8e-6 on logits of
std ~0.23 against JAX over 16 steps, <= 1e-6 decode against forward); KV
pools and the mamba SSM states within 5e-4 too (observed <= 5.4e-6); the
mamba conv states, copies of activations that agree to float32 rounding,
within the same bound (observed <= 4.9e-6).  ``loss_fn``: the loss,
``ce_loss``, ``moe_aux`` and ``moe_z`` within 1e-6 relative (observed <=
1.8e-7); ``moe_dropped`` exact.  The
parameter round trip and the parameter counts are exact.  Decode against
forward runs with ``capacity_factor`` raised to E (no token dropped on
either side), as JAX's ``test_decode_matches_forward`` does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ServeConfig as JServeConfig
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import model as jmodel
from repro.models import transformer as jtransformer

from repro_torch.configs import (ServeConfig, ShapeConfig, get_config,
                                 smoke_config)
from repro_torch.models import model, transformer
from repro_torch.models.layers import flatten_tree

CPU = "cpu"
ARCHS = ["olmoe-1b-7b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b"]
TOL = dict(rtol=5e-4, atol=5e-4)
B, S, PT = 2, 16, 8


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


def tokens_np(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    arch = request.param
    jcfg = j_smoke_config(arch).replace(dtype="float32")
    cfg = smoke_config(arch).replace(dtype="float32")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
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
    assert list(got) == list(want) == list(
        flatten_tree(jax.tree.map(np.asarray, tree)))
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


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_full_configs_match_jax(arch):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    for active in (False, True):
        assert model.count_params(cfg, active) == \
            jmodel.count_params(jcfg, active)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.active_param_count() < cfg.param_count()
