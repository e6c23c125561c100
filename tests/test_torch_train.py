"""Parity of the port's training stack (``repro_torch.models.model.loss_fn``,
``distributed.steps.build_train_step``, ``launch.train``) with the JAX
package's, at ``smoke_config`` of llama3-8b, qwen3-8b and h2o-danube-1.8b
(window 12, which the 64-token sequences pass) in float32, and llama3-8b in
bfloat16; of the moe and hybrid families in float32: one step of
olmoe-1b-7b and of jamba-v0.1-52b, 8 steps of ``train`` of jamba (its units
hold both MoE and mamba layers), the decay mask and int8 compression on
their ``stacks/j{j}`` trees; and of the ssm, encdec and vlm families in
float32: one step and 8 steps of ``train`` of xlstm-1.3b, whisper-tiny and
internvl2-2b, the decay mask on the ``stacks/{encoder, decoder}`` and
xLSTM trees, ``input_specs`` of encdec and vlm.  Parameters cross from JAX by ``params_from_numpy`` or through a
step-0 checkpoint JAX wrote (the loss tests take the port's draw, carried
to JAX); every JAX function runs jitted, once a case.

Tolerances, each from what float32 summation order can do:
  * loss and cross-entropy (``loss_fn``, ``chunked_cross_entropy``, pads of
    -100 included): 1e-6 relative; observed <= 2.3e-7.
  * one ``train_step``: loss, ``grad_norm`` and ``lr`` within 1e-5
    relative (observed <= 2.3e-7); every gradient within 1e-5 of its
    leaf's largest magnitude (observed <= 2.5e-6); the new parameters within
    1e-5 absolute wherever JAX's gradient is at least 1e-6.  AdamW's first
    step moves an element by lr * g / (|g| + eps), eps = 1e-8, so where |g|
    is within a few eps of zero a float32 difference of 1e-9 in g moves the
    element by up to 0.07 lr (3.4e-5 at lr 5e-4, observed on 1-3 elements
    of 600k, all with |g| <= 1.2e-7); there the bound is the step's own
    size, 2 lr.
  * bfloat16 (activations and per-einsum weight casts): the loss within
    1e-4 relative (observed 3.1e-6) and ``grad_norm`` within 1e-3 (observed
    1.3e-4).  bfloat16 keeps 8 bits and the frameworks round at different
    points, so gradients differ by up to 2.5% of their leaf's scale and the
    first AdamW step (a sign, nearly) flips on small elements: the new
    parameters are held to the 2 lr bound only.
  * 8 steps of ``train`` resumed from the same JAX step-0 checkpoint: every
    loss within 1e-5 relative of JAX's (observed <= 3.9e-7).
  * xlstm-1.3b, whisper-tiny and internvl2-2b take the float32 bounds
    above (whisper's 8 losses observed <= 2.6e-7, internvl2's <= 2.4e-7),
    but for xlstm's gradients and later losses.  Its exponential gates
    amplify float32 rounding through the stack, the port's and JAX's
    alike: against a float64 recurrence the port's mLSTM errs 1.38e-6 of
    its largest output, JAX's 1.49e-6; yet JAX against itself at mLSTM
    chunk 64 instead of 16 (the same function) moves one step's gradients
    by up to 1.8e-5 of a leaf's largest and the losses of steps 2-7 by up
    to 2.4e-3 relative (``tests/xlstm_drift.py --train``).  So xlstm's gradients are held within 1e-4 of their
    leaf's largest (observed 5.7e-5) and its losses of steps 2-7 within
    5e-3 relative (observed <= 1.5e-3; steps 0-1 within 1e-5, observed
    4.0e-6).  Whisper's ``final_norm/bias``, which the loss never reads,
    has a zero gradient and zero moments and stays zero, as in JAX.
  * olmoe and jamba take the float32 bounds above; their losses carry the
    MoE aux terms, and the router's gradient flows through the gates, the
    load-balance and the z loss.  Routing is discrete, so the bounds hold
    only while both sides route alike: the MoE tests check that every
    routing decision agrees (``tests/test_torch_moe.py``).
  * the decay mask and int8 compression on the unit trees: exact.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import OptimConfig as JOptimConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.distributed import steps as jsteps
from repro.launch.mesh import make_mesh
from repro.launch.train import train as j_train
from repro.models import model as jmodel

from repro_torch.configs import (OptimConfig, ServeConfig, ShapeConfig,
                                 smoke_config)
from repro_torch.data import SyntheticLMData
from repro_torch.distributed import steps
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import model
from repro_torch.models.layers import flatten_tree
from repro_torch.optim import init_opt_state

import torch_threads

one_thread = torch_threads.one_thread

CPU = "cpu"
OC = dict(lr=1e-3, warmup_steps=2, total_steps=16)
B, S = 4, 64
CASES = [("llama3-8b", "float32"), ("qwen3-8b", "float32"),
         ("h2o-danube-1.8b", "float32"), ("llama3-8b", "bfloat16")]
MOE_CASES = [("olmoe-1b-7b", "float32"), ("jamba-v0.1-52b", "float32")]
REST_CASES = [("xlstm-1.3b", "float32"), ("whisper-tiny", "float32"),
              ("internvl2-2b", "float32")]
# xLSTM's exponential gates amplify float32 rounding through the stack:
# JAX against itself at another mLSTM chunking (the same function) moves
# these gradients by up to 1.8e-5 of a leaf's largest, the port by 5.7e-5
GRAD_TOL = {"xlstm-1.3b": 1e-4}
# ... and its training trajectory: JAX against itself at another chunking
# differs by up to 2.4e-3 relative in the losses of steps 2-7
LOSS_TOL = {"xlstm-1.3b": 5e-3}


def configs(arch, dtype):
    kw = dict(dtype=dtype)
    if arch == "h2o-danube-1.8b":
        kw["sliding_window"] = 12
    return j_smoke_config(arch).replace(**kw), smoke_config(arch).replace(**kw)


def case_id(c):
    return f"{c[0]}-{c[1]}"


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def jax_state():
    """JAX's train state drawn from ``PRNGKey(0)``, once a config, as
    numpy (zero moments, step 0, as ``init_opt_state`` makes them):
    ``test_train_step_matches_jax`` takes its parameters and
    ``test_train_from_jax_checkpoint_follows_jax`` saves it at step 0.
    JAX's init does not read ``dtype``: llama3-8b's float32 and bfloat16
    cases share one draw."""
    from repro.optim import init_opt_state as j_init_opt_state
    cache = {}

    def get(jcfg, joc):
        key = (jcfg.replace(dtype="float32"), joc)
        if key not in cache:
            # eager: the configs share most leaf shapes, so their draws share
            # compiled primitives where one jitted init a config would not
            params = jax.tree.map(np.asarray, jmodel.init_params(
                key[0], jax.random.PRNGKey(0)))
            opt = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                               jax.eval_shape(lambda p: j_init_opt_state(
                                   p, joc), params))
            cache[key] = params, opt
        return cache[key]
    return get


@pytest.fixture(scope="module", autouse=True)
def jax_train_step_once():
    """JAX's jitted train step of a config, compiled once for the module:
    ``test_train_step_matches_jax`` and, through JAX's ``train``,
    ``test_train_from_jax_checkpoint_follows_jax`` build the same step (the
    same config, optimizer, mesh and batch shapes), and each build would
    compile it again.  The arguments are placed with the step's shardings
    first, as JAX's ``train`` places them, so both calls trace the same
    types.  The one program also returns the gradient the step's update
    takes (``adamw_update``'s argument, uncompressed here), which
    ``jitted(batch).with_grads`` gives: the test needs no second program
    that differentiates the loss again."""
    from repro.data import make_batch_specs
    build = jsteps.build_train_step
    adamw_update = jsteps.adamw_update
    taken = []

    def taking_adamw_update(params, grads, opt_state, oc):
        taken.append(grads)
        return adamw_update(params, grads, opt_state, oc)
    cache = {}

    def build_once(cfg, oc, mesh, *, seq_shard=True,
                   grad_compression="none"):
        key = (cfg, oc, id(mesh), seq_shard, grad_compression)
        if key not in cache:
            step, _, pshard, oshard = build(
                cfg, oc, mesh, seq_shard=seq_shard,
                grad_compression=grad_compression)
            jits = {}

            def step_and_grads(params, opt_state, batch):
                taken.clear()
                return (*step(params, opt_state, batch), taken[0])

            def jitted_once(batch_tree):
                shapes = tuple(sorted((k, tuple(v.shape))
                                      for k, v in batch_tree.items()))
                if shapes not in jits:
                    where = (pshard, oshard,
                             make_batch_specs(mesh, batch_tree))
                    # JAX's jitted step (``build_train_step``'s
                    # ``jitted``), the gradient its fourth output
                    fn = jax.jit(step_and_grads, in_shardings=where,
                                 out_shardings=(pshard, oshard, None, None),
                                 donate_argnums=(0, 1))

                    def with_grads(*args, fn=fn, where=where):
                        return fn(*jax.device_put(args, where))

                    def run(*args, with_grads=with_grads):
                        return with_grads(*args)[:3]
                    run.with_grads = with_grads
                    jits[shapes] = run
                return jits[shapes]
            cache[key] = (step, jitted_once, pshard, oshard)
        return cache[key]
    jsteps.build_train_step = build_once
    jsteps.adamw_update = taking_adamw_update
    yield
    jsteps.build_train_step = build
    jsteps.adamw_update = adamw_update


def batch_np(cfg, step=0):
    b = SyntheticLMData(cfg, ShapeConfig("t", S, B, "train")).batch_at(step)
    b["labels"][0, :10] = -100          # pads
    b["labels"][2, -5:] = -100
    return b


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", CASES[:3], ids=case_id)
def test_loss_matches_jax(c):
    jcfg, cfg = configs(*c)
    p = jax.tree.map(jnp.asarray, model.params_to_numpy(
        model.init_params(cfg, 1, CPU)))
    b = batch_np(cfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    @jax.jit
    def jax_side(p):
        loss, aux = jmodel.loss_fn(p, jcfg, jb)
        x, _ = jmodel.forward(p, jcfg, jb)
        return loss, aux["ce_loss"], jmodel.chunked_cross_entropy(
            p, jcfg, x, jb["labels"], chunk=16)
    want = [float(v) for v in jax_side(p)]

    tp = model.params_from_numpy(cfg, jax.tree.map(np.asarray, p), CPU)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        loss, aux = model.loss_fn(tp, cfg, tb)
        x, _ = model.forward(tp, cfg, tb)
        chunked = model.chunked_cross_entropy(tp, cfg, x, tb["labels"],
                                              chunk=16)
    for got, w in zip((loss, aux["ce_loss"], chunked), want):
        assert rel(got, w) <= 1e-6, (float(got), w)
    with pytest.raises(ValueError, match="multiple"):
        model.chunked_cross_entropy(tp, cfg, x, tb["labels"], chunk=24)


def test_input_specs_match_jax():
    jcfg, cfg = configs("h2o-danube-1.8b", "float32")
    for kind in ("train", "prefill"):
        want = jmodel.input_specs(jcfg, JShapeConfig("t", 128, 4, kind))
        got = model.input_specs(cfg, ShapeConfig("t", 128, 4, kind))
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape
            assert got[k].dtype == torch.int32 and want[k].dtype == jnp.int32
    jshape, shape = JShapeConfig("d", 256, 4, "decode"), \
        ShapeConfig("d", 256, 4, "decode")
    jctx = jmodel.make_decode_ctx(jcfg, JServeConfig(jcfg, jshape,
                                                     kv_page_tokens=32), 4)
    ctx = model.make_decode_ctx(cfg, ServeConfig(cfg, shape,
                                                 kv_page_tokens=32), 4)
    want = jmodel.input_specs(jcfg, jshape, ctx=jctx)
    got = model.input_specs(cfg, shape, ctx=ctx)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


# ---------------------------------------------------------------------------
# One train step from carried parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", CASES + MOE_CASES + REST_CASES, ids=case_id)
def test_train_step_matches_jax(c, mesh, jax_state):
    jcfg, cfg = configs(*c)
    joc, oc = JOptimConfig(**OC), OptimConfig(**OC)
    p_np, opt_np = jax_state(jcfg, joc)
    p = jax.tree.map(jnp.asarray, p_np)
    b = batch_np(cfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    _, jitted, _, _ = jsteps.build_train_step(jcfg, joc, mesh,
                                              seq_shard=False)
    jp, _, jm, jg = jitted(b).with_grads(
        p, jax.tree.map(jnp.asarray, opt_np), jb)
    jgrads = flatten_tree(jax.tree.map(np.asarray, jg))
    want = flatten_tree(jax.tree.map(np.asarray, jp))

    tp = model.params_from_numpy(cfg, p_np, CPU)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    step = steps.build_train_step(cfg, oc)
    # the step's two halves, so that its gradient is taken once
    loss, metrics, grads = step.loss_and_grads(tp, tb)
    names = [n for n, _ in tp.named_parameters()]
    tgrads = [grads[n] for n in names]
    tp, opt, stats = step.apply_grads(tp, init_opt_state(tp, oc), grads)
    tm = {"loss": loss, **metrics, **stats}
    got = flatten_tree(model.params_to_numpy(tp))
    assert int(opt["step"]) == 1
    lr = float(jm["lr"])
    assert rel(tm["lr"], jm["lr"]) <= 1e-5

    if c[1] == "bfloat16":
        assert rel(tm["loss"], jm["loss"]) <= 1e-4
        assert rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-3
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= 2 * lr, k
        return
    assert set(tm) == set(jm)
    for k in ("loss", "ce_loss", "grad_norm", "moe_aux", "moe_z"):
        if k in jm:
            assert rel(tm[k], jm[k]) <= 1e-5, k
    if "moe_dropped" in jm:
        assert float(tm["moe_dropped"]) == float(jm["moe_dropped"])
    stacked = {}
    for n, g in zip(names, tgrads):
        path, i = model._jax_path(n)
        stacked.setdefault(path, []).append(g.numpy())
    for path, gs in stacked.items():
        g = np.stack(gs) if path.startswith("stacks") else gs[0]
        wg = jgrads[path]
        assert np.abs(g - wg).max() <= GRAD_TOL.get(c[0], 1e-5) * \
            np.abs(wg).max(), path
        d = np.abs(got[path] - want[path])
        sure = np.abs(wg) >= 1e-6
        assert d[sure].max(initial=0) <= 1e-5, path
        assert d.max() <= 2 * lr, path
    if jcfg.is_encoder_decoder:
        # the loss reads final_norm's scale only: its bias gets a zero
        # gradient and zero moments, and stays at zero, as in JAX
        n = "final_norm.bias"
        assert not np.any(jgrads["final_norm/bias"])
        assert not torch.any(tgrads[names.index(n)])
        assert not torch.any(opt["m"][n]) and not torch.any(opt["v"][n])
        assert not np.any(got["final_norm/bias"])


def test_train_step_refuses_a_mesh_of_more_than_one_shard():
    """A bare shape of more than one shard builds no world.  Training over
    a ``ModelMesh`` (every family's) is
    ``tests/test_torch_train_ranks.py``'s."""
    _, cfg = configs("llama3-8b", "float32")
    steps.build_train_step(cfg, OptimConfig(), {"data": 1, "model": 1})
    with pytest.raises(NotImplementedError, match="ModelMesh"):
        steps.build_train_step(cfg, OptimConfig(), {"data": 2, "model": 1})
    with pytest.raises(NotImplementedError, match="ModelMesh"):
        steps.init_train_state(cfg, OptimConfig(), {"model": 4}, 0, CPU)


# ---------------------------------------------------------------------------
# train() resumes from JAX's step-0 checkpoint and follows JAX's losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", CASES[:3] + MOE_CASES[1:] + REST_CASES,
                         ids=case_id)
def test_train_from_jax_checkpoint_follows_jax(c, mesh, tmp_path,
                                              jax_state):
    jcfg, cfg = configs(*c)
    joc, oc = JOptimConfig(**OC), OptimConfig(**OC)
    params, opt = jax_state(jcfg, joc)
    JCheckpointer(str(tmp_path / "j"), async_save=False).save(
        0, {"params": params, "opt": opt})
    shutil.copytree(tmp_path / "j", tmp_path / "p")
    _, _, want, _, _ = j_train(jcfg, JShapeConfig("t", S, B, "train"), joc,
                               mesh, num_steps=8, ckpt_dir=str(tmp_path / "j"),
                               ckpt_every=0, verbose=False)
    _, _, got, _, pol = ttrain.train(
        cfg, ShapeConfig("t", S, B, "train"), oc, num_steps=8,
        ckpt_dir=str(tmp_path / "p"), ckpt_every=0, verbose=False,
        device=CPU)
    assert sorted(got) == list(range(8)) and pol.restarts == 0
    for s in range(8):
        tol = LOSS_TOL.get(c[0], 1e-5) if s >= 2 else 1e-5
        assert rel(got[s], want[s]) <= tol, (s, got[s], want[s])


# ---------------------------------------------------------------------------
# The decay mask and int8 compression on the unit trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["jamba-v0.1-52b",
                                  "llama4-maverick-400b-a17b"])
def test_decay_mask_matches_jax_on_every_leaf(arch):
    from repro.optim.adamw import _decay_mask as j_decay_mask
    from repro_torch.optim.adamw import _decay_mask
    jcfg, cfg = j_smoke_config(arch), smoke_config(arch)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    want = {"/".join(str(k.key) for k in path): j_decay_mask(path)
            for path, _ in jax.tree_util.tree_leaves_with_path(shapes)}
    m = model.Model(cfg, "meta")
    got = {}
    for name, _ in m.named_parameters():
        got.setdefault(model._jax_path(name)[0], set()).add(_decay_mask(name))
    assert got == {k: {v} for k, v in want.items()}
    # mamba's A_log, D, conv_b and conv_w and the experts decay; dt_bias and
    # the norms do not
    for leaf, decays in (("mamba/A_log", True), ("mamba/D", True),
                         ("mamba/conv_b", True), ("mamba/conv_w", True),
                         ("ffn_moe/gate", True), ("ffn_moe/router", True),
                         ("mamba/dt_bias", False), ("norm1/scale", False)):
        hits = [v for k, v in want.items() if k.endswith(leaf)]
        if arch.startswith("jamba") or not leaf.startswith("mamba"):
            assert hits and all(h == decays for h in hits), leaf


@pytest.mark.parametrize("arch", ["whisper-tiny", "xlstm-1.3b"])
def test_decay_mask_matches_jax_on_the_encdec_and_xlstm_trees(arch):
    """On ``stacks/{encoder, decoder}`` and the xLSTM blocks: the centred
    norms' scales and biases, the sLSTM's ``bg`` and the ``gn_scale``s do
    not decay; every projection does."""
    from repro.optim.adamw import _decay_mask as j_decay_mask
    from repro_torch.optim.adamw import _decay_mask
    jcfg, cfg = j_smoke_config(arch), smoke_config(arch)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    want = {"/".join(str(k.key) for k in path): j_decay_mask(path)
            for path, _ in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {}
    for name, _ in model.Model(cfg, "meta").named_parameters():
        got.setdefault(model._jax_path(name)[0], set()).add(_decay_mask(name))
    assert got == {k: {v} for k, v in want.items()}
    leaves = (("stacks/encoder/norm1/bias", False),
              ("stacks/decoder/norm_x/scale", False),
              ("stacks/decoder/cross/wk", True), ("final_norm/bias", False),
              ("stacks/encoder/ffn/up", True)) if arch == "whisper-tiny" \
        else (("stacks/j0/slstm/bg", True), ("stacks/j0/slstm/rg", True),
              ("stacks/j1/mlstm/gn_scale", False),
              ("stacks/j1/mlstm/wi", True))
    for leaf, decays in leaves:
        assert want[leaf] == decays, leaf


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-2b"])
def test_input_specs_of_encdec_and_vlm_match_jax(arch):
    jcfg, cfg = j_smoke_config(arch), smoke_config(arch)
    for S in (128, 1024):
        for kind in ("train", "prefill"):
            want = jmodel.input_specs(jcfg, JShapeConfig("t", S, 4, kind))
            got = model.input_specs(cfg, ShapeConfig("t", S, 4, kind))
            assert want.keys() == got.keys()
            for k in want:
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == want[k].shape, k
                assert str(got[k].dtype).split(".")[-1] == \
                    str(want[k].dtype), k


def test_int8_compression_of_a_unit_tree_is_jax_s():
    """One int8 scale per JAX leaf: ``stacks/j{j}/...`` stacks layer j of
    every unit, so its scale is the largest magnitude over them."""
    from repro.distributed import compression as jcomp
    from repro_torch.distributed import compression
    jcfg = j_smoke_config("jamba-v0.1-52b").replace(num_layers=8)
    cfg = smoke_config("jamba-v0.1-52b").replace(num_layers=8)
    rng = np.random.default_rng(4)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32) * rng.uniform(0.1, 10), shapes)
    # two units: unit 1's layers three times unit 0's, per leaf
    tree["stacks"] = jax.tree.map(
        lambda a: a * np.asarray([1.0, 3.0], np.float32).reshape(
            (2,) + (1,) * (a.ndim - 1)), tree["stacks"])
    grads = model.ParamDict(model.params_from_numpy(cfg, tree, CPU)
                            .named_parameters())
    got = flatten_tree(model.params_to_numpy(_as_model(
        cfg, compression.compress_tree(grads, "int8"))))
    want = flatten_tree(jax.tree.map(np.asarray, jcomp.compress_tree(
        jax.tree.map(jnp.asarray, tree), "int8")))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)


def _as_model(cfg, pd):
    m = model.Model(cfg, CPU)
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(pd[n])
    return m


# ---------------------------------------------------------------------------
# Serving builds no autograd graph
# ---------------------------------------------------------------------------

def test_serving_builds_no_autograd_graph(monkeypatch):
    cfg = smoke_config("llama3-8b").replace(dtype="float32")
    seen, outs = [], []
    decode = model.decode_step

    def spy(*a, **kw):
        seen.append(torch.is_grad_enabled())
        out = decode(*a, **kw)
        outs.append(out[0].requires_grad)
        return out
    monkeypatch.setattr(model, "decode_step", spy)
    params = model.init_params(cfg, 0, CPU)
    assert params.embed.requires_grad       # the model is trainable
    done, _, _ = tserve.serve(cfg, batch=2, requests=3, max_new=3,
                              horizon=16, page_tokens=4, verbose=False,
                              device=CPU)
    assert len(done) == 3 and seen and not any(seen) and not any(outs)
    seen.clear()
    scfg = ServeConfig(cfg, ShapeConfig("s", 16, 2, "decode"),
                       kv_page_tokens=4)
    serve_step, ctx = steps.build_serve_step(cfg, scfg)
    states = model.init_decode_states(params, cfg, 2, ctx,
                                      kv_dtype=torch.float32)
    bt = torch.arange(2 * ctx.n_pages, dtype=torch.int32).reshape(2, -1)
    nt, logits, states = serve_step(
        params, states, torch.zeros((2, 1), dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32), bt)
    assert seen == [False]
    assert not logits.requires_grad and not states[0]["k_pool"].requires_grad
