"""Parity of the port's training stack with the JAX package's on the ssm,
encdec and vlm families: one step and 8 steps of ``train`` of xlstm-1.3b,
whisper-tiny and internvl2-2b, the decay mask on the ``stacks/{encoder,
decoder}`` and xLSTM trees, ``input_specs`` of encdec and vlm, and serving
that builds no autograd graph. The tolerances are set out in
``tests/train_cases.py``."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import OptimConfig as JOptimConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.distributed import steps as jsteps
from repro.launch.train import train as j_train
from repro.models import model as jmodel

from repro_torch.configs import (OptimConfig, ServeConfig, ShapeConfig,
                                 smoke_config)
from repro_torch.distributed import steps
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import model
from repro_torch.models.layers import flatten_tree
from repro_torch.optim import init_opt_state

import torch_threads
import train_cases
from train_cases import (
    B, CPU, GRAD_TOL, LOSS_TOL, OC, S, batch_np, case_id, configs, rel)

mesh = train_cases.mesh
jax_state = train_cases.jax_state
jax_train_step_once = train_cases.jax_train_step_once

one_thread = torch_threads.one_thread

REST_CASES = [("xlstm-1.3b", "float32"), ("whisper-tiny", "float32"),
              ("internvl2-2b", "float32")]


# ---------------------------------------------------------------------------
# One train step from carried parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c", REST_CASES, ids=case_id)
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


# ---------------------------------------------------------------------------
# train() resumes from JAX's step-0 checkpoint and follows JAX's losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c", REST_CASES, ids=case_id)
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
