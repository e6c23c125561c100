"""Parity of the port's training stack with the JAX package's on the dense
family: llama3-8b, qwen3-8b and h2o-danube-1.8b in float32 and llama3-8b in
bfloat16 (``loss_fn``, one ``train_step``, 8 steps of ``train`` from a JAX
step-0 checkpoint, ``input_specs``). The tolerances are set out in
``tests/train_cases.py``."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs.base import OptimConfig as JOptimConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.distributed import steps as jsteps
from repro.launch.train import train as j_train
from repro.models import model as jmodel

from repro_torch.configs import OptimConfig, ServeConfig, ShapeConfig
from repro_torch.distributed import steps
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

CASES = [("llama3-8b", "float32"), ("qwen3-8b", "float32"),
         ("h2o-danube-1.8b", "float32"), ("llama3-8b", "bfloat16")]


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
@pytest.mark.parametrize("c", CASES, ids=case_id)
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
@pytest.mark.parametrize("c", CASES[:3], ids=case_id)
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
