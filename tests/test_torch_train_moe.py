"""Parity of the port's training stack with the JAX package's on the moe and
hybrid families: one step of olmoe-1b-7b and of jamba-v0.1-52b, 8 steps of
``train`` of jamba, the decay mask and int8 compression on their
``stacks/j{j}`` trees, and the one-shard mesh rule. The tolerances are set
out in ``tests/train_cases.py``."""
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

from repro_torch.configs import OptimConfig, ShapeConfig, smoke_config
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

MOE_CASES = [("olmoe-1b-7b", "float32"), ("jamba-v0.1-52b", "float32")]


# ---------------------------------------------------------------------------
# One train step from carried parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c", MOE_CASES, ids=case_id)
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
@pytest.mark.parametrize("c", MOE_CASES[1:], ids=case_id)
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
