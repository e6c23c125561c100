"""How far float32 rounding carries through xlstm-1.3b, in the port and in
the JAX package alike, on the CPU.  Not a test: a script that prints the
numbers the xLSTM tolerances of ``tests/test_torch_train.py`` and
``chip_smoke.py`` phase 13 rest on.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/xlstm_drift.py \\
        [--layers 8 16] [--train] [--leaves]

  * ``--layers``: the largest |logit| difference of ``decode_step`` (the
    exact recurrence) against ``forward`` (the chunked mLSTM) over 2 x 64
    tokens, xlstm-1.3b at its published widths and the given depths,
    random init, float32, in the port and in JAX;
  * ``--train``: at ``smoke_config``, on ``tests/test_torch_train.py``'s
    batch and parameters, JAX against itself and the port against itself
    at mLSTM chunk 64 instead of 16 (the same function), and the port
    against JAX: one step's gradients (largest difference over a leaf's
    largest magnitude) and 8 steps of ``train`` from one JAX checkpoint
    (relative loss differences); and ``chip_smoke.py``'s 4-step small
    training, the port against JAX (relative loss and grad-norm
    differences by step);
  * ``--leaves``: one step's gradients leaf by leaf at 1 and 2 units of
    ``smoke_config`` (2 and 4 layers; a unit is an mLSTM and an sLSTM
    layer): for each leaf the largest difference over the leaf's largest
    magnitude, port against JAX beside JAX against itself at chunk 64
    instead of 16.  Rounding grows with depth alike in both columns; a
    fault shows as one leaf far above JAX's own spread at one unit.
"""
import argparse
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ServeConfig as JServeConfig
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import OptimConfig as JOptimConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.mesh import make_mesh
from repro.launch.train import train as j_train
from repro.models import model as jmodel

from repro_torch import configs
from repro_torch.launch import train as ttrain
from repro_torch.models import model

B, S, PT = 2, 64, 16
OC = dict(lr=1e-3, warmup_steps=2, total_steps=16)


def port_drift(L, tokens):
    cfg = configs.get_config("xlstm-1.3b").replace(num_layers=L,
                                                   dtype="float32")
    p = model.init_params(cfg, 0, "cpu")
    ctx = model.make_decode_ctx(cfg, configs.ServeConfig(
        cfg, configs.ShapeConfig("t", S, B, "decode"), kv_page_tokens=PT), B)
    bt = torch.arange(B * ctx.n_pages, dtype=torch.int32).reshape(B, -1)
    with torch.no_grad():
        st = model.init_decode_states(p, cfg, B, ctx, kv_dtype=torch.float32)
        dec = []
        for i in range(S):
            lg, st = model.decode_step(
                p, cfg, st, torch.from_numpy(tokens[:, i:i + 1]),
                torch.full((B,), i, dtype=torch.int32), bt, ctx)
            dec.append(lg[:, 0])
        x, _ = model.forward(p, cfg, {"tokens": torch.from_numpy(tokens)})
        full = model.logits_fn(p, cfg, x)
    return float((torch.stack(dec, 1) - full).abs().max())


def jax_drift(L, tokens):
    cfg = j_get_config("xlstm-1.3b").replace(num_layers=L, dtype="float32")
    p = jax.jit(jmodel.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    ctx = jmodel.make_decode_ctx(cfg, JServeConfig(
        cfg, JShapeConfig("t", S, B, "decode"), kv_page_tokens=PT), B)
    bt = jnp.arange(B * ctx.n_pages, dtype=jnp.int32).reshape(B, -1)
    st = jmodel.init_decode_states(p, cfg, B, ctx, kv_dtype=jnp.float32)
    step = jax.jit(lambda p, s, tk, pos: jmodel.decode_step(
        p, cfg, s, tk, pos, bt, ctx))
    dec = []
    for i in range(S):
        lg, st = step(p, st, jnp.asarray(tokens[:, i:i + 1]),
                      jnp.full((B,), i, jnp.int32))
        dec.append(np.asarray(lg[:, 0]))
    full = jax.jit(lambda p: jmodel.logits_fn(p, cfg, jmodel.forward(
        p, cfg, {"tokens": jnp.asarray(tokens)})[0]))(p)
    return float(np.abs(np.stack(dec, 1) - np.asarray(full)).max())


def _one_step_grads(layers):
    """{name: {leaf: gradient}} of one step at ``smoke_config`` cut to
    ``layers``, on tests/test_torch_train.py's batch: JAX at chunks 16 and
    64, the port at chunk 16."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.layers import flatten_tree
    base = j_smoke_config("xlstm-1.3b").replace(dtype="float32",
                                                 num_layers=layers)
    cfg = configs.smoke_config("xlstm-1.3b").replace(dtype="float32",
                                                      num_layers=layers)
    p = jmodel.init_params(base, jax.random.PRNGKey(0))
    b = SyntheticLMData(cfg, configs.ShapeConfig("t", 64, 4, "train")) \
        .batch_at(0)
    b["labels"][0, :10] = -100
    b["labels"][2, -5:] = -100
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}

    def jgrads(chunk):
        c = base.replace(mlstm_chunk=chunk)
        return flatten_tree(jax.tree.map(np.asarray, jax.jit(jax.grad(
            lambda q: jmodel.loss_fn(q, c, jb)[0]))(p)))

    tp = model.params_from_numpy(cfg, jax.tree.map(np.asarray, p), "cpu")
    names, ts = zip(*tp.named_parameters())
    g = torch.autograd.grad(model.loss_fn(tp, cfg, tb)[0], ts)
    stacked = {}
    for n, t in zip(names, g):
        stacked.setdefault(model._jax_path(n)[0], []).append(t.numpy())
    port = {k: np.stack(v) if k.startswith("stacks") else v[0]
            for k, v in stacked.items()}
    return {"jax16": jgrads(16), "jax64": jgrads(64), "port16": port}


def leaf_spread(units=(1, 2)):
    """Print one step's gradient spread leaf by leaf at each depth."""
    rows = {}
    for u in units:
        g = _one_step_grads(2 * u)
        for k in g["jax16"]:
            scale = np.abs(g["jax16"][k]).max()
            rows.setdefault(k, {})[u] = tuple(
                float(np.abs(g[a][k] - g["jax16"][k]).max() / scale)
                if scale else 0.0 for a in ("port16", "jax64"))
    print("leaf: port vs JAX, JAX chunk 64 vs 16 -- at "
          + ", ".join(f"{u} unit(s)" for u in units))
    for k, r in sorted(rows.items()):
        print(f"  {k}: " + "; ".join(f"{r[u][0]:.2e}, {r[u][1]:.2e}"
                                     for u in units))
    for u in units:
        port = max(r[u][0] for r in rows.values())
        own = max(r[u][1] for r in rows.values())
        print(f"{u} unit(s): worst leaf port vs JAX {port:.2e}, JAX's own "
              f"rechunking {own:.2e}, ratio {port / own:.2f}")


def train_sensitivity():
    from repro.checkpoint import Checkpointer as JCheckpointer
    from repro.distributed import steps as jsteps
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.layers import flatten_tree
    mesh = make_mesh((1, 1), ("data", "model"))
    base = j_smoke_config("xlstm-1.3b").replace(dtype="float32")
    cfg = configs.smoke_config("xlstm-1.3b").replace(dtype="float32")
    p = jmodel.init_params(base, jax.random.PRNGKey(0))
    b = SyntheticLMData(cfg, configs.ShapeConfig("t", 64, 4, "train")) \
        .batch_at(0)
    b["labels"][0, :10] = -100          # tests/test_torch_train.py's pads
    b["labels"][2, -5:] = -100
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}

    def jgrads(chunk):
        c = base.replace(mlstm_chunk=chunk)
        return flatten_tree(jax.tree.map(np.asarray, jax.jit(jax.grad(
            lambda q: jmodel.loss_fn(q, c, jb)[0]))(p)))

    def tgrads(chunk):
        tp = model.params_from_numpy(cfg, jax.tree.map(np.asarray, p), "cpu")
        names, ts = zip(*tp.named_parameters())
        g = torch.autograd.grad(model.loss_fn(
            tp, cfg.replace(mlstm_chunk=chunk), tb)[0], ts)
        stacked = {}
        for n, t in zip(names, g):
            stacked.setdefault(model._jax_path(n)[0], []).append(t.numpy())
        return {k: np.stack(v) if k.startswith("stacks") else v[0]
                for k, v in stacked.items()}

    g = {"jax16": jgrads(16), "jax64": jgrads(64), "port16": tgrads(16),
         "port64": tgrads(64)}

    def worst(a, b):
        return max(float(np.abs(g[a][k] - g[b][k]).max()
                         / np.abs(g[b][k]).max()) for k in g[b])
    print(f"one step's gradients, largest difference over a leaf's largest "
          f"magnitude: jax64 vs jax16 {worst('jax64', 'jax16'):.2e}, port64 "
          f"vs port16 {worst('port64', 'port16'):.2e}, port16 vs jax16 "
          f"{worst('port16', 'jax16'):.2e}")
    losses = {}
    with tempfile.TemporaryDirectory() as d:
        oc = JOptimConfig(**OC)
        params, opt = jsteps.init_train_state(base, oc, mesh,
                                              jax.random.PRNGKey(0))
        JCheckpointer(f"{d}/init", async_save=False).save(
            0, {"params": params, "opt": opt})
        for name in ("jax16", "jax64", "port16"):
            shutil.copytree(f"{d}/init", f"{d}/{name}")
            if name == "port16":
                _, _, losses[name], _, _ = ttrain.train(
                    cfg, configs.ShapeConfig("t", 64, 4, "train"),
                    configs.OptimConfig(**OC), num_steps=8,
                    ckpt_dir=f"{d}/{name}", ckpt_every=0, verbose=False,
                    device="cpu")
            else:
                _, _, losses[name], _, _ = j_train(
                    base.replace(mlstm_chunk=int(name[3:])),
                    JShapeConfig("t", 64, 4, "train"), oc, mesh,
                    num_steps=8, ckpt_dir=f"{d}/{name}", ckpt_every=0,
                    verbose=False)
    for other in ("jax64", "port16"):
        rel = [abs(losses[other][s] - losses["jax16"][s])
               / abs(losses["jax16"][s]) for s in range(8)]
        print(f"8 train steps from one JAX checkpoint, {other} against "
              f"jax16, relative loss difference by step: "
              f"{['%.2e' % r for r in rel]}")
    small_train_norms(cfg, base, mesh)


def small_train_norms(cfg, jcfg, mesh):
    """chip_smoke.py's small training check (4 steps of 4 x 64 tokens, its
    optimizer settings and batches) from one set of parameters, the port
    against JAX: relative loss and grad-norm differences by step."""
    from repro.distributed import steps as jsteps
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import steps
    from repro_torch.optim import init_opt_state
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=16)
    tree = model.params_to_numpy(model.init_params(cfg, 0, "cpu"))
    data = SyntheticLMData(cfg, configs.ShapeConfig("t", 64, 4, "train"))
    tp = model.params_from_numpy(cfg, tree, "cpu")
    topt = init_opt_state(tp, configs.OptimConfig(**oc))
    step = steps.build_train_step(cfg, configs.OptimConfig(**oc))
    jp = jax.tree.map(jnp.asarray, tree)
    joc = JOptimConfig(**oc)
    jopt = jsteps.init_opt_state(jp, joc)
    _, jitted, _, _ = jsteps.build_train_step(jcfg, joc, mesh,
                                              seq_shard=False)
    rl, rn = [], []
    for s in range(4):
        b = data.batch_at(s)
        tp, topt, tm = step(tp, topt, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jp, jopt, jm = jitted(jb)(jp, jopt, jb)
        rl.append(abs(float(tm["loss"]) - float(jm["loss"]))
                  / abs(float(jm["loss"])))
        rn.append(abs(float(tm["grad_norm"]) - float(jm["grad_norm"]))
                  / abs(float(jm["grad_norm"])))
    print(f"chip_smoke's small training, port against JAX by step: "
          f"relative loss {['%.2e' % r for r in rl]}, relative grad norm "
          f"{['%.2e' % r for r in rn]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="*", default=[8, 16])
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--leaves", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    tokens = np.random.default_rng(1).integers(
        0, 50304, (B, S)).astype(np.int32)
    for L in args.layers:
        print(f"xlstm-1.3b widths, {L} layers, decode vs forward, max "
              f"|logit diff|: port {port_drift(L, tokens):.3e}, JAX "
              f"{jax_drift(L, tokens):.3e}")
    if args.train:
        train_sensitivity()
    if args.leaves:
        leaf_spread()


if __name__ == "__main__":
    main()
