"""Training driver of the port (the JAX package's ``launch/train.py``): data
pipeline -> train step, with checkpointing, failure injection/restart,
straggler monitoring and gradient compression, on one card or over the
ranks of a ``("data",)``, ``("data", "model")`` or ``("pod", "data",
"model")`` mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --smoke --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --smoke --steps 50 --ckpt-dir /tmp/ck --inject-failure-at 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --smoke --steps 3 --mesh 2 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --smoke --steps 3 --mesh 2 1 2 --device cpu

The flags are the JAX CLI's, plus ``--device`` (the card by default; "cpu"
runs the plain PyTorch path).  ``--mesh`` takes one, two or three sizes
and names the axes as the JAX CLI does: ``D`` is ``("data",)``, ``D M``
``("data", "model")`` and ``P D M`` ``("pod", "data", "model")``.  A
mesh of one rank trains on one device, as JAX's default ``(1, 1)``; any
other trains over its rank processes (``train_ranks``): on the CPU over
gloo, else a card a rank over NCCL where there are enough cards, or every
rank on the one card over gloo.  The checkpoint format is JAX's, so a run
resumes from a checkpoint either package wrote, on any mesh.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import OptimConfig, ShapeConfig, get_config, \
    smoke_config
from repro_torch.core.layout import resolve_device
from repro_torch.data import SyntheticLMData
from repro_torch.distributed import steps as dsteps
from repro_torch.distributed.fault_tolerance import (
    FailureInjector, InjectedFailure, RestartPolicy, StragglerMonitor)
from repro_torch.launch.mesh import make_model_mesh, spawn_ranks
from repro_torch.models import model
from repro_torch.optim import init_opt_state


def train(cfg, shape, oc, mesh=None, *, num_steps, ckpt_dir, ckpt_every=50,
          log_every=10, inject=None, seed=0, grad_compression="none",
          seq_shard=False, verbose=True, device=None):
    """Train ``num_steps`` steps on ``device`` (None: the card), resuming
    from the latest checkpoint in ``ckpt_dir`` (else a model drawn from
    ``seed``), saving every ``ckpt_every`` steps and at the end; with
    ``ckpt_dir=None`` nothing is saved or restored.  An
    ``InjectedFailure`` at a step of ``inject`` restarts from the latest
    checkpoint.  With ``mesh`` a ``ModelMesh`` every rank calls it (SPMD):
    each draws the whole batch of a step and keeps its rows, holds its
    blocks of the state on the mesh's device, and takes part in every
    save and restore; rank 0 alone prints.  Returns (params, opt_state,
    {step: loss}, the StragglerMonitor, the RestartPolicy)."""
    mesh = dsteps.train_mesh(mesh)
    dev = mesh.device if mesh is not None else resolve_device(device)
    verbose = verbose and (mesh is None or mesh.rank == 0)
    ckpt = Checkpointer(ckpt_dir, mesh=mesh) if ckpt_dir is not None \
        else None
    injector = FailureInjector(tuple(inject or ()))
    policy = RestartPolicy(max_restarts=4)
    monitor = StragglerMonitor()
    step_fn = dsteps.build_train_step(cfg, oc, mesh, seq_shard=seq_shard,
                                      grad_compression=grad_compression)
    data = SyntheticLMData(cfg, shape, seed=seed)

    losses = {}
    while True:  # restart loop
        try:
            # a restart rebuilds params and moments from the checkpoint: the
            # failed attempt updated its tensors in place
            params = opt_state = start = None
            if ckpt is not None:
                ckpt.wait()
                start = ckpt.latest_step()
            if start is None:
                params, opt_state = dsteps.init_train_state(
                    cfg, oc, mesh, seed, dev)
                start = 0
            else:
                target = _restore_tree_shapes(cfg, oc, mesh)
                restored = ckpt.restore(start, target, device=dev)
                params, opt_state = restored["params"], restored["opt"]
                if verbose:
                    print(f"[restore] resumed from step {start}")
            for step in range(start, num_steps):
                injector.check(step)
                # over ranks the step keeps the rank's rows of the batch
                batch = {k: torch.from_numpy(v) if mesh is not None
                         else torch.from_numpy(v).to(dev)
                         for k, v in data.batch_at(step).items()}
                t0 = time.time()
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                loss = metrics["loss"].item()
                dt_s = time.time() - t0
                monitor.observe(step, dt_s)
                losses[step] = loss
                if verbose and (step % log_every == 0 or step == num_steps - 1):
                    print(f"step {step:5d} loss {loss:8.4f} "
                          f"grad_norm {float(metrics['grad_norm']):7.3f} "
                          f"lr {float(metrics['lr']):.2e} {dt_s*1e3:7.1f} ms")
                if ckpt is not None and ckpt_every and \
                        (step + 1) % ckpt_every == 0:
                    ckpt.save(step + 1, {"params": params, "opt": opt_state})
            if ckpt is not None:
                ckpt.save(num_steps, {"params": params, "opt": opt_state},
                          blocking=True)
                ckpt.wait()
            return params, opt_state, losses, monitor, policy
        except InjectedFailure as e:
            if verbose:
                print(f"[failure] {e}; restart {policy.restarts + 1}")
            if not policy.on_failure(e):
                raise


def _restore_tree_shapes(cfg, oc, mesh=None):
    """The train state's structure on the meta device (no memory): over a
    mesh, the rank's blocks."""
    params = model.Model(cfg, "meta") if mesh is None \
        else model.rank_model_meta(cfg, mesh)
    return {"params": params, "opt": init_opt_state(params, oc)}


def train_ranks(cfg, mesh_shape, shape, oc, *, device=None, **kw) -> list:
    """``train(cfg, shape, oc, mesh, **kw)`` over ``prod(mesh_shape)`` new
    rank processes (``launch.mesh.spawn_ranks``), laid out over
    ``mesh_shape`` ({axis: size}) by ``make_model_mesh``.  ``device`` "cpu"
    runs every rank on the CPU (gloo); None a card a rank where there are
    enough (nccl), else every rank on the one card (gloo).  Returns each
    rank's ({step: loss}, restarts, stragglers flagged)."""
    world = math.prod(mesh_shape.values())
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu and device is None and torch.cuda.device_count() < world:
        device = "cuda:0"
    backend = "gloo" if on_cpu or device is not None else "nccl"
    return spawn_ranks(_train_rank, world, cfg, dict(mesh_shape), shape, oc,
                       kw, backend=backend, device=device)


def _train_rank(world, cfg, mesh_shape, shape, oc, kw):
    """One rank of ``train_ranks``."""
    mesh = make_model_mesh(world, mesh_shape)
    _, _, losses, monitor, policy = train(cfg, shape, oc, mesh, **kw)
    return losses, policy.restarts, len(monitor.flagged)


MESH_AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def mesh_shape(sizes) -> dict | None:
    """``--mesh``'s sizes as {axis: size}, the axes named by their count as
    the JAX CLI names them; None without sizes (one device, as JAX's CLI
    takes ``--mesh`` with none)."""
    if not sizes:
        return None
    if len(sizes) not in MESH_AXES:
        raise ValueError(f"--mesh takes 1, 2 or 3 sizes (data; data model; "
                         f"pod data model), not {len(sizes)}")
    if min(sizes) < 1:
        raise ValueError(f"--mesh sizes must be positive: {list(sizes)}")
    return dict(zip(MESH_AXES[len(sizes)], sizes))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, nargs="*", default=None)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--mesh", type=int, nargs="*", default=None,
                    metavar="N",
                    help="train over a mesh of rank processes: D (data), "
                         "D M (data, model) or P D M (pod, data, model)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path; the card by "
                         "default")
    args = ap.parse_args(argv)
    try:
        mesh = mesh_shape(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    ranks = mesh is not None and math.prod(mesh.values()) > 1

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    oc = OptimConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                     total_steps=args.steps)

    kw = dict(num_steps=args.steps, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, inject=args.inject_failure_at,
              grad_compression=args.grad_compression)
    if ranks:
        losses, restarts, stragglers = train_ranks(
            cfg, mesh, shape, oc, device=args.device, **kw)[0]
    else:
        _, _, losses, monitor, policy = train(cfg, shape, oc,
                                              device=args.device, **kw)
        restarts, stragglers = policy.restarts, len(monitor.flagged)
    ls = sorted(losses)
    if not ls:
        print(f"no step to run: {args.ckpt_dir} holds step {args.steps}")
        return losses
    print(f"first loss {losses[ls[0]]:.4f} -> last loss {losses[ls[-1]]:.4f}; "
          f"restarts={restarts} stragglers={stragglers}")
    if ranks:
        print(f"losses: {[losses[s] for s in ls]!r}")
    return losses


if __name__ == "__main__":
    main()
