"""Training driver of the port (the JAX package's ``launch/train.py``): data
pipeline -> train step, with checkpointing, failure injection/restart,
straggler monitoring and gradient compression, on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --smoke --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --smoke --steps 50 --ckpt-dir /tmp/ck --inject-failure-at 20

The flags are the JAX CLI's, plus ``--device`` (the card by default; "cpu"
runs the plain PyTorch path), less ``--mesh``: the port trains on one card.
The checkpoint format is JAX's, so a run resumes from a checkpoint either
package wrote.
"""
from __future__ import annotations

import argparse
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
from repro_torch.models import model
from repro_torch.optim import init_opt_state


def train(cfg, shape, oc, mesh=None, *, num_steps, ckpt_dir, ckpt_every=50,
          log_every=10, inject=None, seed=0, grad_compression="none",
          verbose=True, device=None):
    """Train ``num_steps`` steps on ``device`` (None: the card), resuming
    from the latest checkpoint in ``ckpt_dir`` (else a model drawn from
    ``seed``), saving every ``ckpt_every`` steps and at the end; with
    ``ckpt_dir=None`` nothing is saved or restored.  An
    ``InjectedFailure`` at a step of ``inject`` restarts from the latest
    checkpoint.  Returns (params, opt_state, {step: loss}, the
    StragglerMonitor, the RestartPolicy)."""
    dev = resolve_device(device)
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir is not None else None
    injector = FailureInjector(tuple(inject or ()))
    policy = RestartPolicy(max_restarts=4)
    monitor = StragglerMonitor()
    step_fn = dsteps.build_train_step(cfg, oc, mesh,
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
                target = _restore_tree_shapes(cfg, oc)
                restored = ckpt.restore(start, target, device=dev)
                params, opt_state = restored["params"], restored["opt"]
                if verbose:
                    print(f"[restore] resumed from step {start}")
            for step in range(start, num_steps):
                injector.check(step)
                batch = {k: torch.from_numpy(v).to(dev)
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


def _restore_tree_shapes(cfg, oc):
    """The train state's structure on the meta device (no memory)."""
    params = model.Model(cfg, "meta")
    return {"params": params, "opt": init_opt_state(params, oc)}


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
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path; the card by "
                         "default")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    oc = OptimConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                     total_steps=args.steps)

    _, _, losses, monitor, policy = train(
        cfg, shape, oc, num_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, inject=args.inject_failure_at,
        grad_compression=args.grad_compression, device=args.device)
    ls = sorted(losses)
    if not ls:
        print(f"no step to run: {args.ckpt_dir} holds step {args.steps}")
        return losses
    print(f"first loss {losses[ls[0]]:.4f} -> last loss {losses[ls[-1]]:.4f}; "
          f"restarts={policy.restarts} stragglers={len(monitor.flagged)}")
    return losses


if __name__ == "__main__":
    main()
