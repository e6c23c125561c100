"""AdamW with global-norm clipping and warmup+cosine schedule (the JAX
package's ``optim/adamw.py``), updating the parameters and moments in place.

Optimizer state dtype is configurable: ``state_dtype='bfloat16'`` halves the
m/v memory.  All update math runs in float32 regardless of storage dtype, in
JAX's order: the step counter (int32) is incremented before the schedule
reads it, the gradient norm is taken before clipping, and the bias
corrections are ``1 - b**t`` with a float32 ``t``.  Every scalar stays a
tensor on the parameters' device, so a step never waits for the card.

The state is ``{"m": ParamDict, "v": ParamDict, "step": int32 tensor}``,
the moments keyed like the model's parameters; the checkpoint writes them in
JAX's stacked layout (``models.model.jax_leaves``).  Over the ranks of a
``ModelMesh`` the moments are the blocks of their parameters (with the
same ``.spec``), the update is elementwise on them, and the gradient norm
is the whole gradient's (``global_norm``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs import OptimConfig
from repro_torch.models.model import ParamDict, _jax_path, named_tensors

F32 = torch.float32
STATE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 tensor on ``like``'s device.  Dividing by it is a
    true division on every device (PyTorch's CUDA kernels multiply by the
    reciprocal of a Python-number divisor, and ``number / tensor`` is
    ``reciprocal(tensor) * number``), which is JAX's arithmetic."""
    return torch.full((), x, dtype=F32, device=like.device)


def lr_schedule(oc: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(F32)
    warm = torch.clamp(step / scalar(max(oc.warmup_steps, 1), step), max=1.0)
    prog = torch.clamp((step - oc.warmup_steps) /
                       scalar(max(oc.total_steps - oc.warmup_steps, 1), step),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return oc.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(params, oc: OptimConfig) -> dict:
    """Zero moments beside ``params`` (a ``Model``, on any device, the meta
    device included) and a zero int32 step."""
    dt = STATE_DTYPES[oc.state_dtype]
    named = named_tensors(params)
    dev = next(iter(named.values())).device
    def zeros():
        out = ParamDict()
        for n, p in named.items():
            out[n] = torch.zeros(p.shape, dtype=dt, device=dev)
            if hasattr(p, "spec"):
                out[n].spec = p.spec
        return out
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, mesh=None, params=None) -> torch.Tensor:
    """The norm of every tensor of ``tree`` together.  Over ``mesh`` (a
    ``ModelMesh``; ``params``' tensors carry the blocks' specs) it is the
    whole gradient's: each rank's sum of squares counts a block that
    several ranks hold on the first of them only, and the sums are added
    over the mesh."""
    named = named_tensors(tree)
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                              for x in named.values()))
    from repro_torch.distributed import tensor_parallel as tp
    specs = named_tensors(params)
    dev = next(iter(named.values())).device
    local = sum((torch.sum(torch.square(x.to(F32))) for n, x in named.items()
                 if tp.first_replica(specs[n], mesh)),
                torch.zeros((), dtype=F32, device=dev))
    return torch.sqrt(mesh.all_reduce(local, mesh.axis_names))


def _decay_mask(name: str) -> bool:
    """No weight decay on norms/scales/biases (1-D params), decided on the
    JAX path string of the parameter's leaf (``"['stacks']/['j0']/
    ['norm1']/['scale']"``), as JAX decides it."""
    path = "/".join(f"['{k}']" for k in _jax_path(name)[0].split("/"))
    return "scale" not in path and "bias" not in path and "norm" not in path


@torch.no_grad()
def adamw_update(params, grads, state, oc: OptimConfig, mesh=None):
    """One AdamW step.  ``params`` (a ``Model``) and the moments of
    ``state`` are updated in place; ``grads`` is a ``ParamDict``; ``mesh``
    the ``ModelMesh`` whose rank's blocks they are, or None.  Returns
    (params, new state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    lr = lr_schedule(oc, step)
    gn = global_norm(grads, mesh, params)
    clip = torch.clamp(scalar(oc.grad_clip, gn) / torch.clamp(gn, min=1e-9),
                       max=1.0) if oc.grad_clip else 1.0
    sdt = STATE_DTYPES[oc.state_dtype]
    t = step.to(F32)
    bc1 = 1 - oc.b1 ** t
    bc2 = 1 - oc.b2 ** t
    for name, p in named_tensors(params).items():
        g, m, v = grads[name], state["m"][name], state["v"][name]
        g32 = g.to(F32) * clip
        m32 = oc.b1 * m.to(F32) + (1 - oc.b1) * g32
        v32 = oc.b2 * v.to(F32) + (1 - oc.b2) * torch.square(g32)
        upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + oc.eps)
        if oc.weight_decay and _decay_mask(name):
            upd = upd + oc.weight_decay * p.to(F32)
        p.copy_((p.to(F32) - lr * upd).to(p.dtype))
        m.copy_(m32.to(sdt))
        v.copy_(v32.to(sdt))
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gn, "lr": lr}
