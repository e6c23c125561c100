"""Step factories of the port (the JAX package's ``distributed/steps.py``).

``build_train_step`` gives the training step: the loss and its gradient,
optional gradient compression, then the AdamW update, in place.
``build_serve_step`` gives the decode step the serving loop calls: one
``decode_step`` and the greedy next token, under ``torch.no_grad()``.  JAX
jits both with their parameter and state shardings; the port runs them
eagerly on one card, with no shardings, and refuses a mesh of more than one
shard (ROADMAP Queue 1 item 16).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.compression import compress_tree
from repro_torch.models import model
from repro_torch.optim import adamw_update, init_opt_state


def _one_card(mesh):
    """``mesh`` is None or a JAX mesh's shape, {axis name: size}; the port
    trains on one card."""
    if mesh is not None and int(np.prod(list(mesh.values()))) > 1:
        raise NotImplementedError(
            f"a training mesh of {dict(mesh)} shards the parameters and the "
            f"batch over several cards; the port trains on one card (ROADMAP "
            f"Queue 1 item 16)")


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------

def build_train_step(cfg, oc, mesh=None, *, grad_compression: str = "none"):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "ce_loss", "grad_norm", "lr"})``: the loss and its gradient
    with respect to every parameter, ``compress_tree`` of the gradient when
    ``grad_compression`` is not ``"none"``, then ``adamw_update``, which
    updates ``params`` and the moments in place.  ``batch`` holds
    the family's inputs (``model.input_specs``) on the parameters'
    device."""
    _one_card(mesh)

    def train_step(params, opt_state, batch):
        names, tensors = zip(*params.named_parameters())
        with torch.enable_grad():
            loss, metrics = model.loss_fn(params, cfg, batch)
            # a leaf the loss never reads (whisper's final_norm/bias: the
            # loss takes final_norm's scale only) gets JAX's zero gradient
            grads = torch.autograd.grad(loss, tensors, allow_unused=True,
                                        materialize_grads=True)
        grads = model.ParamDict(zip(names, grads))
        if grad_compression != "none":
            grads = compress_tree(grads, grad_compression)
        params, opt_state, stats = adamw_update(params, grads, opt_state, oc)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {"loss": loss.detach(), **metrics, **stats}

    return train_step


def init_train_state(cfg, oc, mesh=None, seed: int = 0, device=None):
    """(params, opt_state): a model drawn from ``seed`` on ``device`` (None:
    the card) and zero AdamW moments beside it."""
    _one_card(mesh)
    params = model.init_params(cfg, seed, device)
    return params, init_opt_state(params, oc)


# ---------------------------------------------------------------------------
# Serve (decode)
# ---------------------------------------------------------------------------


def build_serve_step(cfg, serve_cfg, mesh=None):
    """Returns (serve_step, ctx).  ``serve_step(params, states, tokens, pos,
    block_table) -> (next_tok (B,) int32, logits (B,1,V), states)``;
    ``mesh`` as in ``model.make_decode_ctx``."""
    B = serve_cfg.shape.global_batch
    ctx = model.make_decode_ctx(cfg, serve_cfg, B, mesh=mesh)

    @torch.no_grad()
    def serve_step(params, states, tokens, pos, block_table):
        logits, new_states = model.decode_step(
            params, cfg, states, tokens, pos, block_table, ctx)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, logits, new_states

    return serve_step, ctx
