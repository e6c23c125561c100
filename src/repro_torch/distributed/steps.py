"""Step factories of the port (the JAX package's ``distributed/steps.py``).

``build_train_step`` gives the training step: the loss and its gradient,
optional gradient compression, then the AdamW update, in place.
``build_serve_step`` gives the decode step the serving loop calls: one
``decode_step`` and the greedy next token, under ``torch.no_grad()``.  JAX
jits both with their parameter and state shardings.  The port runs them
eagerly: the serve step on one device, or on each rank of a
``launch.mesh.ModelMesh`` (the dense family; ``decode_state_specs`` places
the states as JAX's); the train step on one card, refusing a mesh of more
than one shard (ROADMAP Queue 1 item 16b-ii).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.compression import compress_tree
from repro_torch.models import model
from repro_torch.optim import adamw_update, init_opt_state


def _one_card(mesh):
    """``mesh`` is None or a JAX mesh's shape, {axis name: size}; the port
    trains on one card."""
    shape = sharding.mesh_shape(mesh) if mesh is not None else {}
    if int(np.prod(list(shape.values()))) > 1:
        raise NotImplementedError(
            f"a training mesh of {shape} shards the parameters and the "
            f"batch over several cards; the port trains on one card "
            f"(training over ranks: ROADMAP Queue 1 item 16b-ii)")


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


_STATE_AXES = {
    # name, ndim -> logical axes (JAX's table, less the stacked layer dim)
    ("k_pool", 4): ("kv_pages", "seq", "kv_heads", "head_dim"),
    ("v_pool", 4): ("kv_pages", "seq", "kv_heads", "head_dim"),
    ("conv", 3): ("batch", "conv", "mlp"),
    ("ssm", 3): ("batch", "mlp", "state"),
    ("C", 4): ("batch", "heads", "head_dim", "head_dim"),
    ("n", 3): ("batch", "heads", "head_dim"),
    ("m", 2): ("batch", "heads"),
    ("c", 3): ("batch", "heads", "head_dim"),
    ("h", 3): ("batch", "heads", "head_dim"),
    ("m", 3): ("batch", "heads", "head_dim"),
    ("ek", 4): ("batch", "seq", "kv_heads", "head_dim"),
    ("ev", 4): ("batch", "seq", "kv_heads", "head_dim"),
}


def decode_state_specs(states, mesh) -> list:
    """[{state name: spec}] a layer, for the whole decode states
    (``model.init_decode_states`` on one device, or their shapes): a pool
    splits its pages over every mesh axis (grouped: rank g*Dm + m holds
    pages [flat*pps, (flat+1)*pps)), a recurrent state its batch; JAX's
    ``decode_state_specs`` less the layer dimension, which no rule
    shards."""
    return [{name: sharding.spec_for(mesh, _STATE_AXES[(name, x.dim())],
                                     x.shape)
             if (name, x.dim()) in _STATE_AXES else ()
             for name, x in layer.items()} for layer in states]


def build_serve_step(cfg, serve_cfg, mesh=None):
    """Returns (serve_step, ctx).  ``serve_step(params, states, tokens, pos,
    block_table, full_logits=True) -> (next_tok (B,) int32, logits (B,1,V),
    states)``; ``mesh`` as in ``model.make_decode_ctx``.  On a
    ``ModelMesh`` the step takes this rank's model (``model.shard_params``)
    and states, and its batch group's rows (``ctx.local_batch``); the next
    tokens, all-gathered over the batch groups, are the whole batch's; the
    logits are the rank's rows, over the whole vocabulary with
    ``full_logits``, else its vocabulary block (no collective)."""
    B = serve_cfg.shape.global_batch
    model.refuse_sharded_decode(cfg, mesh)
    ctx = model.make_decode_ctx(cfg, serve_cfg, B, mesh=mesh)

    @torch.no_grad()
    def serve_step(params, states, tokens, pos, block_table,
                   full_logits=True):
        logits, new_states = model.decode_step(
            params, cfg, states, tokens, pos, block_table, ctx)
        if not ctx.ranked:
            next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            return next_tok, logits, new_states
        head = params.embed if cfg.tie_embeddings else params.head
        next_tok = tp.greedy(logits[:, -1], head, ctx.mesh)
        next_tok = ctx.mesh.all_gather(next_tok.to(torch.int32),
                                       ctx.batch_axes)
        if full_logits:
            logits = tp.gather_vocab(logits, head, ctx.mesh)
        return next_tok, logits, new_states

    return serve_step, ctx
