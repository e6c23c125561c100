"""Step factories of the port (the JAX package's ``distributed/steps.py``).

``build_train_step`` gives the training step: the loss and its gradient,
optional gradient compression, then the AdamW update, in place.
``build_serve_step`` gives the decode step the serving loop calls: one
``decode_step`` and the greedy next token, under ``torch.no_grad()``.  JAX
jits both with their parameter and state shardings.  The port runs them
eagerly, on one device or on each rank of a ``launch.mesh.ModelMesh``: the
serve step and the train step for every family (``decode_state_specs``
places the decode states as JAX's), each rank with its blocks of the
parameters and moments (``param_specs``) and its rows of the batch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.compression import compress_tree
from repro_torch.launch.mesh import ModelMesh
from repro_torch.models import model
from repro_torch.optim import adamw_update, init_opt_state

def train_mesh(mesh):
    """The ``ModelMesh`` to train over, or None for one device: ``mesh`` is
    None, a ``ModelMesh``, or a shape {axis: size} of one shard.  A bare
    shape of more than one shard builds no world: it raises."""
    if mesh is None:
        return None
    if isinstance(mesh, ModelMesh):
        return mesh
    shape = sharding.mesh_shape(mesh)
    n = math.prod(shape.values())
    if n > 1:
        raise NotImplementedError(
            f"a training mesh of {shape} as a bare shape builds no world: "
            f"train over a launch.mesh.ModelMesh (make_model_mesh in every "
            f"rank, or launch.train.train_ranks)")
    return None


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------

def build_train_step(cfg, oc, mesh=None, *, seq_shard: bool = True,
                     grad_compression: str = "none"):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "ce_loss", "grad_norm", "lr"})``: the loss and its gradient
    with respect to every parameter, ``compress_tree`` of the gradient when
    ``grad_compression`` is not ``"none"``, then ``adamw_update``, which
    updates ``params`` and the moments in place.  On one device
    (``mesh`` None or of one shard) ``batch`` holds the family's inputs
    (``model.input_specs``) on the parameters' device.  On a ``ModelMesh``
    every rank calls it with its model (``init_train_state``) and the
    whole batch, on any device: the step keeps its rows (``ShardCtx``;
    ``seq_shard`` as JAX's), sums each gradient's parts over the axes that
    replicate its leaf, and takes the norm, the int8 scale and the update
    over the mesh; every tensor keeps its ``.spec``.  The step's halves
    are ``train_step.loss_and_grads(params, batch) -> (loss, metrics,
    grads)`` and ``train_step.apply_grads(params, opt_state, grads) ->
    (params, opt_state, {"grad_norm", "lr"})``."""
    mesh = train_mesh(mesh)
    base = sharding.ShardCtx(mesh, seq_shard=seq_shard) if mesh else None

    def loss_and_grads(params, batch):
        names, tensors = zip(*params.named_parameters())
        kw = {}
        if base is not None:
            ctx = base.bind(*batch["labels"].shape)
            batch = ctx.local_batch(batch)
            kw = {"shard_ctx": ctx}
        with torch.enable_grad():
            loss, metrics = model.loss_fn(params, cfg, batch, **kw)
            # a leaf the loss never reads (whisper's final_norm/bias: the
            # loss takes final_norm's scale only) gets JAX's zero gradient
            grads = torch.autograd.grad(loss, tensors, allow_unused=True,
                                        materialize_grads=True)
        grads = dict(zip(names, grads))
        if base is not None:
            grads = tp.reduce_grads(mesh, dict(zip(names, tensors)), grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, model.ParamDict(grads)

    def apply_grads(params, opt_state, grads):
        if grad_compression != "none":
            grads = compress_tree(grads, grad_compression, mesh)
        return adamw_update(params, grads, opt_state, oc, mesh)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(params, batch)
        params, opt_state, stats = apply_grads(params, opt_state, grads)
        return params, opt_state, {"loss": loss, **metrics, **stats}

    train_step.loss_and_grads = loss_and_grads
    train_step.apply_grads = apply_grads
    return train_step


def init_train_state(cfg, oc, mesh=None, seed: int = 0, device=None):
    """(params, opt_state): a model drawn from ``seed`` on ``device`` (None:
    the card) and zero AdamW moments beside it; on a ``ModelMesh`` this
    rank's blocks of them (``model.init_params_sharded``), on the mesh's
    device."""
    mesh = train_mesh(mesh)
    if mesh is not None:
        params = model.init_params_sharded(cfg, seed, mesh)
    else:
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
