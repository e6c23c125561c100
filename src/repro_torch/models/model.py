"""Top-level model API of the port (the JAX package's ``models/model.py``)
for the dense family: init, forward, logits, decode, and the bridge that
carries a JAX parameter tree across (``params_from_numpy``).

``Model`` is an ``nn.Module`` tree with the JAX tree's names and layouts:
``embed``, ``head`` (absent when the embeddings are tied), ``final_norm``
and one ``DenseLayer`` a layer, which JAX stacks under ``stacks/j0`` with a
leading layer axis.  The loss (``chunked_cross_entropy``, ``loss_fn``) and
``input_specs`` wait for the training stack (ROADMAP Queue 1 item 13); the
other families for item 12.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core.layout import resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import (F32, RMSNorm, embed_init_,
                                       flatten_tree, param, rms_norm,
                                       unflatten_tree)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Model(nn.Module):
    """The dense LM's parameters.  With ``generator`` they are drawn on
    ``device`` as JAX's ``init_params`` draws them (other numbers: another
    generator); without, they are left uninitialised for loading."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        transformer.require_dense(cfg)
        pdt = DTYPES[cfg.param_dtype]
        V, d = cfg.padded_vocab, cfg.d_model
        self.embed = param((V, d), device, pdt)
        self.head = None if cfg.tie_embeddings else param((V, d), device, pdt)
        if generator is not None:
            embed_init_(self.embed, generator)
            if self.head is not None:
                embed_init_(self.head, generator)
        self.final_norm = RMSNorm(d, device)
        self.layers = nn.ModuleList(
            transformer.DenseLayer(cfg, device, pdt, generator)
            for _ in range(cfg.num_layers))


def init_params(cfg, seed: int = 0, device=None) -> Model:
    """Random init from ``seed`` with a ``torch.Generator`` on ``device``
    (None: the card), so a full-width model is drawn where it lives."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return Model(cfg, dev, g)


def count_params(cfg) -> int:
    """Parameter count, from shapes alone (a model on the meta device)."""
    return sum(p.numel() for p in Model(cfg, "meta").parameters())


# ---------------------------------------------------------------------------
# The JAX parameter tree <-> the module tree
# ---------------------------------------------------------------------------

def _jax_path(name: str):
    """Module parameter name -> (JAX tree path, layer index or None)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return "stacks/j0/" + "/".join(parts[2:]), int(parts[1])
    return "/".join(parts), None


def params_from_numpy(cfg, tree: dict, device=None) -> Model:
    """Load a JAX parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``: ``embed``, ``head``,
    ``final_norm/scale``, ``stacks/j0/{norm1/scale, attn/{wq, wk, wv, wo,
    q_scale, k_scale}, norm2/scale, ffn/{gate, up, down}}``, each layer leaf
    with the leading layer axis) into a ``Model`` on ``device``."""
    flat = flatten_tree(tree)
    m = Model(cfg, resolve_device(device))
    used = set()
    with torch.no_grad():
        for name, p in m.named_parameters():
            path, i = _jax_path(name)
            if path not in flat:
                raise KeyError(f"the tree has no {path!r} for {name}")
            a = np.asarray(flat[path])
            a = a if i is None else a[i]
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{path}: shape {a.shape}, the model "
                                 f"needs {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(a, np.float32)))
            used.add(path)
    extra = set(flat) - used
    if extra:
        raise KeyError(f"the tree has leaves the model lacks: {sorted(extra)}")
    return m


def params_to_numpy(params: Model) -> dict:
    """The inverse of ``params_from_numpy``: the JAX tree, float32 numpy
    leaves, layer leaves stacked on a leading layer axis."""
    flat, stacks = {}, {}
    for name, p in params.named_parameters():
        path, i = _jax_path(name)
        a = p.detach().to(F32).cpu().numpy()
        if i is None:
            flat[path] = a
        else:
            stacks.setdefault(path, []).append(a)
    flat.update({k: np.stack(v) for k, v in stacks.items()})
    return unflatten_tree(flat)


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _embed(params: Model, cfg, tokens):
    return params.embed[tokens.to(torch.int64)].to(DTYPES[cfg.dtype])


def forward(params: Model, cfg, batch):
    """Returns (final hidden (B,S,d), aux dict).  Causal LM trunk."""
    transformer.require_dense(cfg)
    x = _embed(params, cfg, batch["tokens"])
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    return transformer.apply_stack(params.layers, cfg, x, positions)


def _head(params: Model, cfg):
    return params.embed if cfg.tie_embeddings else params.head


def logits_fn(params: Model, cfg, x):
    """Full float32 logits over the padded vocabulary."""
    h = rms_norm(x, params.final_norm.scale, cfg.norm_eps)
    return h.to(F32) @ _head(params, cfg).to(F32).T


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def make_decode_ctx(cfg, serve_cfg, B, mesh=None):
    """Page-pool geometry for a decode batch, as JAX's ``make_decode_ctx``
    computes it.

    ``mesh`` is None or a JAX mesh's shape, an ordered {axis name: size}
    mapping (``dict(mesh.shape)``).  With a mesh, JAX groups sequences by
    batch shard and spreads a sequence's pages over the channel axes; the
    port holds one card, so it takes meshes of one batch group and one
    channel (JAX's serving CLI default, ``(1, 1)``), whose geometry equals
    the unsharded one, and refuses the rest (ROADMAP Queue 1 item 16).
    Sliding-window archs bound the live horizon to the window."""
    pt = serve_cfg.kv_page_tokens
    horizon = serve_cfg.shape.seq_len
    if cfg.sliding_window:
        horizon = min(horizon, cfg.sliding_window + pt)
    if mesh is None:
        n_pages = max(1, (horizon + pt - 1) // pt)
        return transformer.DecodeCtx(page_tokens=pt, n_pages=n_pages,
                                     pool_pages=B * n_pages)
    names = tuple(mesh)
    baxes = tuple(a for a in ("pod", "data") if a in names)
    d_batch = int(np.prod([mesh[a] for a in baxes]))
    if B % d_batch == 0 and d_batch > 1:
        batch_axes, channel_axes = baxes, ("model",)
    else:
        batch_axes, channel_axes = (), names
    dm = int(np.prod([mesh[a] for a in channel_axes]))
    n_shards = d_batch * dm if batch_axes else dm
    if n_shards > 1:
        raise NotImplementedError(
            f"a decode mesh of {dict(mesh)} spreads the KV pages over "
            f"{n_shards} shards; the port decodes on one card (channels "
            f"across cards: ROADMAP Queue 1 item 16)")
    n_pages = max(1, (horizon + pt - 1) // pt)
    return transformer.DecodeCtx(
        page_tokens=pt, n_pages=n_pages, pool_pages=B * n_pages,
        batch_axes=batch_axes, channel_axes=channel_axes,
        pages_per_shard=B * n_pages)


def init_decode_states(params: Model, cfg, B, ctx, kv_dtype=torch.bfloat16):
    """Zeroed paged KV pools, one pair a layer, on the params' device."""
    return transformer.init_decode_states(cfg, B, ctx, kv_dtype,
                                          device=params.embed.device)


def decode_step(params: Model, cfg, states, tokens, pos, block_table, ctx):
    """One token for every sequence.  tokens (B,1) -> logits (B,1,V); the
    states' pools are written in place and returned."""
    x = _embed(params, cfg, tokens)
    x, new_states = transformer.decode_stack(
        params.layers, cfg, x, states, block_table, pos, ctx)
    return logits_fn(params, cfg, x), new_states
