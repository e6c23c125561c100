"""Top-level model API of the port (the JAX package's ``models/model.py``)
for every family: dense | moe | hybrid (jamba) | ssm (xlstm) | vlm
(internvl: stub patch embeddings prepended) | encdec (whisper: stub frame
embeddings).  Init, forward, logits, decode, and the bridge that carries a
JAX parameter tree across (``params_from_numpy``).

``Model`` is an ``nn.Module`` tree with the JAX tree's names and layouts:
``embed``, ``head`` (absent when the embeddings are tied), ``final_norm``
(centred for encdec) and either ``units``, one ``ModuleDict`` of layers
``j0 .. j{unit-1}`` a unit (``transformer.init_units``), which JAX stacks
under ``stacks/j{j}`` with a leading unit axis, or, for encdec, the layer
lists ``encoder`` and ``decoder`` (``encdec.init_stacks``), stacked under
``stacks/encoder`` and ``stacks/decoder``.  A parameter's name says where
its JAX leaf is (``units.3.j1.ffn_moe.gate`` is ``stacks/j1/ffn_moe/gate``
at index 3, ``decoder.2.cross.wq`` is ``stacks/decoder/cross/wq`` at index
2), so ``jax_leaves`` groups a model's tensors (or a ``ParamDict`` of
tensors keyed like its parameters, the optimizer's moments) by JAX leaf
with no config at hand; the optimizer, gradient compression and the
checkpoint read it.  The loss is JAX's sequence-chunked cross-entropy
(``chunked_cross_entropy``) plus the MoE aux terms (``loss_fn``); like
JAX's, it reads only ``final_norm``'s scale, so whisper's
``final_norm/bias`` gets a zero gradient.  ``input_specs`` gives the
inputs of each shape kind as meta tensors.

Over a ``launch.mesh.ModelMesh`` a rank holds its block of every leaf
(``shard_params``, ``init_params_sharded``: the blocks of
``distributed.sharding.param_specs``, each tensor with its ``.spec``),
decodes every family tensor-parallel (``distributed/tensor_parallel.py``):
a vocab-parallel embedding, the layers (``transformer.decode_stack``, the
experts stationary, the xLSTM cells head-parallel; ``encdec``'s stacks),
vocab-sharded logits; and trains every family: ``loss_fn`` with a
``ShardCtx`` (the layers tensor-parallel, the MoE over the mesh, the
cross-entropy against the vocabulary blocks, ``vocab_cross_entropy``).
``param_axes`` gives each leaf's logical axes, as JAX's init records them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.layout import resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import (F32, LayerNorm, RMSNorm, embed_init_,
                                       flatten_tree, param, rms_norm,
                                       unflatten_tree)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Model(nn.Module):
    """The LM's parameters.  With ``generator`` they are drawn on
    ``device`` as JAX's ``init_params`` draws them (other numbers: another
    generator); without, they are left uninitialised for loading.  ``mesh``
    is the ``ModelMesh`` whose rank's blocks it holds (``shard_params``),
    else None."""

    AXES = {"embed": ("vocab", "embed"), "head": ("vocab", "embed")}

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = None
        pdt = DTYPES[cfg.param_dtype]
        V, d = cfg.padded_vocab, cfg.d_model
        self.embed = param((V, d), device, pdt)
        self.head = None if cfg.tie_embeddings else param((V, d), device, pdt)
        if generator is not None:
            embed_init_(self.embed, generator)
            if self.head is not None:
                embed_init_(self.head, generator)
        if cfg.is_encoder_decoder:
            self.final_norm = LayerNorm(d, device)
            self.encoder, self.decoder = encdec.init_stacks(
                cfg, device, pdt, generator)
        else:
            self.final_norm = RMSNorm(d, device)
            self.units = transformer.init_units(cfg, device, pdt, generator)


def init_params(cfg, seed: int = 0, device=None) -> Model:
    """Random init from ``seed`` with a ``torch.Generator`` on ``device``
    (None: the card), so a full-width model is drawn where it lives."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return Model(cfg, dev, g)


def count_params(cfg, active_only: bool = False) -> int:
    """Parameter count, from shapes alone (a model on the meta device).
    ``active_only`` counts the routed experts' leaves (``ffn_moe`` but not
    its ``shared`` or ``router``) at top_k / E of their size, leaf by JAX
    leaf as JAX's ``count_params`` does."""
    m = Model(cfg, "meta")
    named = dict(m.named_parameters())
    scale = cfg.top_k / cfg.num_experts if cfg.num_experts else 1.0
    total = 0
    for path, (names, _) in jax_leaves(m).items():
        n = sum(named[k].numel() for k in names)
        if active_only and "ffn_moe" in path and "shared" not in path \
                and "router" not in path:
            n = int(n * scale)
        total += n
    return total


def _owner(m: nn.Module, name: str):
    """(the module that holds parameter ``name``, its attribute name)."""
    mod, _, attr = name.rpartition(".")
    return (m.get_submodule(mod) if mod else m), attr


def leaf_axes(m: "Model") -> dict:
    """{parameter name: logical axes} of a ``Model``: each module class
    names its leaves' axes (``AXES``), as JAX's init functions do."""
    return {name: type(owner).AXES[attr]
            for name, (owner, attr) in (
                (n, _owner(m, n)) for n, _ in m.named_parameters())}


def param_axes(cfg) -> dict:
    """{JAX leaf path: logical axes}, ``"layers"`` first for a stacked
    leaf, from a model on the meta device (JAX's ``param_axes``)."""
    m = Model(cfg, "meta")
    axes = leaf_axes(m)
    return {path: (("layers",) if stacked else ()) + tuple(axes[names[0]])
            for path, (names, stacked) in jax_leaves(m).items()}


def param_shapes(cfg) -> dict:
    """{JAX leaf path: shape}, a stacked leaf with its leading unit axis."""
    m = Model(cfg, "meta")
    named = dict(m.named_parameters())
    return {path: ((len(names),) if stacked else ())
            + tuple(named[names[0]].shape)
            for path, (names, stacked) in jax_leaves(m).items()}


# ---------------------------------------------------------------------------
# The JAX parameter tree <-> the module tree
# ---------------------------------------------------------------------------

def _jax_path(name: str):
    """Module parameter name -> (JAX tree path, stack index or None):
    ``units.{u}.j{j}.<leaf>`` is ``stacks/j{j}/<leaf>`` at index u,
    ``encoder.{l}.<leaf>`` is ``stacks/encoder/<leaf>`` at index l (and
    ``decoder`` likewise)."""
    parts = name.split(".")
    if parts[0] == "units":
        return "stacks/" + "/".join(parts[2:]), int(parts[1])
    if parts[0] in ("encoder", "decoder"):
        return f"stacks/{parts[0]}/" + "/".join(parts[2:]), int(parts[1])
    return "/".join(parts), None


class ParamDict(dict):
    """Tensors keyed by a ``Model``'s parameter names (``"embed"``,
    ``"units.3.j0.attn.wq"``): the optimizer's moments and a step's
    gradients.  ``jax_leaves`` groups them as the JAX tree does."""


def named_tensors(tree) -> dict:
    """A ``Model``'s parameters or a ``ParamDict``, by parameter name."""
    return dict(tree.named_parameters()) if isinstance(tree, nn.Module) \
        else dict(tree)


def jax_leaves(tree) -> dict:
    """{JAX tree path ("stacks/j0/attn/wq"): (parameter names, stacked)} in
    the order JAX flattens the tree (dict keys sorted at every level).  A
    layer leaf names one parameter a unit, in unit order, which JAX stacks
    on a leading axis (``stacked``); any other leaf one parameter."""
    groups: dict = {}
    for name in named_tensors(tree):
        path, i = _jax_path(name)
        groups.setdefault(path, ([], i is not None))[0].append((i or 0, name))
    return {path: ([n for _, n in sorted(names)], stacked)
            for path, (names, stacked) in sorted(
                groups.items(), key=lambda kv: kv[0].split("/"))}


def params_from_numpy(cfg, tree: dict, device=None) -> Model:
    """Load a JAX parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``: ``embed``, ``head``,
    ``final_norm/{scale, bias}``, ``stacks/j{j}/{norm1/scale, attn/{wq, wk,
    wv, wo, q_scale, k_scale}, mamba/{...}, mlstm/{...} or slstm/{...},
    norm2/scale, ffn/{gate, up, down} or ffn_moe/{router, gate, up, down,
    shared/...}}`` or ``stacks/{encoder, decoder}/{norm1, attn, norm_x,
    cross, norm2, ffn/{up, down}}``, each layer leaf with the leading stack
    axis) into a ``Model`` on ``device``."""
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
    leaves (copies, never views of the parameters), layer leaves stacked on
    a leading unit axis."""
    named = dict(params.named_parameters())
    flat = {}
    for path, (names, stacked) in jax_leaves(params).items():
        arrs = [named[n].detach().to("cpu", F32, copy=True).numpy()
                for n in names]
        flat[path] = np.stack(arrs) if stacked else arrs[0]
    return unflatten_tree(flat)


# ---------------------------------------------------------------------------
# A rank's block of the parameters
# ---------------------------------------------------------------------------

def _rank_model(cfg, mesh):
    """A ``Model`` on the meta device for ``mesh``'s rank to fill, and
    {parameter name: spec} (a layer leaf's without its ``"layers"``
    entry, which no rule shards)."""
    out = Model(cfg, "meta")
    out.mesh = mesh
    specs = {name: sharding.spec_for(mesh, axes, p.shape)
             for (name, axes), p in zip(leaf_axes(out).items(),
                                        out.parameters())}
    return out, specs


def _keep(out, specs, name, full, device):
    """Parameter ``name`` of ``out``: this rank's block of ``full``, copied
    to ``device``, with its spec."""
    owner, attr = _owner(out, name)
    spec = specs[name]
    block = sharding.local_block(full.detach(), spec, out.mesh)
    p = nn.Parameter(block.to(device, copy=True).contiguous())
    p.spec = spec
    setattr(owner, attr, p)


def _check_filled(out):
    left = [n for n, p in out.named_parameters() if p.is_meta]
    if left:
        raise RuntimeError(f"no block for {left[:4]}")


def shard_params(params: Model, mesh) -> Model:
    """This rank's block of every leaf of a whole ``Model`` (one from
    ``init_params`` or from ``params_from_numpy`` of JAX's tree), as
    ``sharding.param_specs`` places it on ``mesh`` (a
    ``launch.mesh.ModelMesh``), on the mesh's device."""
    out, specs = _rank_model(params.cfg, mesh)
    for name, p in params.named_parameters():
        _keep(out, specs, name, p, mesh.device)
    _check_filled(out)
    return out


def init_params_sharded(cfg, seed: int, mesh, device=None) -> Model:
    """This rank's block of ``init_params(cfg, seed, device)``: the same
    generator on ``device`` (None: the mesh's) draws leaf by leaf in the
    one-card order (the embeddings, then layer by layer), and only the
    rank's block of each is kept, so no rank holds the whole model."""
    dev = resolve_device(device or mesh.device)
    g = torch.Generator(device=dev).manual_seed(seed)
    out, specs = _rank_model(cfg, mesh)
    pdt = DTYPES[cfg.param_dtype]
    V, d = cfg.padded_vocab, cfg.d_model
    for name in ("embed",) if cfg.tie_embeddings else ("embed", "head"):
        full = torch.empty((V, d), device=dev, dtype=pdt)
        embed_init_(full, g)
        _keep(out, specs, name, full, dev)
        del full
    norm = LayerNorm(d, dev) if cfg.is_encoder_decoder else RMSNorm(d, dev)
    for name, p in norm.named_parameters():
        _keep(out, specs, f"final_norm.{name}", p, dev)
    if cfg.is_encoder_decoder:
        for stack, layers in zip(("encoder", "decoder"),
                                 encdec.init_stacks(cfg, dev, pdt, g)):
            for name, p in layers.named_parameters():
                _keep(out, specs, f"{stack}.{name}", p, dev)
    else:
        unit = transformer.scan_unit_size(cfg)
        for i in range(cfg.num_layers):
            layer = transformer.Layer(cfg, i, dev, pdt, g)
            for name, p in layer.named_parameters():
                _keep(out, specs, f"units.{i // unit}.j{i % unit}.{name}", p,
                      dev)
            del layer
    _check_filled(out)
    return out


def rank_model_meta(cfg, mesh) -> Model:
    """A rank's ``Model`` on the meta device: every parameter of its block's
    shape, with its spec (a restore target)."""
    out, specs = _rank_model(cfg, mesh)
    for name, p in list(out.named_parameters()):
        owner, attr = _owner(out, name)
        q = nn.Parameter(torch.empty(
            sharding.local_shape(p.shape, specs[name], mesh), device="meta",
            dtype=p.dtype))
        q.spec = specs[name]
        setattr(owner, attr, q)
    return out


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _embed(params: Model, cfg, tokens):
    """The token rows of the embedding.  ``F.embedding``, whose backward on
    the card sums each row's gradients in a fixed order (an indexed gather's
    backward accumulates them with atomics), so training is bit for bit
    repeatable.  A rank's model looks its tokens up vocab-parallel."""
    if params.mesh is not None:
        table = tp.view(params, params.mesh, recurse=False).embed
        return tp.embed_lookup(table, tokens, params.mesh).to(
            DTYPES[cfg.dtype])
    return F.embedding(tokens.to(torch.int64), params.embed).to(
        DTYPES[cfg.dtype])


def _positions(x):
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device)[None, :].expand(B, S)


def _trunk_inputs(params: Model, cfg, batch):
    """Token / stub-frontend embedding -> (x (B,S,d), positions (B,S)): a
    vlm's patch embeddings, cast to ``cfg.dtype``, come before its
    tokens'."""
    x = _embed(params, cfg, batch["tokens"])
    if cfg.family == "vlm":
        pe = batch["patch_embeds"].to(DTYPES[cfg.dtype])         # (B,P,d)
        x = torch.cat([pe, x], dim=1)
    return x, _positions(x)


def forward(params: Model, cfg, batch, shard_ctx=None):
    """Returns (final hidden (B,S,d), aux dict).  Causal LM trunk; for
    encdec the decoder's hidden states over ``batch["dec_tokens"]`` after
    encoding ``batch["frames"]``, and no aux.  With ``shard_ctx`` (a bound
    ``sharding.ShardCtx``) ``params`` is a rank's model, ``batch`` its rows
    and the hidden states come back in the context's residual layout."""
    if cfg.is_encoder_decoder:
        # JAX's encode and decode_train take no sharding context: over
        # ranks both stacks keep the rank's (B_loc, S, d) rows
        frames = batch["frames"].to(DTYPES[cfg.dtype])
        enc_out = encdec.encode(params.encoder, cfg, frames, params.mesh)
        xd = _embed(params, cfg, batch["dec_tokens"])
        x = encdec.decode_train(params.decoder, cfg, xd, enc_out,
                                _positions(xd), params.mesh)
        return (x if shard_ctx is None else shard_ctx.to_residual(x)), {}
    x, positions = _trunk_inputs(params, cfg, batch)
    return transformer.apply_stack(params.units, cfg, x, positions,
                                   shard_ctx=shard_ctx)


def _head(params: Model, cfg):
    return params.embed if cfg.tie_embeddings else params.head


def logits_fn(params: Model, cfg, x):
    """Full float32 logits over the padded vocabulary; a rank's model gives
    its vocabulary block (``tp.gather_vocab`` joins them)."""
    if params.mesh is not None:
        top = tp.view(params, params.mesh, recurse=False)
        norm = tp.view(params.final_norm, params.mesh)
        head = top.embed if cfg.tie_embeddings else top.head
        h = rms_norm(x, norm.scale, cfg.norm_eps)
        return h.to(F32) @ head.to(F32).T
    h = rms_norm(x, params.final_norm.scale, cfg.norm_eps)
    return h.to(F32) @ _head(params, cfg).to(F32).T


def _ce_chunk(hx, lx, head):
    """One chunk's (loss sum, token count).  hx (B,c,d) float32, lx (B,c)
    labels, -100 = pad."""
    logits = hx @ head.T                                       # (B,c,V)
    lse = torch.logsumexp(logits, dim=-1)
    mask = lx >= 0
    lbl = torch.clamp(lx, min=0).to(torch.int64)
    gold = torch.gather(logits, -1, lbl[..., None])[..., 0]
    loss = torch.where(mask, lse - gold, 0.0)
    return loss.sum(), mask.sum().to(F32)


def chunked_cross_entropy(params: Model, cfg, x, labels, chunk: int = 512):
    """Sequence-chunked CE: never materialises (B,S,V).  labels -100 = pad.
    Chunks of ``chunk`` tokens, each recomputed in the backward pass from
    its hidden states (JAX's ``jax.checkpoint`` of the scan body)."""
    B, S, d = x.shape
    h = rms_norm(x, params.final_norm.scale, cfg.norm_eps).to(F32)
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"{chunk}-token loss chunk")
    head = _head(params, cfg).to(F32)
    remat = torch.is_grad_enabled()
    loss_sum = torch.zeros((), dtype=F32, device=x.device)
    tok_sum = torch.zeros((), dtype=F32, device=x.device)
    for c0 in range(0, S, chunk):
        hx, lx = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if remat:
            ls, ts = checkpoint(_ce_chunk, hx, lx, head, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            ls, ts = _ce_chunk(hx, lx, head)
        loss_sum = loss_sum + ls
        tok_sum = tok_sum + ts
    return loss_sum / torch.clamp(tok_sum, min=1.0)


def vocab_cross_entropy(params: Model, cfg, x, labels, ctx,
                        chunk: int = 512):
    """``chunked_cross_entropy`` over the ranks of ``ctx``'s mesh: x (B_loc,
    S, d), the rank's rows, against the vocabulary block of its head
    (``tp.vocab_ce_chunk``: the log-sum-exp and the gold logit across the
    blocks, the padded rows included); a chunk is recomputed in the
    backward pass.  The sum over the rank's tokens is divided by the count
    of unmasked labels over the whole batch (summed over the batch axes),
    so the parts of the batch groups add up to JAX's loss."""
    mesh = ctx.mesh
    B, S, d = x.shape
    top = tp.view(params, mesh, recurse=False)
    norm = tp.view(params.final_norm, mesh)
    head = top.embed if cfg.tie_embeddings else top.head
    h = rms_norm(x, norm.scale, cfg.norm_eps).to(F32)
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"{chunk}-token loss chunk")
    vocab_tp = tp._tp(head, 0, mesh)
    v0 = mesh.index(tp.TP_AXES) * head.shape[0] if vocab_tp else 0
    head = head.to(F32)
    remat = torch.is_grad_enabled()
    loss_sum = torch.zeros((), dtype=F32, device=x.device)
    tok_sum = torch.zeros((), dtype=F32, device=x.device)
    for c0 in range(0, S, chunk):
        hx, lx = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        args = (hx, lx, head, mesh, v0) if vocab_tp else (hx, lx, head)
        fn = tp.vocab_ce_chunk if vocab_tp else _ce_chunk
        if remat:
            ls, ts = checkpoint(fn, *args, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            ls, ts = fn(*args)
        loss_sum = loss_sum + ls
        tok_sum = tok_sum + ts
    tok_sum = mesh.all_reduce(tok_sum.detach().clone(), ctx.batch_axes)
    return loss_sum / torch.clamp(tok_sum, min=1.0)


def loss_fn(params: Model, cfg, batch, shard_ctx=None):
    """Scalar LM loss (+ the MoE aux terms ``moe_aux`` and ``moe_z``).
    batch['labels'] -100 = ignored.  Returns (loss, {"ce_loss", and a MoE
    config's "moe_aux", "moe_z", "moe_dropped"}).  With ``shard_ctx`` (a
    bound ``sharding.ShardCtx``; ``params`` a rank's model, ``batch`` its
    rows) the loss is JAX's over the whole batch on every rank, and its
    backward starts each rank from its share (``tp.share``)."""
    x, aux = forward(params, cfg, batch, shard_ctx)
    extra = sum(v for k_, v in aux.items() if k_ in ("moe_aux", "moe_z"))
    if shard_ctx is None:
        loss = chunked_cross_entropy(params, cfg, x, batch["labels"])
        return loss + extra, {"ce_loss": loss, **aux}
    ctx, mesh = shard_ctx, shard_ctx.mesh
    part = vocab_cross_entropy(params, cfg, ctx.gather_seq(x),
                               batch["labels"], ctx)
    loss = tp.share(part, mesh, ctx.batch_axes, ctx.copies)
    if aux:
        # the aux terms are the same on every rank
        extra = tp.share(extra, mesh, (), mesh.num_shards)
    return loss + extra, {"ce_loss": loss, **aux}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def make_decode_ctx(cfg, serve_cfg, B, mesh=None):
    """Page-pool geometry and channel topology for a decode batch, as JAX's
    ``make_decode_ctx`` computes them.

    ``mesh`` is None, a shape {axis: size} in mesh order, or a
    ``launch.mesh.ModelMesh`` (the ctx then decodes over its ranks).
    Grouped layout (``core/paged_kv.py``): sequences are grouped by their
    batch shard and a sequence's pages spread over the channel axes; where
    the batch cannot shard (long-context B=1, or one batch group), every
    mesh axis is a channel, and the page halves (down to 16 tokens) while
    the channels outnumber a sequence's pages.  The pages a sequence round
    up to a multiple of the channels, and the pool to the shard count.
    Sliding-window archs bound the live horizon to the window."""
    pt = serve_cfg.kv_page_tokens
    horizon = serve_cfg.shape.seq_len
    if cfg.sliding_window:
        horizon = min(horizon, cfg.sliding_window + pt)
    if mesh is None:
        n_pages = max(1, (horizon + pt - 1) // pt)
        return transformer.DecodeCtx(page_tokens=pt, n_pages=n_pages,
                                     pool_pages=B * n_pages)
    shape = sharding.mesh_shape(mesh)
    names = tuple(shape)
    baxes = tuple(a for a in sharding.BATCH_AXES if a in names)
    d_batch = math.prod(shape[a] for a in baxes)
    if B % d_batch == 0 and d_batch > 1:
        batch_axes, channel_axes = baxes, ("model",)
    else:
        batch_axes, channel_axes = (), names
    dm = math.prod(shape[a] for a in channel_axes)
    # adapt page size so every channel holds >=1 page without overallocation
    while pt > 16 and (horizon + pt - 1) // pt < dm:
        pt //= 2
    n_pages = max(1, (horizon + pt - 1) // pt)
    n_pages = ((n_pages + dm - 1) // dm) * dm
    n_shards = d_batch * dm if batch_axes else dm
    pool = B * n_pages
    pool = ((pool + n_shards - 1) // n_shards) * n_shards
    return transformer.DecodeCtx(
        page_tokens=pt, n_pages=n_pages, pool_pages=pool,
        batch_axes=batch_axes, channel_axes=channel_axes,
        pages_per_shard=pool // n_shards, mesh=mesh)


@torch.no_grad()
def init_decode_states(params: Model, cfg, B, ctx, kv_dtype=torch.bfloat16,
                       enc_frames=None):
    """Decode states, one a layer, on the params' device: an attention
    layer's zeroed paged KV pools; for ``B`` sequences the zeroed
    recurrent states of a mamba, mLSTM or sLSTM layer.  An encdec model
    encodes ``enc_frames`` (B, S_enc, d) and gives each decoder layer its
    pools and its cross K/V (``encdec.init_decode_states``).  On a rank
    (``ctx.ranked``, a model from ``shard_params``) ``B`` and
    ``enc_frames`` are its rows (``ctx.local_batch``), which it encodes
    tensor-parallel, and each state is its block.  Builds no autograd
    graph."""
    dev = params.embed.device
    if cfg.is_encoder_decoder:
        if enc_frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder decode needs "
                             f"enc_frames, the encoder's input")
        enc_out = encdec.encode(params.encoder, cfg,
                                enc_frames.to(dev, DTYPES[cfg.dtype]),
                                params.mesh)
        enc_kv = encdec.cross_kv(params.decoder, cfg, enc_out, params.mesh)
        return encdec.init_decode_states(cfg, B, ctx, enc_kv, kv_dtype,
                                         device=dev)
    return transformer.init_decode_states(cfg, B, ctx, kv_dtype, device=dev)


def decode_step(params: Model, cfg, states, tokens, pos, block_table, ctx):
    """One token for every sequence.  tokens (B,1) -> logits (B,1,V); the
    states' pools are written in place, and the new states (the pools, the
    recurrent layers' new states, encdec's cross K/V) returned.  A vlm
    decodes tokens only, as JAX's does.  On a rank (``ctx.ranked``, a model
    from ``shard_params``) the inputs are its batch group's rows, the
    states its blocks (pool slices, mamba channels, xLSTM heads, cross
    K/V rows and heads), and the logits its vocabulary block."""
    x = _embed(params, cfg, tokens)
    if cfg.is_encoder_decoder:
        x, new_states = encdec.decode_step_stack(
            params.decoder, cfg, x, states, block_table, pos, ctx)
    else:
        x, new_states = transformer.decode_stack(
            params.units, cfg, x, states, block_table, pos, ctx)
    return logits_fn(params, cfg, x), new_states


# ---------------------------------------------------------------------------
# input_specs: meta-tensor stand-ins for every (arch x shape) cell
# ---------------------------------------------------------------------------

def input_specs(cfg, shape_cfg, ctx=None):
    """The inputs of a shape kind as meta tensors (shapes and dtypes, no
    memory): tokens and labels (B, S) int32 for ``train`` and ``prefill``
    (encdec: frames (B, S, d) in ``cfg.dtype``, decoder tokens and labels
    (B, min(512, S)); vlm: P patch embeddings (B, P, d), tokens (B, S - P),
    labels (B, S)); for ``decode`` one token against the KV horizon: tokens
    (B, 1), pos (B,) and the block table (B, ctx.n_pages)."""
    B, S = shape_cfg.global_batch, shape_cfg.seq_len

    def sd(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")
    if shape_cfg.kind in ("train", "prefill"):
        dt = DTYPES[cfg.dtype]
        if cfg.is_encoder_decoder:
            dec_len = min(512, S)
            return {"frames": sd((B, S, cfg.d_model), dt),
                    "dec_tokens": sd((B, dec_len)),
                    "labels": sd((B, dec_len))}
        if cfg.family == "vlm":
            P_ = cfg.num_prefix_embeds
            return {"patch_embeds": sd((B, P_, cfg.d_model), dt),
                    "tokens": sd((B, S - P_)), "labels": sd((B, S))}
        return {"tokens": sd((B, S)), "labels": sd((B, S))}
    if ctx is None:
        raise ValueError("decode input specs need the decode context")
    return {"tokens": sd((B, 1)), "pos": sd((B,)),
            "block_table": sd((B, ctx.n_pages))}
