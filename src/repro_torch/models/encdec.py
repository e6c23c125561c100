"""Encoder-decoder stacks of the port (the JAX package's
``models/encdec.py``): whisper-tiny.

The audio conv frontend is a stub: the encoder takes precomputed frame
embeddings (B, frames, d_model) plus sinusoidal positions, and attends
without a mask and without rope.  The decoder is a causal transformer with
rope and cross-attention; decode uses the paged KV cache for
self-attention and the dense cross K/V precomputed from the encoder's
output.  Every norm is centred (``LayerNorm``) and the FFN is the GELU MLP.
The layers of a stack are an ``nn.ModuleList``, ``encoder.{l}`` and
``decoder.{l}``, which JAX stacks under ``stacks/encoder`` and
``stacks/decoder`` on a leading layer axis; with ``cfg.remat`` and autograd
on, each layer is recomputed in the backward pass from its inputs, as
JAX's ``jax.checkpoint`` of the layer body does.

Over the ranks of a ``ModelMesh`` (``mesh``; a model from
``model.shard_params``) every layer is tensor-parallel as JAX's rules place
its leaves: each layer's FSDP dimensions gathered in one collective
(``tensor_parallel.view``), the attention leaves' heads (self and cross)
on ``"model"`` where they divide it and replicated where they do not
(whisper-tiny's 6 heads on 4 ranks: every rank then runs every head and
``wo``'s output is whole, not summed), the GELU MLP column-parallel
(``up``) and row-parallel (``down``).  Row-parallel partial products are
summed over ``"model"`` in float32 and rounded once
(``tensor_parallel.reduce_partial``, differentiable).  Training keeps a
rank's (B_loc, S, d) rows through both stacks: JAX's ``encode`` and
``decode_train`` take no sharding context.  In decode a rank holds its
slice of every self-attention pool and its rows and heads of every
layer's cross K/V.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import paged_kv
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import attention, mlp
from repro_torch.models.layers import (F32, LayerNorm, layer_norm, project,
                                       sinusoid_positions)
from repro_torch.models.transformer import _paged_attn_sub


class EncoderLayer(nn.Module):
    """``{"norm1", "attn", "norm2", "ffn"}``, drawn from ``generator``
    (uninitialised without one, for loading)."""

    def __init__(self, cfg, device=None, dtype=F32, generator=None):
        super().__init__()
        d = cfg.d_model
        self.norm1 = LayerNorm(d, device)
        self.attn = _attention(cfg, device, dtype, generator)
        self.norm2 = LayerNorm(d, device)
        self.ffn = mlp.init_gelu_mlp(d, cfg.d_ff, generator, device, dtype) \
            if generator is not None else mlp.GeluMLP(d, cfg.d_ff, device,
                                                      dtype)


class DecoderLayer(EncoderLayer):
    """An encoder layer's leaves plus ``norm_x`` and the cross-attention
    ``cross`` (the attention leaves; its K/V read the encoder's output)."""

    def __init__(self, cfg, device=None, dtype=F32, generator=None):
        super().__init__(cfg, device, dtype, generator)
        self.norm_x = LayerNorm(cfg.d_model, device)
        self.cross = _attention(cfg, device, dtype, generator)


def _attention(cfg, device, dtype, generator):
    return attention.init(cfg, generator, device, dtype) \
        if generator is not None else attention.Attention(cfg, device, dtype)


def init_stacks(cfg, device=None, dtype=F32, generator=None):
    """(encoder, decoder): ``cfg.num_encoder_layers`` encoder layers and
    ``cfg.num_layers`` decoder layers."""
    enc = nn.ModuleList(EncoderLayer(cfg, device, dtype, generator)
                        for _ in range(cfg.num_encoder_layers))
    dec = nn.ModuleList(DecoderLayer(cfg, device, dtype, generator)
                        for _ in range(cfg.num_layers))
    return enc, dec


def _layers(fn, layers, cfg, x, *args):
    """``x = fn(p, cfg, x, *args)`` for each layer in order, a layer
    recomputed in the backward pass with ``cfg.remat`` and autograd on."""
    remat = cfg.remat and torch.is_grad_enabled()
    for p in layers:
        if remat:
            x = checkpoint(fn, p, cfg, x, *args, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = fn(p, cfg, x, *args)
    return x


def _view(p, mesh):
    """A layer's leaves, on a rank (``mesh``) with their FSDP dimensions
    gathered."""
    return p if mesh is None else tp.view(p, mesh)


def _self_attn(pa, cfg, h, positions, causal, mesh):
    """Self-attention over the rank's heads (all of them where they are
    replicated)."""
    q, k, v = attention.qkv(pa, cfg, h, positions)
    if mesh is not None:
        k, v = tp.kv_for_local_heads(cfg, k, v, pa.wq, pa.wk, mesh)
    o = attention.chunked_attention(q, k, v, cfg, causal=causal)
    return tp.reduce_partial(attention.out_proj(pa, cfg, o), pa.wo, 0, mesh)


def _gelu_mlp(p, x, mesh):
    return tp.reduce_partial(mlp.gelu_mlp(p, x), p.down, 0, mesh)


def _encoder_layer(p: EncoderLayer, cfg, x, mesh=None):
    p = _view(p, mesh)
    h = layer_norm(x, p.norm1, cfg.norm_eps)
    x = x + _self_attn(p.attn, cfg, h, None, False, mesh)  # no rope: abs pos
    h2 = layer_norm(x, p.norm2, cfg.norm_eps)
    return x + _gelu_mlp(p.ffn, h2, mesh)


def encode(encoder, cfg, frames, mesh=None):
    """frames (B, S_enc, d) stub embeddings -> encoder output (B, S_enc,
    d); on a rank (``mesh``) its rows, every layer tensor-parallel."""
    _, S, d = frames.shape
    x = frames + sinusoid_positions(S, d, frames.device)[None].to(
        frames.dtype)
    return _layers(_encoder_layer, encoder, cfg, x, mesh)


def _cross_kv_of(p, enc_out, mesh=None):
    """(ek, ev) (B, S_enc, K, hd) of the encoder output through one decoder
    layer's cross ``wk``/``wv`` (its view on a rank: the rank's KV heads
    where they are on ``"model"``)."""
    c = _view(p.cross, mesh)
    return project(enc_out, c.wk), project(enc_out, c.wv)


def cross_kv(decoder, cfg, enc_out, mesh=None):
    """Each decoder layer's cross-attention K/V of the encoder output:
    (ek, ev), each (L, B, S_enc, K, hd); on a rank (``mesh``) its rows and
    KV heads, as ``steps.decode_state_specs`` places them."""
    kv = [_cross_kv_of(p, enc_out, mesh) for p in decoder]
    return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])


def _cross_sub(p: DecoderLayer, cfg, h, ek, ev, mesh=None):
    q = project(h, p.cross.wq)
    if mesh is not None:
        ek, ev = tp.kv_for_local_heads(cfg, ek, ev, p.cross.wq, p.cross.wk,
                                       mesh)
    o = attention.chunked_attention(q, ek, ev, cfg, causal=False,
                                    chunk=min(cfg.attn_chunk, ek.shape[1]))
    return tp.reduce_partial(project(o, p.cross.wo, in_dims=2), p.cross.wo,
                             0, mesh)


def _decoder_layer(p: DecoderLayer, cfg, x, enc_out, positions, mesh=None):
    p = _view(p, mesh)
    h = layer_norm(x, p.norm1, cfg.norm_eps)
    x = x + _self_attn(p.attn, cfg, h, positions, True, mesh)
    hx = layer_norm(x, p.norm_x, cfg.norm_eps)
    ek = project(enc_out, p.cross.wk)
    ev = project(enc_out, p.cross.wv)
    x = x + _cross_sub(p, cfg, hx, ek, ev, mesh)
    h2 = layer_norm(x, p.norm2, cfg.norm_eps)
    return x + _gelu_mlp(p.ffn, h2, mesh)


def decode_train(decoder, cfg, x, enc_out, positions, mesh=None):
    """Teacher-forced decoder forward.  x (B, S_dec, d) token embeddings;
    on a rank (``mesh``) its rows."""
    return _layers(_decoder_layer, decoder, cfg, x, enc_out, positions, mesh)


def init_decode_states(cfg, B: int, ctx, enc_kv, kv_dtype=torch.bfloat16,
                       device=None):
    """One state a decoder layer, in layer order: zeroed paged self-KV
    pools and the layer's static cross K/V, ``{"k_pool", "v_pool", "ek",
    "ev"}``.  ``B`` is the batch ``enc_kv`` was computed for.  On a rank
    (``ctx.ranked``) a pool is its slice, ``pages_per_shard`` pages, and
    ``enc_kv`` its block (``cross_kv`` with the mesh)."""
    ek, ev = enc_kv                                       # (L,B,Se,K,hd)
    pages = ctx.pages_per_shard if ctx.ranked else ctx.pool_pages
    out = []
    for layer in range(cfg.num_layers):
        k_pool, v_pool = paged_kv.init_pool(
            pages, ctx.page_tokens, cfg.num_kv_heads, cfg.head_dim,
            kv_dtype, device)
        out.append({"k_pool": k_pool, "v_pool": v_pool, "ek": ek[layer],
                    "ev": ev[layer]})
    return out


def decode_step_stack(decoder, cfg, x, states, block_table, pos, ctx):
    """One decoder token step.  x (B,1,d); the self-KV pools are written in
    place and the new states returned.  On a rank (``ctx.ranked``) x is its
    rows: self-attention through the channel-parallel pools, the cross
    attention over its heads of ``ek``/``ev``, the rest tensor-parallel."""
    B = x.shape[0]
    mesh = ctx.mesh if ctx.ranked else None
    dense = cfg.replace(sliding_window=0)
    new_states = []
    for p, st in zip(decoder, states):
        p = _view(p, mesh)
        h = layer_norm(x, p.norm1, cfg.norm_eps)
        sub, new_kv = _paged_attn_sub(p.attn, cfg, h, st, block_table, pos,
                                      ctx)
        x = x + sub
        hx = layer_norm(x, p.norm_x, cfg.norm_eps)
        q = project(hx, p.cross.wq)
        ek, ev = st["ek"], st["ev"]
        if mesh is not None:
            ek, ev = tp.kv_for_local_heads(cfg, ek, ev, p.cross.wq,
                                           p.cross.wk, mesh)
        o = attention.decode_attention_dense(
            q, ek, ev,
            torch.full((B,), ek.shape[1], dtype=torch.int32, device=x.device),
            dense)
        x = x + tp.reduce_partial(project(o, p.cross.wo, in_dims=2),
                                  p.cross.wo, 0, mesh)
        h2 = layer_norm(x, p.norm2, cfg.norm_eps)
        x = x + _gelu_mlp(p.ffn, h2, mesh)
        new_states.append({**new_kv, "ek": st["ek"], "ev": st["ev"]})
    return x, new_states
