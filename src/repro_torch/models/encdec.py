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
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import paged_kv
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


def _encoder_layer(p: EncoderLayer, cfg, x):
    h = layer_norm(x, p.norm1, cfg.norm_eps)
    q, k, v = attention.qkv(p.attn, cfg, h, None)     # no rope: abs pos
    o = attention.chunked_attention(q, k, v, cfg, causal=False)
    x = x + attention.out_proj(p.attn, cfg, o)
    h2 = layer_norm(x, p.norm2, cfg.norm_eps)
    return x + mlp.gelu_mlp(p.ffn, h2)


def encode(encoder, cfg, frames):
    """frames (B, S_enc, d) stub embeddings -> encoder output (B, S_enc,
    d)."""
    _, S, d = frames.shape
    x = frames + sinusoid_positions(S, d, frames.device)[None].to(
        frames.dtype)
    return _layers(_encoder_layer, encoder, cfg, x)


def cross_kv(decoder, cfg, enc_out):
    """Each decoder layer's cross-attention K/V of the encoder output:
    (ek, ev), each (L, B, S_enc, K, hd)."""
    ek = torch.stack([project(enc_out, p.cross.wk) for p in decoder])
    ev = torch.stack([project(enc_out, p.cross.wv) for p in decoder])
    return ek, ev


def _cross_sub(p: DecoderLayer, cfg, h, ek, ev):
    q = project(h, p.cross.wq)
    o = attention.chunked_attention(q, ek, ev, cfg, causal=False,
                                    chunk=min(cfg.attn_chunk, ek.shape[1]))
    return project(o, p.cross.wo, in_dims=2)


def _decoder_layer(p: DecoderLayer, cfg, x, enc_out, positions):
    h = layer_norm(x, p.norm1, cfg.norm_eps)
    q, k, v = attention.qkv(p.attn, cfg, h, positions)
    o = attention.chunked_attention(q, k, v, cfg, causal=True)
    x = x + attention.out_proj(p.attn, cfg, o)
    hx = layer_norm(x, p.norm_x, cfg.norm_eps)
    ek = project(enc_out, p.cross.wk)
    ev = project(enc_out, p.cross.wv)
    x = x + _cross_sub(p, cfg, hx, ek, ev)
    h2 = layer_norm(x, p.norm2, cfg.norm_eps)
    return x + mlp.gelu_mlp(p.ffn, h2)


def decode_train(decoder, cfg, x, enc_out, positions):
    """Teacher-forced decoder forward.  x (B, S_dec, d) token
    embeddings."""
    return _layers(_decoder_layer, decoder, cfg, x, enc_out, positions)


def init_decode_states(cfg, B: int, ctx, enc_kv, kv_dtype=torch.bfloat16,
                       device=None):
    """One state a decoder layer, in layer order: zeroed paged self-KV
    pools and the layer's static cross K/V, ``{"k_pool", "v_pool", "ek",
    "ev"}``.  ``B`` is the batch ``enc_kv`` was computed for."""
    ek, ev = enc_kv                                       # (L,B,Se,K,hd)
    out = []
    for layer in range(cfg.num_layers):
        k_pool, v_pool = paged_kv.init_pool(
            ctx.pool_pages, ctx.page_tokens, cfg.num_kv_heads, cfg.head_dim,
            kv_dtype, device)
        out.append({"k_pool": k_pool, "v_pool": v_pool, "ek": ek[layer],
                    "ev": ev[layer]})
    return out


def decode_step_stack(decoder, cfg, x, states, block_table, pos, ctx):
    """One decoder token step.  x (B,1,d); the self-KV pools are written in
    place and the new states returned."""
    B = x.shape[0]
    dense = cfg.replace(sliding_window=0)
    new_states = []
    for p, st in zip(decoder, states):
        h = layer_norm(x, p.norm1, cfg.norm_eps)
        sub, new_kv = _paged_attn_sub(p.attn, cfg, h, st, block_table, pos,
                                      ctx)
        x = x + sub
        hx = layer_norm(x, p.norm_x, cfg.norm_eps)
        q = project(hx, p.cross.wq)
        S_enc = st["ek"].shape[1]
        o = attention.decode_attention_dense(
            q, st["ek"], st["ev"],
            torch.full((B,), S_enc, dtype=torch.int32, device=x.device),
            dense)
        x = x + project(o, p.cross.wo, in_dims=2)
        h2 = layer_norm(x, p.norm2, cfg.norm_eps)
        x = x + mlp.gelu_mlp(p.ffn, h2)
        new_states.append({**new_kv, "ek": st["ek"], "ev": st["ev"]})
    return x, new_states
