"""GQA attention of the port (the JAX package's ``models/attention.py``):
chunked (flash-style) attention for forward, and the dense-cache decode.

``chunked_attention`` never materialises the full (S, S) score matrix: it
walks the KV chunks carrying (max, sum, acc), the online softmax of
FlashAttention, in a Python loop where JAX scans.  Scores, softmax and the
weighted sum are float32; the projections run in the activation dtype with
the weights cast to it, as JAX does.  Sliding-window (h2o-danube) and causal
masks are applied per chunk.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import (F32, dense_init_, head_rms_norm,
                                       norm_init_, param, project, rope)

NEG_INF = -1e30


class Attention(nn.Module):
    """``{"wq": (d, H, hd), "wk", "wv": (d, K, hd), "wo": (H, hd, d)}`` and,
    with QK-norm, ``q_scale``/``k_scale`` (hd,)."""

    AXES = {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed"),
            "q_scale": ("head_dim",), "k_scale": ("head_dim",)}

    def __init__(self, cfg, device=None, dtype=F32):
        super().__init__()
        d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        self.wq = param((d, H, hd), device, dtype)
        self.wk = param((d, K, hd), device, dtype)
        self.wv = param((d, K, hd), device, dtype)
        self.wo = param((H, hd, d), device, dtype)
        if cfg.qk_norm:
            self.q_scale = param((hd,), device)
            self.k_scale = param((hd,), device)
            norm_init_(self.q_scale)
            norm_init_(self.k_scale)


def init(cfg, generator: torch.Generator, device=None, dtype=F32) -> Attention:
    p = Attention(cfg, device, dtype)
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    dense_init_(p.wq, d, generator)
    dense_init_(p.wk, d, generator)
    dense_init_(p.wv, d, generator)
    dense_init_(p.wo, H * hd, generator)
    return p


def qkv(p: Attention, cfg, x: torch.Tensor, positions):
    """x (B,S,d) -> q (B,S,H,hd), k,v (B,S,K,hd), rope applied."""
    q = project(x, p.wq)
    k = project(x, p.wk)
    v = project(x, p.wv)
    if cfg.qk_norm:
        q = head_rms_norm(q, p.q_scale, cfg.norm_eps)
        k = head_rms_norm(k, p.k_scale, cfg.norm_eps)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(p: Attention, cfg, o: torch.Tensor) -> torch.Tensor:
    return project(o, p.wo, in_dims=2)


def _chunk_attend(q, k, v, qpos, kpos, causal, window):
    """One (q, kv-chunk) tile.  q (B,K,G,Sq,hd) float32; k/v (B,c,K,hd).
    Returns the partials (m, l, acc) of the online softmax."""
    scale = q.shape[-1] ** -0.5
    s = q @ k.to(F32).permute(0, 2, 3, 1)[:, :, None] * scale  # (B,K,G,Sq,c)
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)                                          # (B,K,G,Sq)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = p @ v.to(F32).permute(0, 2, 1, 3)[:, :, None]      # (B,K,G,Sq,hd)
    return m, l, acc


def chunked_attention(q, k, v, cfg, *, causal=True, chunk=None, q_offset=0):
    """Flash-style attention.  q (B,Sq,H,hd), k/v (B,Skv,K,hd).

    Online softmax over KV chunks; GQA by head grouping.  A chunk that does
    not divide Skv becomes their gcd, as in JAX."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    chunk = min(chunk or cfg.attn_chunk, Skv)
    if Skv % chunk:
        chunk = math.gcd(chunk, Skv)
    dev = q.device
    qg = q.reshape(B, Sq, K, G, hd).permute(0, 2, 3, 1, 4).to(F32)
    qpos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros((B, K, G, Sq), dtype=F32, device=dev)
    acc = torch.zeros((B, K, G, Sq, hd), dtype=F32, device=dev)
    for c0 in range(0, Skv, chunk):
        kpos = c0 + torch.arange(chunk, device=dev)
        mc, lc, ac = _chunk_attend(qg, k[:, c0:c0 + chunk],
                                   v[:, c0:c0 + chunk], qpos, kpos, causal,
                                   cfg.sliding_window)
        m_new = torch.maximum(m, mc)
        r_old = torch.exp(m - m_new)
        r_new = torch.exp(mc - m_new)
        l = l * r_old + lc * r_new
        acc = acc * r_old[..., None] + ac * r_new[..., None]
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]        # (B,K,G,Sq,hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def decode_attention_dense(q, k_cache, v_cache, seq_len, cfg):
    """Single-token decode against a dense cache.  q (B,1,H,hd),
    k_cache/v_cache (B,Smax,K,hd), seq_len (B,) valid lengths."""
    B, _, H, hd = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd).to(F32)
    s = qg @ k_cache.to(F32).permute(0, 2, 3, 1) * (hd ** -0.5)  # (B,K,G,T)
    pos = torch.arange(k_cache.shape[1], device=q.device)
    valid = pos[None, :] < seq_len[:, None]
    if cfg.sliding_window:
        valid &= pos[None, :] >= seq_len[:, None] - cfg.sliding_window
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = p @ v_cache.to(F32).permute(0, 2, 1, 3)                  # (B,K,G,hd)
    return o.reshape(B, 1, H, hd).to(q.dtype)
