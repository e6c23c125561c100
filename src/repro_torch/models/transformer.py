"""Layer stack of the port (the JAX package's ``models/transformer.py``) for
the dense family: pre-norm attention + SwiGLU blocks.

JAX stacks the layers' parameters and runs them with ``lax.scan``
(``scan_utils.maybe_scan``); the port keeps one ``DenseLayer`` a layer in an
``nn.ModuleList`` and runs a Python loop over it, which computes the same
thing (``scan_utils`` is not ported).  Decode threads per-layer states
(the paged KV pools) through the same loop; attention layers read and write
the HashMem-managed paged cache (``core/paged_kv.py``) through its gather
path.  JAX decodes through ``shard_map`` when the decode context is sharded;
the port runs on one card, where a context has one channel and one batch
group and the sharded path computes what the gather path does.

The other families (moe, hybrid, ssm, encdec, vlm) raise
``NotImplementedError`` naming their ROADMAP item; no family falls through
to a dense block.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import paged_kv
from repro_torch.models import attention, mlp
from repro_torch.models.layers import F32, RMSNorm, rms_norm


def require_dense(cfg):
    """Raise for every family but ``dense``, naming what it waits for."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP Queue 1 item 12)")


@dataclass(frozen=True)
class DecodeCtx:
    """Paged-decode context: page pool geometry and the JAX channel
    topology it was derived from.

    ``batch_axes``/``channel_axes``/``pages_per_shard`` are those JAX's
    ``make_decode_ctx`` gives for the same mesh shape; the port holds one
    channel and one batch group (``models.model.make_decode_ctx``)."""
    page_tokens: int
    n_pages: int          # block-table width (logical pages per sequence)
    pool_pages: int       # physical pool size (global)
    batch_axes: tuple = ()
    channel_axes: tuple = ()
    pages_per_shard: int = 0


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

class DenseLayer(nn.Module):
    """``{"norm1", "attn", "norm2", "ffn"}``: one pre-norm block, drawn from
    ``generator`` (uninitialised without one, for loading)."""

    def __init__(self, cfg, device=None, dtype=F32, generator=None):
        super().__init__()
        ff = cfg.d_ff_dense or cfg.d_ff
        self.norm1 = RMSNorm(cfg.d_model, device)
        if generator is None:
            self.attn = attention.Attention(cfg, device, dtype)
            self.ffn = mlp.SwiGLU(cfg.d_model, ff, device, dtype)
        else:
            self.attn = attention.init(cfg, generator, device, dtype)
            self.ffn = mlp.init_swiglu(cfg.d_model, ff, generator, device,
                                       dtype)
        self.norm2 = RMSNorm(cfg.d_model, device)


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _apply_layer(p: DenseLayer, cfg, x, positions, *, causal=True):
    h = rms_norm(x, p.norm1.scale, cfg.norm_eps)
    q, k, v = attention.qkv(p.attn, cfg, h, positions)
    o = attention.chunked_attention(q, k, v, cfg, causal=causal)
    x = x + attention.out_proj(p.attn, cfg, o)
    h2 = rms_norm(x, p.norm2.scale, cfg.norm_eps)
    return x + mlp.swiglu(p.ffn, h2)


def apply_stack(layers, cfg, x, positions, *, causal=True):
    """x (B,S,d) -> (x, aux sums): a loop over the layers where JAX
    scans.  With ``cfg.remat`` and autograd on, each layer is recomputed in
    the backward pass from its input alone, as JAX's ``jax.checkpoint`` of
    the unit body does.  The dense family has no auxiliary losses."""
    require_dense(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for p in layers:
        if remat:
            x = checkpoint(_apply_layer, p, cfg, x, positions, causal=causal,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _apply_layer(p, cfg, x, positions, causal=causal)
    return x, {}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_states(cfg, B: int, ctx: DecodeCtx, kv_dtype=torch.bfloat16,
                       num_layers=None, device=None):
    """One ``{"k_pool", "v_pool"}`` a layer, each (pool_pages, page_tokens,
    K, hd) zeros (JAX stacks them on a leading layer axis).  ``B`` sizes
    the recurrent states of other families; the pools do not depend on
    it."""
    del B
    require_dense(cfg)
    out = []
    for _ in range(num_layers or cfg.num_layers):
        k_pool, v_pool = paged_kv.init_pool(
            ctx.pool_pages, ctx.page_tokens, cfg.num_kv_heads, cfg.head_dim,
            kv_dtype, device)
        out.append({"k_pool": k_pool, "v_pool": v_pool})
    return out


def _paged_attn_sub(p_attn, cfg, h, state, block_table, pos, ctx):
    """Single-token attention sublayer against the paged cache (the
    unsharded branch of JAX's; the pools are written in place)."""
    del ctx
    positions = pos[:, None]                                    # (B,1)
    q, k_new, v_new = attention.qkv(p_attn, cfg, h, positions)
    kd = state["k_pool"].dtype
    k_new, v_new = k_new.to(kd), v_new.to(kd)
    k_pool, v_pool = paged_kv.append(
        state["k_pool"], state["v_pool"], block_table, pos, k_new, v_new)
    o = paged_kv.paged_decode_attention(
        q, k_pool, v_pool, block_table, pos, cfg)
    sub = attention.out_proj(p_attn, cfg, o)
    return sub, {"k_pool": k_pool, "v_pool": v_pool}


def _apply_layer_decode(p: DenseLayer, cfg, x, state, block_table, pos, ctx):
    h = rms_norm(x, p.norm1.scale, cfg.norm_eps)
    sub, state = _paged_attn_sub(p.attn, cfg, h, state, block_table, pos,
                                 ctx)
    x = x + sub
    h2 = rms_norm(x, p.norm2.scale, cfg.norm_eps)
    return x + mlp.swiglu(p.ffn, h2), state


def decode_stack(layers, cfg, x, states, block_table, pos, ctx):
    """One decode step through all layers.  x (B,1,d)."""
    require_dense(cfg)
    new_states = []
    for p, s in zip(layers, states):
        x, s = _apply_layer_decode(p, cfg, x, s, block_table, pos, ctx)
        new_states.append(s)
    return x, new_states
