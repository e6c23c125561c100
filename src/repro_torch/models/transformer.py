"""Layer stack of the port (the JAX package's ``models/transformer.py``):
the dense, moe, hybrid, ssm and vlm families, pre-norm blocks whose mixer
is attention, mamba, an mLSTM or an sLSTM and whose FFN is a SwiGLU, a MoE
or, in an xLSTM block, absent.

Hybrid architectures repeat a fixed unit of layers (jamba: 8 layers, 7
mamba and 1 attention, MoE on the odd ones; llama4: dense/MoE alternation;
xlstm: 1 sLSTM + 7 mLSTM).  JAX stacks the units' parameters and scans
them, unrolling a unit's layers in Python; the port keeps a ``ModuleDict``
of ``j0 .. j{unit-1}`` a unit in an ``nn.ModuleList`` and runs a Python
loop over it, which computes the same thing, and remats a unit where JAX
checkpoints its unit body.  Decode threads per-layer states (the paged KV
pools of an attention layer, the conv and SSM states of a mamba layer, the
(C, n, m) of an mLSTM and the (c, n, h, m) of an sLSTM) through the same
loop; attention layers read and write the HashMem-managed paged cache
(``core/paged_kv.py``) through its gather path.  JAX decodes through
``shard_map`` when the decode context is sharded; the port runs on one
card, where a context has one channel and one batch group and the sharded
path computes what the gather path does.  The encoder-decoder family has
stacks of its own (``models/encdec.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import paged_kv
from repro_torch.models import attention, mamba, mlp, moe, xlstm
from repro_torch.models.layers import F32, RMSNorm, rms_norm

# ---------------------------------------------------------------------------
# Unit structure
# ---------------------------------------------------------------------------

def scan_unit_size(cfg) -> int:
    u = 1
    if cfg.family == "hybrid":
        u = math.lcm(u, cfg.attn_every)
    if cfg.num_experts:
        u = math.lcm(u, cfg.moe_every)
    if cfg.slstm_every:
        u = math.lcm(u, cfg.slstm_every)
    if cfg.d_ff_dense:
        u = math.lcm(u, cfg.moe_every)
    return u


def layer_kind(cfg, i: int) -> str:
    """'attn' | 'mamba' | 'mlstm' | 'slstm' for global layer index i."""
    if cfg.family == "ssm":
        return "slstm" if cfg.is_slstm_layer(i) else "mlstm"
    if cfg.family == "hybrid":
        return "attn" if cfg.is_attn_layer(i) else "mamba"
    return "attn"


def ffn_kind(cfg, i: int) -> Optional[str]:
    """'moe' | 'dense' | None (xlstm blocks have no separate FFN)."""
    if cfg.family == "ssm":
        return None
    return "moe" if cfg.is_moe_layer(i) else "dense"


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

MIXERS = {
    "attn": (attention.init, attention.Attention),
    "mamba": (mamba.init, mamba.Mamba),
    "mlstm": (xlstm.init_mlstm, xlstm.MLSTM),
    "slstm": (xlstm.init_slstm, xlstm.SLSTM),
}


class Layer(nn.Module):
    """Layer ``i``: ``norm1``, its mixer (``attn``, ``mamba``, ``mlstm`` or
    ``slstm``, the attribute named by ``layer_kind``) and, unless it is an
    xLSTM block, ``norm2`` and its FFN (``ffn``, a SwiGLU of width
    ``d_ff_dense or d_ff``, or ``ffn_moe``), drawn from ``generator``
    (uninitialised without one, for loading)."""

    def __init__(self, cfg, i: int, device=None, dtype=F32, generator=None):
        super().__init__()
        kind, fk = layer_kind(cfg, i), ffn_kind(cfg, i)
        self.norm1 = RMSNorm(cfg.d_model, device)
        drawn = generator is not None
        init, cls = MIXERS[kind]
        setattr(self, kind, init(cfg, generator, device, dtype) if drawn
                else cls(cfg, device, dtype))
        if fk is None:
            return
        if fk == "moe":
            self.ffn_moe = moe.init(cfg, generator, device=device,
                                    dtype=dtype) \
                if drawn else moe.MoE(cfg, device=device, dtype=dtype)
        else:
            ff = cfg.d_ff_dense or cfg.d_ff
            self.ffn = mlp.init_swiglu(cfg.d_model, ff, generator, device,
                                       dtype) \
                if drawn else mlp.SwiGLU(cfg.d_model, ff, device, dtype)
        self.norm2 = RMSNorm(cfg.d_model, device)


def init_units(cfg, device=None, dtype=F32, generator=None) -> nn.ModuleList:
    """The stack as ``n_units`` ``ModuleDict``s of ``j0 .. j{unit-1}``:
    layer ``u * unit + j`` is ``units[u]["j{j}"]``, the JAX tree's
    ``stacks/j{j}`` at stack index ``u``."""
    unit = scan_unit_size(cfg)
    if cfg.num_layers % unit:
        raise ValueError(f"{cfg.num_layers} layers are not whole units of "
                         f"{unit}")
    return nn.ModuleList(
        nn.ModuleDict({f"j{j}": Layer(cfg, u * unit + j, device, dtype,
                                      generator) for j in range(unit)})
        for u in range(cfg.num_layers // unit))


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _apply_layer(p: Layer, cfg, x, positions, *, causal=True):
    """One pre-norm block -> (x, its aux dict: the MoE's, else empty)."""
    aux = {}
    h = rms_norm(x, p.norm1.scale, cfg.norm_eps)
    if hasattr(p, "attn"):
        q, k, v = attention.qkv(p.attn, cfg, h, positions)
        o = attention.chunked_attention(q, k, v, cfg, causal=causal)
        sub = attention.out_proj(p.attn, cfg, o)
    elif hasattr(p, "mamba"):
        sub = mamba.apply(p.mamba, cfg, h)
    elif hasattr(p, "mlstm"):
        sub = xlstm.apply_mlstm(p.mlstm, cfg, h)
    else:
        sub = xlstm.apply_slstm(p.slstm, cfg, h)
    x = x + sub
    if not hasattr(p, "norm2"):
        return x, aux
    h2 = rms_norm(x, p.norm2.scale, cfg.norm_eps)
    if hasattr(p, "ffn_moe"):
        y, aux = moe.apply(p.ffn_moe, cfg, h2)
    else:
        y = mlp.swiglu(p.ffn, h2)
    return x + y, aux


def _apply_unit(unit, cfg, x, positions, causal):
    """A unit's layers in order -> (x, their aux dicts)."""
    auxes = []
    for p in unit.values():
        x, aux = _apply_layer(p, cfg, x, positions, causal=causal)
        auxes.append(aux)
    return x, auxes


def apply_stack(units, cfg, x, positions, *, causal=True):
    """x (B,S,d) -> (x, aux sums): a loop over the units where JAX scans.
    With ``cfg.remat`` and autograd on, each unit is recomputed in the
    backward pass from its input alone, as JAX's ``jax.checkpoint`` of the
    unit body does.  A MoE config sums ``moe_aux``, ``moe_z`` and
    ``moe_dropped`` over its MoE layers in layer order, from float32
    zeros."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux_sum = {}
    if cfg.num_experts:
        aux_sum = {k: torch.zeros((), dtype=F32, device=x.device)
                   for k in ("moe_aux", "moe_z", "moe_dropped")}
    for unit in units:
        if remat:
            x, auxes = checkpoint(_apply_unit, unit, cfg, x, positions,
                                  causal, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            x, auxes = _apply_unit(unit, cfg, x, positions, causal)
        for aux in auxes:
            for k, v in aux.items():
                aux_sum[k] = aux_sum[k] + v
    return x, aux_sum


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_states(cfg, B: int, ctx: DecodeCtx, kv_dtype=torch.bfloat16,
                       device=None):
    """One state a layer, in layer order (JAX stacks them by unit
    position): an attention layer's ``{"k_pool", "v_pool"}``, each
    (pool_pages, page_tokens, K, hd) zeros; for ``B`` sequences a mamba
    layer's ``{"conv", "ssm"}`` (``mamba.init_state``), an mLSTM's ``{"C",
    "n", "m"}`` and an sLSTM's ``{"c", "n", "h", "m"}``, float32 zeros."""
    states = {"mamba": mamba.init_state, "mlstm": xlstm.init_mlstm_state,
              "slstm": xlstm.init_slstm_state}
    out = []
    for i in range(cfg.num_layers):
        kind = layer_kind(cfg, i)
        if kind in states:
            out.append(states[kind](cfg, B, device=device))
            continue
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


def _apply_layer_decode(p: Layer, cfg, x, state, block_table, pos, ctx):
    h = rms_norm(x, p.norm1.scale, cfg.norm_eps)
    if hasattr(p, "attn"):
        sub, state = _paged_attn_sub(p.attn, cfg, h, state, block_table,
                                     pos, ctx)
    elif hasattr(p, "mamba"):
        sub, state = mamba.decode_step(p.mamba, cfg, state, h)
    elif hasattr(p, "mlstm"):
        sub, state = xlstm.decode_mlstm(p.mlstm, cfg, state, h)
    else:
        sub, state = xlstm.decode_slstm(p.slstm, cfg, state, h)
    x = x + sub
    if not hasattr(p, "norm2"):
        return x, state
    h2 = rms_norm(x, p.norm2.scale, cfg.norm_eps)
    if hasattr(p, "ffn_moe"):
        # the B rows route together, idle slots included, at the capacity
        # of B tokens, as in JAX
        y, _ = moe.apply(p.ffn_moe, cfg, h2)
    else:
        y = mlp.swiglu(p.ffn, h2)
    return x + y, state


def decode_stack(units, cfg, x, states, block_table, pos, ctx):
    """One decode step through all layers.  x (B,1,d); ``states`` one a
    layer, in layer order."""
    new_states = []
    layers = (p for unit in units for p in unit.values())
    for p, s in zip(layers, states):
        x, s = _apply_layer_decode(p, cfg, x, s, block_table, pos, ctx)
        new_states.append(s)
    return x, new_states
