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
``shard_map`` when the decode context is sharded; the port does so when the
context's mesh is a ``ModelMesh`` of ranks (``DecodeCtx.ranked``): each
rank appends to and attends over its slice of every pool
(``paged_kv.append_sharded``, ``decode_attention_sharded``), runs the
dense and mamba layers tensor-parallel (``distributed/tensor_parallel.py``)
with its batch group's rows and its channels of every mamba state, the
xLSTM layers head-parallel with its heads of every (C, n, m) and (c, n, h,
m), and the MoE layers expert-stationary (``moe.apply_stationary``).  On one
device a context of any mesh shape decodes through the gather path, which
computes what the channels do.  The encoder-decoder family has stacks of
its own (``models/encdec.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import paged_kv
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch.mesh import ModelMesh
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
    """Paged-decode context: page pool geometry and channel topology.

    batch_axes: mesh axes the decode batch is sharded over (sequences are
    grouped per shard); channel_axes: mesh axes pages are spread over (the
    paper's memory channels).  Empty batch_axes (long-context B=1) makes
    every mesh axis a channel.  pages_per_shard follows the grouped pool
    layout in ``core/paged_kv.py``.  ``mesh``: the shape or ``ModelMesh``
    it was built for (``models.model.make_decode_ctx``); None, one device's
    gather path."""
    page_tokens: int
    n_pages: int          # block-table width (logical pages per sequence)
    pool_pages: int       # physical pool size (global)
    batch_axes: tuple = ()
    channel_axes: tuple = ()
    pages_per_shard: int = 0
    mesh: Optional[object] = None

    @property
    def sharded(self) -> bool:
        return self.mesh is not None and bool(self.channel_axes)

    @property
    def ranked(self) -> bool:
        """Decodes over the ranks of a ``ModelMesh``: each rank its batch
        group's rows and its slice of every pool."""
        return isinstance(self.mesh, ModelMesh)

    def local_batch(self, B: int) -> slice:
        """The rows of a batch of ``B`` that this rank decodes."""
        if not self.ranked or not self.batch_axes:
            return slice(0, B)
        n = B // self.mesh.size(self.batch_axes)
        g = self.mesh.index(self.batch_axes)
        return slice(g * n, (g + 1) * n)


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

def _attn_sub(pa, cfg, h, positions, causal, ctx):
    """The attention sublayer.  Over ranks (``ctx``, a bound
    ``sharding.ShardCtx``) the rank attends with its heads over the whole
    sequence and ``wo``'s partial products leave in the residual layout."""
    if ctx is not None:
        h = ctx.enter_tp(h)
    q, k, v = attention.qkv(pa, cfg, h, positions)
    if ctx is not None:
        k, v = tp.kv_for_local_heads(cfg, k, v, pa.wq, pa.wk, ctx.mesh)
    o = attention.chunked_attention(q, k, v, cfg, causal=causal)
    sub = attention.out_proj(pa, cfg, o)
    return sub if ctx is None else ctx.leave_tp(sub, pa.wo, 0)


def _apply_layer(p: Layer, cfg, x, positions, *, causal=True, ctx=None):
    """One pre-norm block -> (x, its aux dict: the MoE's, else empty).
    Over ranks (``ctx``) the layer's batch-axis dimensions are gathered in
    one collective (``tp.view``; the MoE gathers its own), the dense
    products run tensor-parallel, and the MoE routes over the mesh
    (``moe.apply_ranked``)."""
    aux = {}
    moe_p = getattr(p, "ffn_moe", None)
    if ctx is not None:
        p = tp.view(p, ctx.mesh, skip=("ffn_moe",))
    h = rms_norm(x, p.norm1.scale, cfg.norm_eps)
    if hasattr(p, "attn"):
        sub = _attn_sub(p.attn, cfg, h, positions, causal, ctx)
    elif hasattr(p, "mamba"):
        sub = mamba.apply(p.mamba, cfg, h, ctx=ctx)
    elif hasattr(p, "mlstm"):
        sub = xlstm.apply_mlstm(p.mlstm, cfg, h, ctx=ctx)
    else:
        sub = xlstm.apply_slstm(p.slstm, cfg, h, ctx=ctx)
    x = x + sub
    if not hasattr(p, "norm2"):
        return x, aux
    h2 = rms_norm(x, p.norm2.scale, cfg.norm_eps)
    if moe_p is not None:
        y, aux = moe.apply(moe_p, cfg, h2) if ctx is None \
            else moe.apply_ranked(moe_p, cfg, h2, ctx)
    elif ctx is None:
        y = mlp.swiglu(p.ffn, h2)
    else:
        y = ctx.leave_tp(mlp.swiglu(p.ffn, ctx.enter_tp(h2)), p.ffn.down, 0)
    return x + y, aux


def _apply_unit(unit, cfg, x, positions, causal, ctx=None):
    """A unit's layers in order -> (x, their aux dicts)."""
    auxes = []
    for p in unit.values():
        x, aux = _apply_layer(p, cfg, x, positions, causal=causal, ctx=ctx)
        auxes.append(aux)
    return x, auxes


def apply_stack(units, cfg, x, positions, *, causal=True, shard_ctx=None):
    """x (B,S,d) -> (x, aux sums): a loop over the units where JAX scans.
    With ``cfg.remat`` and autograd on, each unit is recomputed in the
    backward pass from its input alone, as JAX's ``jax.checkpoint`` of the
    unit body does (over ranks the recompute issues the unit's collectives
    again, in the same order on every rank).  A MoE config sums
    ``moe_aux``, ``moe_z`` and ``moe_dropped`` over its MoE layers in layer
    order, from float32 zeros.  With ``shard_ctx`` (a bound
    ``sharding.ShardCtx``) x is the rank's (B_loc, S, d) rows and comes
    back in the context's residual layout."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux_sum = {}
    if cfg.num_experts:
        aux_sum = {k: torch.zeros((), dtype=F32, device=x.device)
                   for k in ("moe_aux", "moe_z", "moe_dropped")}
    if shard_ctx is not None:
        x = shard_ctx.to_residual(x)
    for unit in units:
        if remat:
            x, auxes = checkpoint(_apply_unit, unit, cfg, x, positions,
                                  causal, shard_ctx, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            x, auxes = _apply_unit(unit, cfg, x, positions, causal,
                                   shard_ctx)
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
    "n", "m"}`` and an sLSTM's ``{"c", "n", "h", "m"}``, float32 zeros.
    On a rank (``ctx.ranked``; ``B`` its rows) a pool is its slice,
    ``pages_per_shard`` pages, a mamba state its block of ``d_inner`` and
    an xLSTM state its heads, as ``steps.decode_state_specs`` places
    them."""
    di, heads = cfg.d_inner, cfg.num_heads
    if ctx.ranked:
        di, heads = (sharding.local_shape((n,), sharding.spec_for(
            ctx.mesh, (axis,), (n,)), ctx.mesh)[0]
            for axis, n in (("mlp", di), ("heads", heads)))
    states = {"mlstm": xlstm.init_mlstm_state,
              "slstm": xlstm.init_slstm_state}
    out = []
    for i in range(cfg.num_layers):
        kind = layer_kind(cfg, i)
        if kind == "mamba":
            out.append(mamba.init_state(cfg, B, device=device, di=di))
            continue
        if kind in states:
            out.append(states[kind](cfg, B, device=device, heads=heads))
            continue
        k_pool, v_pool = paged_kv.init_pool(
            ctx.pages_per_shard if ctx.ranked else ctx.pool_pages,
            ctx.page_tokens, cfg.num_kv_heads, cfg.head_dim, kv_dtype,
            device)
        out.append({"k_pool": k_pool, "v_pool": v_pool})
    return out


def _paged_attn_sub(p_attn, cfg, h, state, block_table, pos, ctx):
    """Single-token attention sublayer against the paged cache; the pools
    are written in place.  On a rank (JAX's ``shard_map`` branch): ``q``,
    ``k_new`` and ``v_new`` come out with the rank's heads and are
    gathered whole by head, enter the channel body whole for the local
    batch, and ``o`` is cut to the rank's heads for the row-parallel
    ``wo``.  ``ctx`` None is one device's."""
    ranked = ctx is not None and ctx.ranked
    positions = pos[:, None]                                    # (B,1)
    q, k_new, v_new = attention.qkv(p_attn, cfg, h, positions)
    if ranked:
        q, k_new, v_new = tp.gather_heads(
            ctx.mesh, [(q, p_attn.wq), (k_new, p_attn.wk),
                       (v_new, p_attn.wv)])
    kd = state["k_pool"].dtype
    k_new, v_new = k_new.to(kd), v_new.to(kd)
    if not ranked:
        k_pool, v_pool = paged_kv.append(
            state["k_pool"], state["v_pool"], block_table, pos, k_new, v_new)
        o = paged_kv.paged_decode_attention(
            q, k_pool, v_pool, block_table, pos, cfg)
        return attention.out_proj(p_attn, cfg, o), \
            {"k_pool": k_pool, "v_pool": v_pool}
    mesh, ba, ca = ctx.mesh, ctx.batch_axes, ctx.channel_axes
    pps = ctx.pages_per_shard
    k_pool, v_pool = paged_kv.append_sharded(
        state["k_pool"], state["v_pool"], block_table, pos, k_new, v_new,
        mesh, ba, ca, pps)
    o = paged_kv.decode_attention_sharded(
        q, k_pool, v_pool, block_table, pos, cfg, mesh, ba, ca, pps)
    o = tp.narrow_to(o, 2, p_attn.wo, 0, mesh)
    sub = tp.reduce_partial(attention.out_proj(p_attn, cfg, o), p_attn.wo,
                            0, mesh)
    return sub, {"k_pool": k_pool, "v_pool": v_pool}


def _swiglu(p, x, ctx):
    """The SwiGLU, on a rank with ``gate``/``up`` column-parallel and
    ``down`` row-parallel."""
    y = mlp.swiglu(p, x)
    return tp.reduce_partial(y, p.down, 0, ctx.mesh) if ctx.ranked else y


def _apply_layer_decode(p: Layer, cfg, x, state, block_table, pos, ctx):
    """One layer of a decode step.  On a rank the layer's FSDP dimensions
    are gathered whole but the experts', which stay where they lie
    (``moe.apply_stationary``); attention, mamba and the SwiGLU run
    tensor-parallel."""
    moe_p = getattr(p, "ffn_moe", None)
    mesh = ctx.mesh if ctx.ranked else None
    if mesh is not None:
        p = tp.view(p, mesh, skip=("ffn_moe",))
    h = rms_norm(x, p.norm1.scale, cfg.norm_eps)
    if hasattr(p, "attn"):
        sub, state = _paged_attn_sub(p.attn, cfg, h, state, block_table,
                                     pos, ctx)
    elif hasattr(p, "mamba"):
        sub, state = mamba.decode_step(p.mamba, cfg, state, h, mesh)
    elif hasattr(p, "mlstm"):
        sub, state = xlstm.decode_mlstm(p.mlstm, cfg, state, h, mesh)
    else:
        sub, state = xlstm.decode_slstm(p.slstm, cfg, state, h, mesh)
    x = x + sub
    if not hasattr(p, "norm2"):
        return x, state
    h2 = rms_norm(x, p.norm2.scale, cfg.norm_eps)
    if moe_p is not None:
        # the B rows route together, idle slots included, at the capacity
        # of B tokens, as in JAX
        y, _ = moe.apply(moe_p, cfg, h2) if mesh is None else \
            moe.apply_stationary(moe_p, cfg, h2, mesh, ctx.batch_axes)
    else:
        y = _swiglu(p.ffn, h2, ctx)
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
