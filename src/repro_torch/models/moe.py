"""Mixture-of-Experts FFN of the port (the JAX package's ``models/moe.py``),
with sort-based capacity dispatch.

Routed (token, expert) pairs are sorted by expert, positioned within their
expert group, capacity-clipped and scattered into an (E, C, d) buffer; no
(T, E, C) one-hot tensor is made.  An expert buffer of capacity C is a
HashMem bucket with bounded slots: the pairs past C drop, as an over-full
bucket's entries overflow, and the load-balance loss evens the load as the
paper's hash function does.  ``router_mode="hash"`` routes with the paper's
``murmur3_fmix`` and needs no router parameters.

Where JAX's primitives promise an order, the port keeps it: top-k by a
stable descending sort (equal probabilities pick the lower experts, as
``jax.lax.top_k`` does), the expert sort stable, positions from
``searchsorted(side="left")``.  The dispatch buffer has one spare row that
takes the dropped pairs (JAX's ``mode="drop"``).  Nothing is summed with
atomics, so a step on the card is bit for bit repeatable: the tokens fan
out by ``expand`` and a permutation (whose backward sums over k in a fixed
order), and the combine undoes the sort with a permutation and adds each
token's k contributions in ascending expert order, JAX's CPU scatter-add
order, one rounding an addition.

Over the ranks of a ``ModelMesh`` in training (``apply_ranked``) the layer
is JAX's ``apply`` under GSPMD (``moe_impl="gspmd"``: every rank gathers
the layer's tokens and weights, runs the one-card dispatch and keeps its
rows) or JAX's expert-parallel ``apply_ep`` (``moe_impl="ep"``: each rank
routes its own tokens at a capacity of its own, one all-to-all takes them
to the experts' owners and one brings them back).  Decode over ranks, and
a ``"gspmd"`` forward without autograd, is expert-stationary
(``apply_stationary``): the tokens come to the experts and no expert weight
moves.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.hashing import murmur3_fmix
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import BATCH_AXES, entry_axes
from repro_torch.models import mlp
from repro_torch.models.layers import F32, dense_init_, param


class MoE(nn.Module):
    """``{"router": (d, E), "gate", "up": (E, d, ff), "down": (E, ff, d)}``
    and, with shared experts, ``shared``: a SwiGLU of width ff x their
    number."""

    AXES = {"router": ("embed", "expert"),
            "gate": ("expert", "embed", "mlp"),
            "up": ("expert", "embed", "mlp"),
            "down": ("expert", "mlp", "embed")}

    def __init__(self, cfg, device=None, dtype=F32):
        super().__init__()
        d, E, ff = cfg.d_model, cfg.num_experts, cfg.d_ff
        self.router = param((d, E), device, dtype)
        self.gate = param((E, d, ff), device, dtype)
        self.up = param((E, d, ff), device, dtype)
        self.down = param((E, ff, d), device, dtype)
        self.shared = mlp.SwiGLU(d, ff * cfg.num_shared_experts, device,
                                 dtype) if cfg.num_shared_experts else None


def init(cfg, generator: torch.Generator, device=None, dtype=F32) -> MoE:
    """Each weight drawn with its fan-in, as JAX's ``init``."""
    p = MoE(cfg, device, dtype)
    d, ff = cfg.d_model, cfg.d_ff
    dense_init_(p.router, d, generator)
    dense_init_(p.gate, d, generator)
    dense_init_(p.up, d, generator)
    dense_init_(p.down, ff, generator)
    if p.shared is not None:
        dense_init_(p.shared.gate, d, generator)
        dense_init_(p.shared.up, d, generator)
        dense_init_(p.shared.down, ff * cfg.num_shared_experts, generator)
    return p


def _capacity(cfg, T: int) -> int:
    return max(int(T * cfg.top_k / cfg.num_experts * cfg.capacity_factor),
               cfg.top_k)


def route(p: MoE, cfg, xf, router_mode: str = "learned"):
    """xf (T, d) -> (logits (T, E) float32, probs, gates (T, k) float32,
    idx (T, k) int64): the expert of each of a token's k slots and its
    gate."""
    T = xf.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    logits = xf.to(F32) @ p.router.to(F32)
    probs = torch.softmax(logits, dim=-1)
    if router_mode == "hash":
        keys = torch.arange(T, dtype=torch.int64, device=xf.device)
        first = murmur3_fmix(keys) % E
        idx = torch.stack([(first + j) % E for j in range(k)], dim=1)
        gates = torch.full((T, k), 1.0 / k, dtype=F32, device=xf.device)
    else:
        idx = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[:, :k]
        gates = torch.gather(probs, 1, idx)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gates, idx


def dispatch(cfg, idx, C: int):
    """The sort-based dispatch of JAX's ``apply``.  idx (T, k) -> (order
    (T k,): the routed pairs sorted by expert, stably; dst (T k,): each
    sorted pair's buffer row, ``E * C`` (the spare row) for a dropped one;
    keep (T k,) bool)."""
    E = cfg.num_experts
    e_flat = idx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_s = e_flat[order]
    start = torch.searchsorted(e_s, e_s, side="left")
    pos = torch.arange(e_s.numel(), device=idx.device) - start
    keep = pos < C
    dst = torch.where(keep, e_s * C + pos, E * C)
    return order, dst, keep


def experts(p: MoE, buf):
    """SwiGLU of every expert on its rows.  buf (E, C, d)."""
    dt = buf.dtype
    g = torch.bmm(buf, p.gate.to(dt))
    u = torch.bmm(buf, p.up.to(dt))
    h = torch.nn.functional.silu(g.to(F32)).to(dt) * u
    return torch.bmm(h, p.down.to(dt))


def combine(contrib, order, T: int, k: int):
    """Each token's k rows of ``contrib`` (T k, d), in ``dispatch``'s
    sorted order, summed -> (T, d): the sort undone by its inverse
    permutation, a token's rows added from zeros in ascending expert order,
    one rounding an addition.  That is the order of JAX's CPU
    ``zeros.at[t_s].add(contrib)``, bit for bit, with no atomics."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=order.device)
    per_token = contrib[inv.view(T, k).sort(dim=1).values]      # (T, k, d)
    y = contrib.new_zeros((T, contrib.shape[1]))
    for j in range(k):
        y = y + per_token[:, j]
    return y


def _aux_terms(cfg, logits, probs, idx):
    """The statistics of the Switch/GShard load-balance and z losses over
    the routed tokens: (each expert's mean probability (E,), each expert's
    share of the routed pairs (E,), the mean squared log-sum-exp).  The
    share adds one constant a routed pair, so any order of the additions
    gives the same float32 sums."""
    T, k = idx.shape
    ce = torch.zeros(cfg.num_experts, dtype=F32, device=idx.device)
    ce = ce.index_add_(0, idx.reshape(-1), torch.full(
        (T * k,), 1.0 / (T * k), dtype=F32, device=idx.device))
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return probs.mean(0), ce, z


def _dispatch_rows(xf, order, dst, E: int, C: int):
    """The (E C + 1, d) dispatch buffer: each routed pair's token row (xf
    (T, d), k pairs a token, in ``dispatch``'s order) at its row ``dst``,
    the last row taking the dropped pairs."""
    T, d = xf.shape
    k = order.numel() // T
    xs = xf[:, None].expand(T, k, d).reshape(T * k, d)[order]
    return xf.new_zeros((E * C + 1, d)).index_put((dst,), xs)


def apply(p: MoE, cfg, x, *, router_mode: str = "learned"):
    """x (B, S, d) -> (y (B, S, d), {"moe_aux", "moe_z", "moe_dropped"}):
    the load-balance and router z losses (with their coefficients) and the
    share of routed pairs past capacity."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = B * S
    dev = x.device
    xf = x.reshape(T, d)
    logits, probs, gates, idx = route(p, cfg, xf, router_mode)

    me, ce, z = _aux_terms(cfg, logits, probs, idx)
    aux_loss = cfg.aux_loss_coef * E * torch.sum(me * ce)
    z_loss = cfg.router_z_coef * z

    # sort-based dispatch into E buffers of C rows and one spare row
    C = _capacity(cfg, T)
    order, dst, keep = dispatch(cfg, idx, C)
    w_s = gates.reshape(-1)[order]
    buf = _dispatch_rows(xf, order, dst, E, C)
    out = experts(p, buf[:E * C].view(E, C, d)).reshape(E * C, d)
    out = torch.cat([out, out.new_zeros((1, d))])

    contrib = out[dst] * (w_s * keep).to(x.dtype)[:, None]       # (T k, d)
    y = combine(contrib, order, T, k)

    if getattr(p, "shared", None) is not None:
        y = y + mlp.swiglu(p.shared, xf[None]).reshape(T, d)

    frac_dropped = 1.0 - keep.sum().to(F32) / torch.full(
        (), T * k, dtype=F32, device=dev)
    return y.reshape(B, S, d), {"moe_aux": aux_loss, "moe_z": z_loss,
                                "moe_dropped": frac_dropped}


# ---------------------------------------------------------------------------
# Over the ranks of a ModelMesh (training)
# ---------------------------------------------------------------------------

def apply_ranked(p: MoE, cfg, x, ctx):
    """The layer over ranks, x in ``ctx``'s residual layout (a bound
    ``sharding.ShardCtx``): ``apply_ep`` where ``cfg.moe_impl`` is "ep",
    as JAX's training forward picks it, else the global dispatch: with
    autograd on ``apply_gathered``, whose gathers carry the gradient back,
    and without (a forward that is not trained) ``apply_stationary`` over
    the same tokens, which moves no expert weight."""
    if cfg.moe_impl == "ep":
        return apply_ep(p, cfg, x, ctx)
    if torch.is_grad_enabled():
        return apply_gathered(p, cfg, x, ctx)
    y, aux = apply_stationary(p, cfg, ctx.gather_seq(x), ctx.mesh,
                              ctx.batch_axes)
    return ctx.to_residual(y), aux


def apply_gathered(p: MoE, cfg, x, ctx, router_mode: str = "learned"):
    """JAX's ``apply`` over the whole batch, as GSPMD runs it: the layer's
    tokens gathered over the sequence and the batch axes, its weights
    gathered whole, the one-card dispatch (capacity, sort and aux terms
    over every token), and the rank's rows kept.  The gradient goes back
    through the same collectives."""
    mesh = ctx.mesh
    xg = tp.all_gather(ctx.gather_seq(x), mesh, ctx.batch_axes, 0)
    y, aux = apply(tp.view(p, mesh, tp=True), cfg, xg,
                   router_mode=router_mode)
    rows = x.shape[0]
    y = y.narrow(0, mesh.index(ctx.batch_axes) * rows, rows)
    return ctx.to_residual(y), aux


def apply_stationary(p: MoE, cfg, x, mesh, batch_axes: tuple):
    """JAX's ``apply`` over the whole decode batch, as GSPMD runs it in
    decode, with every expert weight left where it lies: x (B_loc, S, d)
    is the rank's rows, which the ranks of its batch group hold alike.

    The B rows are all-gathered over ``batch_axes`` (B x d) and the
    router's FSDP block gathered; every rank runs the one-card ``route``
    and ``dispatch`` over all B rows, idle rows included (the capacity of
    B tokens, the stable sort), so every rank routes alike.  Each runs
    ``experts`` on the capacity rows of the experts its block holds (its
    index along the expert dimension's axes) with its ``ff`` block (its
    ``"model"`` index), combines its partial outputs in float32, adds the
    shared experts' partial tensor-parallel SwiGLU, and ONE float32
    all-reduce over the whole mesh sums the ranks' (B, d); the rank keeps
    its rows.  A block that several ranks hold alike (a dimension the rules
    could not shard) is added by the first of them only.  Returns (y
    (B_loc, S, d) in x's dtype, {"moe_aux", "moe_z", "moe_dropped"} over
    all the tokens, as ``apply``).  No gradient flows through it."""
    rows, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    xg = mesh.all_gather(x, batch_axes, 0)
    T = xg.shape[0] * S
    dev = x.device
    xf = xg.reshape(T, d)
    router = tp._tree(tp.gather_sharded({"router": p.router}, mesh))
    logits, probs, gates, idx = route(router, cfg, xf)
    me, ce, z = _aux_terms(cfg, logits, probs, idx)
    aux_loss = cfg.aux_loss_coef * E * torch.sum(me * ce)
    z_loss = cfg.router_z_coef * z
    C = _capacity(cfg, T)
    order, dst, keep = dispatch(cfg, idx, C)

    # the rank's experts and ff block; a dimension on another axis (the
    # experts' d where the expert dimension could not shard) gathered
    ex = tp.gather_sharded(
        {n: getattr(p, n) for n in ("gate", "up", "down")}, mesh,
        keep=lambda n, dim, axes: dim == 0 or axes == tp.TP_AXES)
    spec = tp.spec_of(ex["gate"])
    E_loc = ex["gate"].shape[0]
    e0 = mesh.index(entry_axes(spec[0]) if spec else ()) * E_loc
    y = torch.zeros((T, d), dtype=F32, device=dev)
    if tp.first_replica(ex["gate"], mesh):
        buf = _dispatch_rows(xf, order, dst, E, C)
        out = experts(tp._tree(ex),
                      buf[e0 * C:(e0 + E_loc) * C].view(E_loc, C, d))
        full = torch.zeros((E * C + 1, d), dtype=F32, device=dev)
        full[e0 * C:(e0 + E_loc) * C] = out.reshape(E_loc * C, d)
        w_s = gates.reshape(-1)[order]
        y = combine(full[dst] * (w_s * keep)[:, None], order, T, k)
    if p.shared is not None:
        sh = tp.view(p.shared, mesh)
        if tp.first_replica(sh.down, mesh):
            y = y + mlp.swiglu(sh, xf[None]).reshape(T, d).to(F32)
    y = mesh.all_reduce(y, mesh.axis_names).to(x.dtype).view(-1, S, d)
    y = y.narrow(0, mesh.index(batch_axes) * rows, rows)
    dropped = 1.0 - keep.sum().to(F32) / torch.full(
        (), T * k, dtype=F32, device=dev)
    return y, {"moe_aux": aux_loss, "moe_z": z_loss, "moe_dropped": dropped}


def ep_axes(cfg, mesh) -> tuple:
    """JAX's expert-parallel group: the largest suffix of the batch axes
    whose size divides the experts (``src/repro/models/moe.py:149-151``)."""
    axes = tuple(a for a in BATCH_AXES if a in mesh.shape)
    while axes and cfg.num_experts % mesh.size(axes):
        axes = axes[1:]
    return axes


def apply_ep(p: MoE, cfg, x, ctx):
    """JAX's ``apply_ep``: each rank routes its own tokens (its rows and,
    where the ``"model"`` size divides the sequence, its sequence block)
    at a capacity of its own, ``C = max(int(T_loc k / E cf), 1)``, into an
    (E C + 1, d) send buffer (the last row takes the drops); one
    all-to-all over the expert-parallel group (``ep_axes``) takes each
    expert's rows to its owner, which runs its E / |EP| experts whole
    along ``ff`` (gathered over ``"model"``), and one brings them back.
    ``moe_aux``, ``moe_z`` and ``moe_dropped`` are means over every rank
    of the mesh; shared experts run tensor-parallel outside, on x."""
    mesh = ctx.mesh
    E, k = cfg.num_experts, cfg.top_k
    d = x.shape[-1]
    baxes = ep_axes(cfg, mesh)
    Dd = mesh.size(baxes)
    E_loc = E // Dd
    if ctx.batch_axes != tuple(a for a in BATCH_AXES if a in mesh.shape):
        raise ValueError(f"expert parallelism routes each batch shard's "
                         f"tokens; a batch of {x.shape[0]} rows a rank is "
                         f"not sharded over the batch axes of {mesh.shape}")
    M = ctx.model_size
    cut = not ctx.seq and M > 1 and x.shape[1] % M == 0
    xl = ctx.seq_block(x) if cut else x

    # the router in float32; the experts in the activation dtype they are
    # cast to anyway, their expert dimension kept where it is the EP
    # group's block
    named = {n: getattr(p, n) for n in ("gate", "up", "down")}
    w = tp.gather_sharded(named, mesh, dtype=x.dtype, keep=lambda n, dim,
                          axes: dim == 0 and axes == baxes)
    for n in named:
        if Dd > 1 and entry_axes(tp.spec_of(named[n])[0]) != baxes:
            w[n] = w[n].narrow(0, mesh.index(baxes) * E_loc, E_loc)
    w.update(tp.gather_sharded({"router": p.router}, mesh))
    w = tp._tree(w)

    B_l, S_l, _ = xl.shape
    T = B_l * S_l
    dev = x.device
    xf = xl.reshape(T, d)
    logits, probs, gates, idx = route(w, cfg, xf)
    me, ce, z = _aux_terms(cfg, logits, probs, idx)

    C = max(int(T * k / E * cfg.capacity_factor), 1)
    order, dst, keep = dispatch(cfg, idx, C)
    w_s = gates.reshape(-1)[order]
    buf = _dispatch_rows(xf, order, dst, E, C)
    send = buf[:E * C].view(Dd, E_loc * C, d)
    recv = tp.all_to_all(send, mesh, baxes)
    eb = recv.view(Dd, E_loc, C, d).transpose(0, 1).reshape(E_loc, Dd * C, d)
    out = experts(w, eb)
    back = out.view(E_loc, Dd, C, d).transpose(0, 1).reshape(
        Dd, E_loc * C, d)
    got = tp.all_to_all(back, mesh, baxes).reshape(E * C, d)
    got = torch.cat([got, got.new_zeros((1, d))])
    contrib = got[dst] * (w_s * keep).to(x.dtype)[:, None]
    y = combine(contrib, order, T, k).reshape(B_l, S_l, d)
    if cut:
        y = tp.all_gather(y, mesh, ("model",), 1)

    kept = keep.sum().to(F32) / torch.full((), T * k, dtype=F32, device=dev)
    stats = tp.all_reduce(torch.cat([me, ce, z[None], kept[None]]), mesh,
                          mesh.axis_names) / torch.full(
        (), mesh.num_shards, dtype=F32, device=dev)
    aux = cfg.aux_loss_coef * E * torch.sum(stats[:E] * stats[E:2 * E])
    zl = cfg.router_z_coef * stats[2 * E]
    dropped = 1.0 - stats[2 * E + 1].detach()

    if p.shared is not None:
        sh = tp.view(p.shared, mesh)
        y = y + ctx.leave_tp(mlp.swiglu(sh, ctx.enter_tp(x)), sh.down, 0)
    return y, {"moe_aux": aux, "moe_z": zl, "moe_dropped": dropped}
