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

JAX's expert-parallel dispatch (``_local_route``, ``apply_ep``) needs a mesh
across cards and waits for ROADMAP Queue 1 item 16b.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.hashing import murmur3_fmix
from repro_torch.models import mlp
from repro_torch.models.layers import F32, dense_init_, param


class MoE(nn.Module):
    """``{"router": (d, E), "gate", "up": (E, d, ff), "down": (E, ff, d)}``
    and, with shared experts, ``shared``: a SwiGLU of width ff x their
    number."""

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

    # aux losses (Switch/GShard).  ``ce`` adds one constant a routed pair,
    # so any order of the additions gives the same float32 sums
    me = probs.mean(0)
    ce = torch.zeros(E, dtype=F32, device=dev).index_add_(
        0, idx.reshape(-1), torch.full((T * k,), 1.0 / (T * k), dtype=F32,
                                       device=dev))
    aux_loss = cfg.aux_loss_coef * E * torch.sum(me * ce)
    z_loss = cfg.router_z_coef * torch.mean(
        torch.square(torch.logsumexp(logits, dim=-1)))

    # sort-based dispatch into E buffers of C rows and one spare row
    C = _capacity(cfg, T)
    order, dst, keep = dispatch(cfg, idx, C)
    w_s = gates.reshape(-1)[order]
    xs = xf[:, None].expand(T, k, d).reshape(T * k, d)[order]
    buf = x.new_zeros((E * C + 1, d)).index_put((dst,), xs)
    out = experts(p, buf[:E * C].view(E, C, d)).reshape(E * C, d)
    out = torch.cat([out, out.new_zeros((1, d))])

    contrib = out[dst] * (w_s * keep).to(x.dtype)[:, None]       # (T k, d)
    y = combine(contrib, order, T, k)

    if p.shared is not None:
        y = y + mlp.swiglu(p.shared, xf[None]).reshape(T, d)

    frac_dropped = 1.0 - keep.sum().to(F32) / torch.full(
        (), T * k, dtype=F32, device=dev)
    return y.reshape(B, S, d), {"moe_aux": aux_loss, "moe_z": z_loss,
                                "moe_dropped": frac_dropped}
