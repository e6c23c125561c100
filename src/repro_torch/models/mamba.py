"""Mamba (S6) block of the port (the JAX package's ``models/mamba.py``):
jamba's SSM layer, a chunked selective scan for training and prefill and
the exact one-step recurrence for decode.

``apply`` walks the chunks of ``cfg.mamba_chunk`` tokens carrying the
(B, di, N) state, as JAX's ``lax.scan`` does, and scans within a chunk in
log2(L) levels with JAX's own ``lax.associative_scan`` recursion (odd/even
halves, ``combine`` on strided slices), so the rounding order is JAX's and
no launch is made a token.  Softplus is ``logaddexp(x, 0)``, JAX's
``jax.nn.softplus``, which keeps its curve above 20 where PyTorch's
``softplus`` switches to ``x``.

Over the ranks of a ``ModelMesh`` the layer is tensor-parallel on
``d_inner`` (``"mlp"`` on ``"model"``): ``wx``, ``wz`` and ``dt_proj``
column-parallel, the conv, ``dt_bias``, ``A_log`` and ``D`` per channel,
``x_proj`` and ``out_proj`` row-parallel.  The scan and the recurrence are
independent per channel, so a rank runs them on its channels unchanged;
the two reductions over ``"model"`` are ``x_proj``'s product, summed
before the split into ``dt``, ``B`` and ``C`` (every rank then holds the
same ``B`` and ``C``), and ``out_proj``'s output.  Both are added in
float32 and rounded once (``tensor_parallel.reduce_partial``; in training
its all-reduce's backward adds up the parts of the gradient).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.layers import F32, dense_init_, param, project


class Mamba(nn.Module):
    """``{"wx", "wz": (d, di), "conv_w": (cw, di), "conv_b": (di,),
    "x_proj": (di, dt_rank + 2N), "dt_proj": (dt_rank, di), "dt_bias",
    "D": (di,), "A_log": (di, N), "out_proj": (di, d)}``."""

    AXES = {"wx": ("embed", "mlp"), "wz": ("embed", "mlp"),
            "conv_w": ("conv", "mlp"), "conv_b": ("mlp",),
            "x_proj": ("mlp", "dt_rank"), "dt_proj": ("dt_rank", "mlp"),
            "dt_bias": ("mlp",), "A_log": ("mlp", "state"), "D": ("mlp",),
            "out_proj": ("mlp", "embed")}

    def __init__(self, cfg, device=None, dtype=F32):
        super().__init__()
        d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state_dim
        dtr, cw = cfg.dt_rank, cfg.ssm_conv_width
        self.wx = param((d, di), device, dtype)
        self.wz = param((d, di), device, dtype)
        self.conv_w = param((cw, di), device, dtype)
        self.conv_b = param((di,), device, dtype)
        self.x_proj = param((di, dtr + 2 * N), device, dtype)
        self.dt_proj = param((dtr, di), device, dtype)
        self.dt_bias = param((di,), device, dtype)
        self.A_log = param((di, N), device, dtype)
        self.D = param((di,), device, dtype)
        self.out_proj = param((di, d), device, dtype)


def init(cfg, generator: torch.Generator, device=None, dtype=F32) -> Mamba:
    """The projections drawn with their fan-in; ``A_log = log(1..N)`` on
    every channel, ``dt_bias = -4.6`` (softplus^-1(0.01)), ``D = 1`` and
    ``conv_b = 0``, as JAX's ``init``."""
    p = Mamba(cfg, device, dtype)
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state_dim
    dense_init_(p.wx, d, generator)
    dense_init_(p.wz, d, generator)
    dense_init_(p.conv_w, cfg.ssm_conv_width, generator)
    dense_init_(p.x_proj, di, generator)
    dense_init_(p.dt_proj, cfg.dt_rank, generator)
    dense_init_(p.out_proj, di, generator)
    with torch.no_grad():
        # numpy's float32 log, which is XLA's on these values (PyTorch's
        # log(7) is one ulp away)
        a_log = np.log(np.arange(1, N + 1, dtype=np.float32))
        p.A_log.copy_(torch.from_numpy(a_log).to(p.A_log.device)
                      .expand(di, N))
        p.dt_bias.fill_(-4.6)
        p.D.fill_(1.0)
        p.conv_b.zero_()
    return p


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssm_inputs(p: Mamba, cfg, xc, mesh=None):
    """xc (B, L, di), the conv + SiLU output -> the discretised dA, dBx
    (B, L, di, N) float32 and C (B, L, N).  On a rank (``mesh``) xc holds
    its channels and ``x_proj``'s partial products are summed first."""
    N, dtr = cfg.ssm_state_dim, cfg.dt_rank
    proj = tp.reduce_partial(project(xc, p.x_proj), p.x_proj, 0,
                             mesh).to(F32)
    dt_raw, Bs, Cs = torch.split(proj, [dtr, N, N], dim=-1)
    dt = softplus(project(dt_raw, p.dt_proj) + p.dt_bias)
    A = -torch.exp(p.A_log)                                      # (di, N)
    dA = torch.exp(dt[..., None] * A)
    dBx = dt[..., None] * Bs[:, :, None, :] * xc.to(F32)[..., None]
    return dA, dBx, Cs


def _conv(p: Mamba, cfg, x, conv_state=None):
    """Causal depthwise conv1d of width cw.  x (B, S, di) -> (out, the
    last cw - 1 inputs, the next call's state)."""
    cw = cfg.ssm_conv_width
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                              # (B,S+cw-1,di)
    w = p.conv_w.to(x.dtype)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(cw))
    out = out + p.conv_b.to(x.dtype)
    new_state = xp[:, -(cw - 1):] if cw > 1 else pad
    return out, new_state


def _combine(e1, e2):
    """h_t = a_t h_{t-1} + b_t composed: (a1, b1) then (a2, b2)."""
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def _interleave(a, b):
    """a[0], b[0], a[1], b[1], ... along dim 1 (a one longer or as long)."""
    n = b.shape[1]
    out = torch.stack([a[:, :n], b], dim=2).flatten(1, 2)
    return torch.cat([out, a[:, n:]], dim=1) if a.shape[1] > n else out


def associative_scan(a, b):
    """Inclusive scan of ``_combine`` over dim 1: JAX's
    ``lax.associative_scan`` recursion, the same combines on the same
    strided halves."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                     (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    even = (torch.cat([a[:, :1], even[0]], dim=1),
            torch.cat([b[:, :1], even[1]], dim=1))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def apply(p: Mamba, cfg, x, *, chunk=None, ctx=None):
    """Training/prefill forward.  x (B, S, d) -> (B, S, d).  Over ranks
    (``ctx``, a bound ``sharding.ShardCtx``; ``p`` the rank's blocks) x
    enters in the residual layout and is gathered whole along the sequence
    (the chunked scan needs all of it), the rank runs its channels, and
    ``out_proj``'s partial products leave in the residual layout."""
    mesh = None
    if ctx is not None:
        x, mesh = ctx.enter_tp(x), ctx.mesh
    B, S, d = x.shape
    N = cfg.ssm_state_dim
    L = min(chunk or cfg.mamba_chunk, S)
    if S % L:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"{L}-token scan chunk")
    dt = x.dtype

    xi = project(x, p.wx)
    z = project(x, p.wz)
    xc, _ = _conv(p, cfg, xi)
    xc = F.silu(xc.to(F32)).to(dt)

    h = torch.zeros((B, xi.shape[-1], N), dtype=F32, device=x.device)
    ys = []
    for c0 in range(0, S, L):
        dA, dBx, Cs = _ssm_inputs(p, cfg, xc[:, c0:c0 + L], mesh)
        a_cum, s = associative_scan(dA, dBx)
        hs = a_cum * h[:, None] + s                              # (B,L,di,N)
        ys.append((hs @ Cs[..., None])[..., 0])                  # (B,L,di)
        h = hs[:, -1]
    y = torch.cat(ys, dim=1).to(F32)
    y = y + p.D * xc.to(F32)
    y = y * F.silu(z.to(F32))
    out = project(y.to(dt), p.out_proj)
    return out if ctx is None else ctx.leave_tp(out, p.out_proj, 0)


def init_state(cfg, B: int, dtype=F32, device=None, di=None) -> dict:
    """``{"conv": (B, cw - 1, di) dtype, "ssm": (B, di, N) float32}``,
    zeros; ``di`` (default ``d_inner``) the channels a rank holds."""
    di = di or cfg.d_inner
    N, cw = cfg.ssm_state_dim, cfg.ssm_conv_width
    return {"conv": torch.zeros((B, cw - 1, di), dtype=dtype, device=device),
            "ssm": torch.zeros((B, di, N), dtype=F32, device=device)}


def decode_step(p: Mamba, cfg, state: dict, x, mesh=None):
    """x (B, 1, d) -> (y (B, 1, d), new state).  The exact recurrence.  On
    a rank (``mesh``) ``p`` holds its channels' blocks (the FSDP dimensions
    gathered) and ``state`` its channels' block; x and y are whole."""
    dt = x.dtype
    xi = project(x, p.wx)
    z = project(x, p.wz)
    xc, conv_state = _conv(p, cfg, xi, state["conv"])
    xc = F.silu(xc.to(F32)).to(dt)                               # (B,1,di)
    dA, dBx, Cs = _ssm_inputs(p, cfg, xc, mesh)
    h = dA[:, 0] * state["ssm"] + dBx[:, 0]                      # (B,di,N)
    y = (h @ Cs[:, 0, :, None])[..., 0][:, None]                 # (B,1,di)
    y = y + p.D * xc.to(F32)
    y = y * F.silu(z.to(F32))
    out = tp.reduce_partial(project(y.to(dt), p.out_proj), p.out_proj, 0,
                            mesh)
    return out, {"conv": conv_state, "ssm": h}
