"""xLSTM blocks of the port (the JAX package's ``models/xlstm.py``): the
chunkwise-parallel mLSTM and the sequential sLSTM of xlstm-1.3b.

mLSTM (matrix memory, exponential gating) is trained chunkwise: within a
chunk the output is an attention-like masked product with log-gate decays;
across chunks the (C, n, m) state recurs -- the stabilised chunkwise form
(xLSTM paper App. A).  The stabiliser m is carried so exp() never
overflows.  The port walks the chunks in a Python loop where JAX scans;
with ``cfg.mlstm_scan_groups`` and autograd on, each group of chunks is
recomputed in the backward pass from its carry alone
(``torch.utils.checkpoint``), as JAX's two-level ``jax.checkpoint`` does.
sLSTM (scalar memory, block-diagonal recurrence) is inherently sequential:
a Python loop over time where JAX has ``lax.scan``, one cell step (about
20 launches) a token.

States are stored stabilised, all float32: C_tilde = C*exp(-m), n_tilde =
n*exp(-m).  GELU is the tanh form, ``jax.nn.gelu``'s default.

Over the ranks of a ``ModelMesh`` both cells are head-parallel (``"heads"``
on ``"model"``), as JAX's rules place them; both recurrences are
block-diagonal by head, so a rank runs them on its heads unchanged and no
collective enters the chunk loop or the sLSTM's time loop.  The mLSTM's
``wup`` is column-parallel on its 2d outputs, whose halves are ``xm`` and
the gate ``z``: a rank's block of ``up`` holds only one half's columns, so
``up`` is all-gathered over ``"model"`` before the split (``q``, ``k``,
``v`` and the gates contract all of ``xm``), and the rank keeps ``z``'s
channels of its heads; ``wdown`` is row-parallel.  The sLSTM gathers its
heads' normed ``h`` once after the loop, and its GLU post-MLP runs
column-parallel (``up1``, ``up2``) and row-parallel (``down``).  A cell has
two collectives a call: the gather and the float32 sum of the row-parallel
partial products (``tensor_parallel.reduce_partial``; in training
``ShardCtx.leave_tp``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.layers import F32, dense_init_, norm_init_, param, \
    project
from repro_torch.models.mlp import gelu

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """``{"wup": (d, 2d), "wq", "wk", "wv": (d, H, dh), "wi", "wf": (d, H),
    "gn_scale": (H, dh), "wdown": (d, d)}``."""

    AXES = {"wup": ("embed", "mlp"), "wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "heads", "head_dim"),
            "wv": ("embed", "heads", "head_dim"), "wi": ("embed", "heads"),
            "wf": ("embed", "heads"), "gn_scale": ("heads", "head_dim"),
            "wdown": ("mlp", "embed")}

    def __init__(self, cfg, device=None, dtype=F32):
        super().__init__()
        d, H, dh = cfg.d_model, cfg.num_heads, cfg.head_dim
        if H * dh != d:
            raise ValueError("the xlstm cell operates at model width "
                             f"(H * hd == d), not {H} x {dh} != {d}")
        self.wup = param((d, 2 * d), device, dtype)
        self.wq = param((d, H, dh), device, dtype)
        self.wk = param((d, H, dh), device, dtype)
        self.wv = param((d, H, dh), device, dtype)
        self.wi = param((d, H), device, dtype)
        self.wf = param((d, H), device, dtype)
        self.gn_scale = param((H, dh), device, dtype)
        self.wdown = param((d, d), device, dtype)
        norm_init_(self.gn_scale)


def init_mlstm(cfg, generator: torch.Generator, device=None,
               dtype=F32) -> MLSTM:
    """Every projection drawn with fan-in d, ``gn_scale`` ones, as JAX's
    ``init_mlstm``."""
    p = MLSTM(cfg, device, dtype)
    for w in (p.wup, p.wq, p.wk, p.wv, p.wi, p.wf, p.wdown):
        dense_init_(w, cfg.d_model, generator)
    return p


def _mlstm_proj(p: MLSTM, cfg, x, mesh=None):
    """x (B,S,d) -> q, k, v (B,H,S,dh) in x's dtype (k scaled by dh^-0.5),
    log_i, log_f (B,H,S) float32, and the gate z (B,S,H*dh).  On a rank
    (``mesh``) the heads are its own, ``up``'s columns are gathered whole
    before the split, and z holds its heads' channels."""
    dh = cfg.head_dim
    up = project(x, p.wup)
    if mesh is not None and tp._tp(p.wup, 1, mesh):
        up = tp.all_gather(up, mesh, tp.TP_AXES, up.dim() - 1)
    xm, z = up.chunk(2, dim=-1)                                   # (B,S,d)
    if mesh is not None:
        z = tp.narrow_to(z, -1, p.wq, 1, mesh, unit=dh)
    q = project(xm, p.wq).transpose(1, 2)
    k = project(xm, p.wk).transpose(1, 2) * (dh ** -0.5)
    v = project(xm, p.wv).transpose(1, 2)
    x32 = xm.to(F32)
    log_i = (x32 @ p.wi.to(F32)).transpose(1, 2)
    log_f = F.logsigmoid(x32 @ p.wf.to(F32)).transpose(1, 2)
    return q, k, v, log_i, log_f, z


def _rows_of(out, w, mesh):
    """``out`` (B,S,e), the channels of the heads a rank runs, as the input
    of the row-parallel ``w``: cut to ``w``'s rows where it is whole (the
    heads replicated over ``"model"``, ``w`` not), else as it is."""
    if out.shape[-1] == w.shape[0]:
        return out
    return tp.narrow_to(out, -1, w, 0, mesh)


def _down(out, w, mesh):
    """The down projection of ``out`` (B,S,e); on a rank in decode
    (``mesh``) row-parallel, its partial products summed over ``"model"``
    in float32."""
    return tp.reduce_partial(project(_rows_of(out, w, mesh), w), w, 0, mesh)


def _head_norm(h, scale, eps):
    """h (B,H,S,dh): RMS per head."""
    var = h.square().mean(-1, keepdim=True)
    return h * torch.rsqrt(var + eps) * scale[None, :, None, :]


def _mlstm_chunk(carry, qkvif):
    """One chunk of the stabilised chunkwise mLSTM.

    carry: (C (B,H,dh,dh), n (B,H,dh), m (B,H)) stabilised states.
    qkvif: q, k, v (B,H,L,dh) float32; log_i, log_f (B,H,L)."""
    C, n, m = carry
    q, k, v, log_i, log_f = qkvif
    L = q.shape[2]
    b = torch.cumsum(log_f, dim=-1)                                # (B,H,L)
    total = b[..., -1]                                             # (B,H)

    # intra-chunk log decay D[t,s] = b_t - b_s + i_s, s<=t
    D = b[..., :, None] - b[..., None, :] + log_i[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    D = torch.where(mask, D, NEG_INF)

    a = b + m[..., None]                                           # inter log-scale
    m_t = torch.maximum(D.amax(-1), a)                             # (B,H,L)
    Dexp = torch.where(mask, torch.exp(D - m_t[..., None]), 0.0)
    inter = torch.exp(a - m_t)                                     # (B,H,L)

    qk = q @ k.transpose(-1, -2)
    w = Dexp * qk                                                  # (B,H,L,L)
    h_num = w @ v + inter[..., None] * (q @ C)
    n_dot = w.sum(-1) + inter * (q @ n[..., None])[..., 0]
    h = h_num / torch.maximum(n_dot.abs(), torch.exp(-m_t))[..., None]

    # state update to chunk end
    g = total[..., None] - b + log_i                               # (B,H,L)
    m_new = torch.maximum(total + m, g.amax(-1))
    scale_old = torch.exp(total + m - m_new)                       # (B,H)
    wk = torch.exp(g - m_new[..., None])[..., None] * k            # (B,H,L,dh)
    C_new = scale_old[..., None, None] * C + wk.transpose(-1, -2) @ v
    n_new = scale_old[..., None] * n + wk.sum(-2)
    return (C_new, n_new, m_new), h


def _mlstm_scan(C, n, m, q, k, v, log_i, log_f, L: int):
    """The chunks of L tokens of q, k, v (B,H,S,dh) and the gates (B,H,S)
    in order from the carry (C, n, m) -> (C, n, m, h (B,H,S,dh)).  The
    chunks are one ``split`` (a view each, and one concatenation of their
    gradients in the backward pass, where a slice each would build a
    full-size gradient per chunk)."""
    hs = []
    for chunk in zip(*(t.split(L, dim=2) for t in (q, k, v, log_i, log_f))):
        (C, n, m), h = _mlstm_chunk((C, n, m), chunk)
        hs.append(h)
    return C, n, m, torch.cat(hs, dim=2)


def apply_mlstm(p: MLSTM, cfg, x, *, chunk=None, ctx=None):
    """x (B,S,d) -> (B,S,d), chunks of ``min(chunk or cfg.mlstm_chunk, S)``
    tokens, which must divide S.  Over ranks (``ctx``, a bound
    ``sharding.ShardCtx``; ``p`` the rank's blocks) x enters in the
    residual layout and is gathered whole along the sequence (the chunk
    recurrence needs all of it), the rank runs its heads, and ``wdown``'s
    partial products leave in the residual layout."""
    mesh = None
    if ctx is not None:
        x, mesh = ctx.enter_tp(x), ctx.mesh
    B, S, d = x.shape
    H, dh = p.gn_scale.shape
    L = min(chunk or cfg.mlstm_chunk, S)
    if S % L:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"{L}-token mLSTM chunk")
    nc = S // L
    dt = x.dtype
    q, k, v, log_i, log_f, z = _mlstm_proj(p, cfg, x, mesh)
    q, k, v = q.to(F32), k.to(F32), v.to(F32)
    carry = (torch.zeros((B, H, dh, dh), dtype=F32, device=x.device),
             torch.zeros((B, H, dh), dtype=F32, device=x.device),
             torch.zeros((B, H), dtype=F32, device=x.device))
    G = cfg.mlstm_scan_groups
    if G and nc % G == 0 and nc // G > 1 and not cfg.inner_unroll \
            and torch.is_grad_enabled():
        # two-level sqrt-remat: only the G outer (C, n, m) carries are kept
        # for the backward pass; a group's inner chunk states are recomputed
        span, hs = (nc // G) * L, []
        for group in zip(*(t.split(span, dim=2)
                           for t in (q, k, v, log_i, log_f))):
            *carry, h = checkpoint(_mlstm_scan, *carry, *group, L,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
            hs.append(h)
        h = torch.cat(hs, dim=2)
    else:
        *_, h = _mlstm_scan(*carry, q, k, v, log_i, log_f, L)
    h = _head_norm(h, p.gn_scale, cfg.norm_eps)
    h = h.transpose(1, 2).reshape(B, S, H * dh)
    out = (h * F.silu(z.to(F32))).to(dt)
    if ctx is None:
        return project(out, p.wdown)
    out = _rows_of(out, p.wdown, mesh)
    return ctx.leave_tp(project(out, p.wdown), p.wdown, 0)


def init_mlstm_state(cfg, B: int, device=None, heads=None) -> dict:
    """``{"C": (B,H,dh,dh), "n": (B,H,dh), "m": (B,H)}`` float32 zeros;
    ``heads`` (default all) the heads a rank holds."""
    H, dh = heads or cfg.num_heads, cfg.head_dim
    return {"C": torch.zeros((B, H, dh, dh), dtype=F32, device=device),
            "n": torch.zeros((B, H, dh), dtype=F32, device=device),
            "m": torch.zeros((B, H), dtype=F32, device=device)}


def decode_mlstm(p: MLSTM, cfg, state: dict, x, mesh=None):
    """Single-token exact recurrence.  x (B,1,d) -> (y (B,1,d), state).  On
    a rank (``mesh``) ``p`` holds its blocks (the FSDP dimensions gathered)
    and ``state`` its heads; x and y are whole."""
    B = x.shape[0]
    dt = x.dtype
    q, k, v, log_i, log_f, z = _mlstm_proj(p, cfg, x, mesh)
    q1, k1, v1 = (t.to(F32)[:, :, 0] for t in (q, k, v))        # (B,H,dh)
    li, lf = log_i[..., 0], log_f[..., 0]                         # (B,H)
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    so = torch.exp(lf + m - m_new)
    si = torch.exp(li - m_new)
    C = so[..., None, None] * C + si[..., None, None] * \
        (k1[..., :, None] * v1[..., None, :])
    n = so[..., None] * n + si[..., None] * k1
    num = (q1[..., None, :] @ C)[..., 0, :]
    den = torch.maximum((q1 * n).sum(-1).abs(), torch.exp(-m_new))
    h = (num / den[..., None])[:, :, None]                        # (B,H,1,dh)
    h = _head_norm(h, p.gn_scale, cfg.norm_eps)
    h = h.transpose(1, 2).reshape(B, 1, -1)
    out = h * F.silu(z.to(F32))
    y = _down(out.to(dt), p.wdown, mesh)
    return y, {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_ff(d: int) -> int:
    """The post-MLP width: 4d/3 rounded up to a multiple of 64."""
    return ((4 * d // 3) + 63) // 64 * 64


class SLSTM(nn.Module):
    """``{"wg": (d, 4, H, dh), "rg": (4, H, dh, dh), "bg": (4, H, dh),
    "gn_scale": (H, dh), "up1", "up2": (d, ff), "down": (ff, d)}``; the
    gates in the order i, f, z, o."""

    AXES = {"wg": ("embed", "conv", "heads", "head_dim"),
            "rg": ("conv", "heads", "head_dim", "head_dim"),
            "bg": ("conv", "heads", "head_dim"),
            "gn_scale": ("heads", "head_dim"), "up1": ("embed", "mlp"),
            "up2": ("embed", "mlp"), "down": ("mlp", "embed")}

    def __init__(self, cfg, device=None, dtype=F32):
        super().__init__()
        d, H, dh = cfg.d_model, cfg.num_heads, cfg.head_dim
        ff = slstm_ff(d)
        self.wg = param((d, 4, H, dh), device, dtype)
        self.rg = param((4, H, dh, dh), device, dtype)
        self.bg = param((4, H, dh), device, dtype)
        self.gn_scale = param((H, dh), device, dtype)
        self.up1 = param((d, ff), device, dtype)
        self.up2 = param((d, ff), device, dtype)
        self.down = param((ff, d), device, dtype)
        norm_init_(self.gn_scale)
        with torch.no_grad():
            self.bg.zero_()


def init_slstm(cfg, generator: torch.Generator, device=None,
               dtype=F32) -> SLSTM:
    """``wg``, ``up1``, ``up2`` with fan-in d, ``rg`` with dh, ``down`` with
    ff; ``bg`` zeros and ``gn_scale`` ones, as JAX's ``init_slstm``."""
    p = SLSTM(cfg, device, dtype)
    d = cfg.d_model
    dense_init_(p.wg, d, generator)
    dense_init_(p.rg, cfg.head_dim, generator)
    dense_init_(p.up1, d, generator)
    dense_init_(p.up2, d, generator)
    dense_init_(p.down, slstm_ff(d), generator)
    return p


def _recurrent(p: SLSTM):
    """``rg`` (4,H,dh,dh) as (H, dh, 4 dh): the recurrent einsum of a cell
    step becomes one batched matmul over the heads."""
    G, H, dh, _ = p.rg.shape
    return p.rg.to(F32).permute(1, 2, 0, 3).reshape(H, dh, G * dh)


def _slstm_cell(r, bg, carry, gx):
    """carry: (c, n, h, m) each (B,H,dh); gx (B,4,H,dh) input
    preactivations; r the recurrence from ``_recurrent``."""
    c, n, h, m = carry
    B, H, dh = h.shape
    rec = torch.bmm(h.transpose(0, 1), r).view(H, B, 4, dh) \
        .permute(1, 2, 0, 3)                                      # (B,4,H,dh)
    pre = gx + rec + bg[None]
    i_p, f_p, z_p, o_p = pre.unbind(1)
    log_f = F.logsigmoid(f_p)
    log_i = i_p
    m_new = torch.maximum(log_f + m, log_i)
    keep = torch.exp(log_f + m - m_new)
    take = torch.exp(log_i - m_new)
    c_new = keep * c + take * torch.tanh(z_p)
    n_new = keep * n + take
    h_new = torch.sigmoid(o_p) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


def _slstm_out(p: SLSTM, cfg, h, dt, mesh=None, ctx=None):
    """h (B,S,H,dh) float32 -> RMS per head, then the GLU post-MLP (the
    xLSTM sLSTM block) in ``dt`` -> (B,S,d).  On a rank (``mesh``) h holds
    its heads, gathered whole after the norm (one collective), ``up1`` and
    ``up2`` are column-parallel and ``down`` row-parallel: its partial
    products summed in float32 (decode) or leaving through ``ctx`` in the
    residual layout (training)."""
    B, S = h.shape[:2]
    var = h.square().mean(-1, keepdim=True)
    h = h * torch.rsqrt(var + cfg.norm_eps) * p.gn_scale[None, None]
    if mesh is not None and tp._tp(p.wg, 2, mesh):
        h = tp.all_gather(h, mesh, tp.TP_AXES, 2)
    y = h.reshape(B, S, -1).to(dt)
    u = project(y, p.up1)
    g = project(y, p.up2)
    u = u * gelu(g.to(F32)).to(dt)
    if ctx is not None:
        return ctx.leave_tp(project(u, p.down), p.down, 0)
    return _down(u, p.down, mesh)


def apply_slstm(p: SLSTM, cfg, x, ctx=None):
    """x (B,S,d) -> (B,S,d); a sequential loop over S (inherently
    serial).  Over ranks (``ctx``) x enters in the residual layout and is
    gathered whole along the sequence, the loop runs on the rank's heads
    with no collective inside it, and the output leaves in the residual
    layout."""
    mesh = None
    if ctx is not None:
        x, mesh = ctx.enter_tp(x), ctx.mesh
    B, S, d = x.shape
    H, dh = p.gn_scale.shape
    gx = project(x.to(F32), p.wg)                                 # (B,S,4,H,dh)
    r = _recurrent(p)
    z0 = torch.zeros((B, H, dh), dtype=F32, device=x.device)
    carry = (z0, z0, z0, z0)
    hs = []
    # unbind: one view a step, and one stack of their gradients in the
    # backward pass (indexing gx[:, t] would build a full-size one a step)
    for g in gx.unbind(1):
        carry = _slstm_cell(r, p.bg, carry, g)
        hs.append(carry[2])
    return _slstm_out(p, cfg, torch.stack(hs, dim=1), x.dtype, mesh, ctx)


def init_slstm_state(cfg, B: int, device=None, heads=None) -> dict:
    """``{"c", "n", "h", "m"}``, each (B,H,dh) float32 zeros; ``heads``
    (default all) the heads a rank holds."""
    z = torch.zeros((B, heads or cfg.num_heads, cfg.head_dim), dtype=F32,
                    device=device)
    return {"c": z, "n": z, "h": z, "m": z}


def decode_slstm(p: SLSTM, cfg, state: dict, x, mesh=None):
    """One cell step.  x (B,1,d) -> (y (B,1,d), state); on a rank
    (``mesh``) ``state`` holds its heads."""
    gx = project(x[:, 0].to(F32), p.wg)                           # (B,4,H,dh)
    carry = (state["c"], state["n"], state["h"], state["m"])
    c, n, h, m = _slstm_cell(_recurrent(p), p.bg, carry, gx)
    out = _slstm_out(p, cfg, h[:, None], x.dtype, mesh)
    return out, {"c": c, "n": n, "h": h, "m": m}
