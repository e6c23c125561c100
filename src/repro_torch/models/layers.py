"""Shared model layers of the port (the JAX package's ``models/layers.py``):
norms (RMS, and the centred layer norm of the encoder-decoder family), RoPE,
sinusoidal positions, initialisers and the param-tree helpers.

The port's models are ``nn.Module`` trees whose parameters keep the JAX
package's layouts (``wq`` is ``(d, H, hd)``, an embedding ``(vocab, d)``), so
a JAX parameter tree loads by name (``models.model.params_from_numpy``).
The dtype sequence is JAX's: norms and RoPE compute in float32 and return
the input's dtype.  Initialisers draw from an explicit ``torch.Generator``
on the parameter's device, so a full-width model is made on the card and
never crosses from the host.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

F32 = torch.float32


def param(shape, device, dtype=F32) -> nn.Parameter:
    """An uninitialised parameter, which carries a gradient (the training
    stack differentiates the loss).  The decode entry points run under
    ``torch.no_grad()``, so serving builds no autograd graph."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


def dense_init_(p: torch.Tensor, fan_in: int, generator: torch.Generator):
    """JAX's ``dense_init``: standard normal / sqrt(fan_in), in place."""
    scale = 1.0 / np.sqrt(max(fan_in, 1))
    _normal_(p, generator, scale)


def embed_init_(p: torch.Tensor, generator: torch.Generator):
    """JAX's ``embed_init``: standard normal x 0.02, in place."""
    _normal_(p, generator, 0.02)


def norm_init_(p: torch.Tensor):
    """JAX's ``norm_init``: a scale of ones, in place."""
    with torch.no_grad():
        p.fill_(1.0)


def _normal_(p: torch.Tensor, generator: torch.Generator, scale: float):
    """Draw in float32 (as JAX does) and store in the parameter's dtype."""
    with torch.no_grad():
        if p.dtype == F32:
            p.normal_(generator=generator).mul_(scale)
        else:
            p.copy_(torch.empty(p.shape, device=p.device, dtype=F32)
                    .normal_(generator=generator).mul_(scale))


class RMSNorm(nn.Module):
    """The ``{"scale": (d,)}`` norm of the JAX tree."""

    AXES = {"scale": ("embed",)}

    def __init__(self, d: int, device=None, dtype=F32):
        super().__init__()
        self.scale = param((d,), device, dtype)
        norm_init_(self.scale)

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return rms_norm(x, self.scale, eps)


class LayerNorm(RMSNorm):
    """The centred norm of the JAX tree, ``norm_init(d, centered=True)``:
    ``{"scale": (d,) ones, "bias": (d,) zeros}``."""

    AXES = {"scale": ("embed",), "bias": ("embed",)}

    def __init__(self, d: int, device=None, dtype=F32):
        super().__init__(d, device, dtype)
        self.bias = param((d,), device, dtype)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return layer_norm(x, self, eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(F32)
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale).to(dt)


def layer_norm(x: torch.Tensor, p: RMSNorm, eps: float = 1e-5):
    """Centred norm over the last axis in float32, then ``p.scale`` and,
    where the norm has one (a ``LayerNorm``), ``p.bias``; the input's dtype
    out."""
    dt = x.dtype
    x = x.to(F32)
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * p.scale
    if hasattr(p, "bias"):
        y = y + p.bias
    return y.to(dt)


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """QK-norm: RMS over head_dim of (B, S, H, hd)."""
    dt = x.dtype
    x = x.to(F32)
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding, llama 'rotate-half' convention.

    x: (B, S, H, hd) with even hd; positions: (B, S) integers.  The
    frequencies are JAX's numpy float32 ones; the rotation is float32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    freqs = torch.from_numpy(np.asarray(freqs, np.float32)).to(x.device)
    ang = positions[:, :, None].to(F32) * freqs[None, None, :]   # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    dt = x.dtype
    x1f, x2f = x[..., :half].to(F32), x[..., half:].to(F32)
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(dt)


def sinusoid_positions(S: int, d: int, device=None) -> torch.Tensor:
    """(S, d) float32: sin on the even columns, cos on the odd ones, the
    angles in numpy float64 and cast once, as JAX computes them (float32
    angles are off by up to 2.5e-4 at 4096 positions)."""
    pos = np.arange(S)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    out = np.zeros((S, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out).to(device)


def project(x: torch.Tensor, w: torch.Tensor, in_dims: int = 1):
    """``einsum`` of x's last ``in_dims`` axes with w's first ones, w cast to
    x's dtype first, as the JAX einsums do (``"bsd,dhk->bshk"``)."""
    k = int(np.prod(w.shape[:in_dims]))
    out = x.reshape(-1, k) @ w.reshape(k, -1).to(x.dtype)
    return out.view(*x.shape[:x.dim() - in_dims], *w.shape[in_dims:])


# ---------------------------------------------------------------------------
# Param-tree helpers: the JAX tree's "a/b/c" paths <-> nested dicts
# ---------------------------------------------------------------------------

def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dict of arrays -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, path + "/"))
        else:
            out[path] = v
    return out


def unflatten_tree(flat: dict) -> dict:
    """{"a/b/c": array} -> nested dict."""
    out: dict = {}
    for path, v in flat.items():
        *heads, last = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out
