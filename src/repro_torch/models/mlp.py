"""Feed-forward blocks of the port (the JAX package's ``models/mlp.py``):
SwiGLU for the llama family and the GELU MLP of whisper.  ``jax.nn.gelu``
is the tanh form by default, so the port's GELU is ``F.gelu(...,
approximate="tanh")`` (the exact form differs by up to 4.7e-4)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import F32, dense_init_, param, project


class SwiGLU(nn.Module):
    """``{"gate": (d, ff), "up": (d, ff), "down": (ff, d)}``."""

    AXES = {"gate": ("embed", "mlp"), "up": ("embed", "mlp"),
            "down": ("mlp", "embed")}

    def __init__(self, d: int, ff: int, device=None, dtype=F32):
        super().__init__()
        self.gate = param((d, ff), device, dtype)
        self.up = param((d, ff), device, dtype)
        self.down = param((ff, d), device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(self, x)


def init_swiglu(d: int, ff: int, generator: torch.Generator, device=None,
                dtype=F32) -> SwiGLU:
    m = SwiGLU(d, ff, device, dtype)
    dense_init_(m.gate, d, generator)
    dense_init_(m.up, d, generator)
    dense_init_(m.down, ff, generator)
    return m


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = project(x, p.gate)
    u = project(x, p.up)
    h = F.silu(g.to(F32)).to(dt) * u
    return project(h, p.down)


class GeluMLP(nn.Module):
    """``{"up": (d, ff), "down": (ff, d)}``."""

    AXES = {"up": ("embed", "mlp"), "down": ("mlp", "embed")}

    def __init__(self, d: int, ff: int, device=None, dtype=F32):
        super().__init__()
        self.up = param((d, ff), device, dtype)
        self.down = param((ff, d), device, dtype)


def init_gelu_mlp(d: int, ff: int, generator: torch.Generator, device=None,
                  dtype=F32) -> GeluMLP:
    m = GeluMLP(d, ff, device, dtype)
    dense_init_(m.up, d, generator)
    dense_init_(m.down, ff, generator)
    return m


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp(p: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = project(x, p.up)
    h = gelu(h.to(F32)).to(dt)
    return project(h, p.down)
