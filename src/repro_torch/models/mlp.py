"""Feed-forward block of the port (the JAX package's ``models/mlp.py``):
SwiGLU for the llama family.  The GELU MLP waits for the encoder-decoder
family (ROADMAP Queue 1 item 12)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import F32, dense_init_, param, project


class SwiGLU(nn.Module):
    """``{"gate": (d, ff), "up": (d, ff), "down": (ff, d)}``."""

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
    h = torch.nn.functional.silu(g.to(F32)).to(dt) * u
    return project(h, p.down)
