"""Gradient compression for the cross-pod all-reduce (the JAX package's
``distributed/compression.py``).

Modes:
  bf16    — cast gradients to bf16 before the reduce (2x wire bytes saved);
            standard at pod scale.
  int8    — per-leaf symmetric int8 quantization; ``Int8ErrorFeedback``
            carries the quantization residual to the next step (Seide et
            al., 1-bit SGD lineage), so compression error does not
            accumulate.

Gradients are ``ParamDict``s keyed like the model's parameters.  JAX takes
one int8 scale per leaf of its stacked tree, so a layer weight's scale is
the largest magnitude over every layer; the port groups its per-layer
tensors by JAX leaf (``models.model.jax_leaves``) and takes the same scale.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import ParamDict, _jax_path, named_tensors
from repro_torch.optim.adamw import scalar


def compress_tree(grads, mode: str) -> ParamDict:
    if mode == "bf16":
        return ParamDict({n: g.to(torch.bfloat16).to(g.dtype)
                          for n, g in named_tensors(grads).items()})
    if mode == "int8":
        return _int8_roundtrip(grads)
    raise ValueError(mode)


def _int8_roundtrip(grads) -> ParamDict:
    """Quantize each JAX leaf to int8 with one scale, max |g| / 127 over the
    leaf (all its layers), and back."""
    named = named_tensors(grads)
    leaves: dict = {}
    for n in named:
        leaves.setdefault(_jax_path(n)[0], []).append(n)
    out = ParamDict()
    for names in leaves.values():
        amax = torch.stack([named[n].abs().max() for n in names]).max()
        scale = torch.clamp(amax, min=1e-12) / scalar(127.0, amax)
        for n in names:
            g = named[n]
            q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            out[n] = (q.to(g.dtype) * scale).to(g.dtype)
    return ParamDict({n: out[n] for n in named})


class Int8ErrorFeedback:
    """g_t' = Q(g_t + e_{t-1}); e_t = (g_t + e_{t-1}) - g_t'."""

    def init(self, grads) -> ParamDict:
        return ParamDict({n: torch.zeros_like(g)
                          for n, g in named_tensors(grads).items()})

    def apply(self, grads, err):
        corrected = ParamDict({n: g + err[n]
                               for n, g in named_tensors(grads).items()})
        quant = _int8_roundtrip(corrected)
        new_err = ParamDict({n: c - quant[n] for n, c in corrected.items()})
        return quant, new_err
