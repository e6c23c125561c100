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
tensors by JAX leaf (``models.model.jax_leaves``) and takes the same scale;
over the ranks of a ``ModelMesh`` the largest magnitude is the whole
leaf's, a MAX over the mesh of every rank's blocks.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import ParamDict, _jax_path, named_tensors
from repro_torch.optim.adamw import scalar


def compress_tree(grads, mode: str, mesh=None) -> ParamDict:
    if mode == "bf16":
        return ParamDict({n: g.to(torch.bfloat16).to(g.dtype)
                          for n, g in named_tensors(grads).items()})
    if mode == "int8":
        return _int8_roundtrip(grads, mesh)
    raise ValueError(mode)


def _int8_roundtrip(grads, mesh=None) -> ParamDict:
    """Quantize each JAX leaf to int8 with one scale, max |g| / 127 over the
    leaf (all its layers, and over ``mesh`` every rank's blocks: one MAX
    all-reduce of every leaf's largest), and back."""
    named = named_tensors(grads)
    leaves: dict = {}
    for n in named:
        leaves.setdefault(_jax_path(n)[0], []).append(n)
    amaxes = torch.stack([torch.stack([named[n].abs().max()
                                       for n in names]).max()
                          for names in leaves.values()])
    if mesh is not None:
        amaxes = mesh.all_reduce(amaxes, mesh.axis_names, op="max")
    out = ParamDict()
    for amax, names in zip(amaxes, leaves.values()):
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
