"""Configurations of the port, copied from the JAX package's ``configs``.

``HashMemConfig`` and the paper's tables (``PAPER_HASHMEM``,
``SCALED_HASHMEM``, ``PAPER_WORKLOAD``); the model zoo's ``ModelConfig``s
with the ``--arch`` registry (``get_config``, ``smoke_config``) and the
assigned (arch x shape) cells (``cells``); the shape regimes ``SHAPES``,
``OptimConfig``, ``TrainConfig`` and ``ServeConfig``.
The port keeps its own copy so it never imports the JAX package.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (PAPER_WORKLOAD, SHAPES, HashMemConfig,
                                      MeshConfig, ModelConfig, OptimConfig,
                                      ServeConfig, ShapeConfig, TrainConfig)
from repro_torch.configs.hashmem_paper import PAPER_HASHMEM, SCALED_HASHMEM

__all__ = ["ARCHS", "HashMemConfig", "LONG_CONTEXT_ARCHS", "MeshConfig",
           "ModelConfig", "OptimConfig", "PAPER_HASHMEM", "PAPER_WORKLOAD",
           "SCALED_HASHMEM", "SHAPES", "ServeConfig", "ShapeConfig",
           "TrainConfig", "cells", "get_config", "smoke_config"]

_ARCH_MODULES = {
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "internvl2-2b": "internvl2_2b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama3-8b": "llama3_8b",
    "qwen3-8b": "qwen3_8b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "xlstm-1.3b": "xlstm_1_3b",
    "whisper-tiny": "whisper_tiny",
}

ARCHS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


# long_500k requires sub-quadratic attention: hybrid (jamba: 1/8 attention
# + paged KV), SWA (h2o-danube: bounded window), ssm (xlstm: O(1)
# recurrent state).  Pure full-attention archs skip it.
LONG_CONTEXT_ARCHS = ("jamba-v0.1-52b", "h2o-danube-1.8b", "xlstm-1.3b")


def cells():
    """All assigned (arch x shape) cells: 40 assigned, 33 runnable (the 7
    long_500k cells of the pure full-attention archs are skipped)."""
    out = []
    for arch in ARCHS:
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                continue
            out.append((arch, shape))
    return out


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    c = get_config(arch)
    kw = dict(
        num_layers=min(c.num_layers, 4),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(c.num_kv_heads, 4) if c.num_kv_heads < c.num_heads else 4,
        head_dim=32,
        d_ff=0 if c.d_ff == 0 else 256,
        vocab_size=512,
        vocab_pad_to=64,
        attn_chunk=64,
        mamba_chunk=16,
        mlstm_chunk=16,
    )
    if c.num_experts:
        kw.update(num_experts=8, top_k=min(c.top_k, 4))
    if c.d_ff_dense:
        kw.update(d_ff_dense=256)
    if c.is_encoder_decoder:
        kw.update(num_encoder_layers=2, num_layers=2)
    if c.num_prefix_embeds:
        kw.update(num_prefix_embeds=8)
    if c.slstm_every:
        kw.update(slstm_every=2)
    if c.attn_every > 1:
        kw.update(attn_every=4, attn_offset=2)
    if c.sliding_window:
        kw.update(sliding_window=64)
    return c.replace(**kw)
