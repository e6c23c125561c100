"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf ai21labs/Jamba-v0.1]  Assigned config:
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16 experts top-2.
Jamba block structure: in every 8-layer block exactly one attention layer
(position 4), the rest Mamba; MoE replaces the MLP on every other layer.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    rope_theta=10_000.0,     # Jamba attention layers use no explicit RoPE scaling
    ssm_state_dim=16,
    ssm_conv_width=4,
    ssm_expand=2,
    source="arXiv:2403.19887 (Jamba); hf:ai21labs/Jamba-v0.1",
)
