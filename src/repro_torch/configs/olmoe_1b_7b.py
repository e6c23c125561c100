"""olmoe-1b-7b — fully MoE LM: 64 experts, top-8, fine-grained d_ff=1024.

[arXiv:2409.02060; hf allenai/OLMoE-1B-7B-0924]  Assigned config:
16L d_model=2048 16H (GQA kv=16 -> MHA) d_ff=1024 vocab=50304,
MoE 64e top-8 on every layer.  ~1B active / ~7B total.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    top_k=8,
    moe_every=1,
    moe_offset=0,
    rope_theta=10_000.0,
    qk_norm=True,            # OLMoE uses QK-norm
    source="arXiv:2409.02060 (OLMoE); hf:allenai/OLMoE-1B-7B-0924",
)
