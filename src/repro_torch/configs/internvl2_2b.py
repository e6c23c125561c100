"""internvl2-2b — VLM: InternViT frontend (stub) + InternLM2-1.8B backbone.

[arXiv:2404.16821; hf OpenGVLab/InternVL2-2B]  Assigned config:
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
The vision frontend is a STUB per the assignment: input_specs() provides 256
precomputed patch embeddings that are prepended to the token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1_000_000.0,   # InternLM2 long-context rope base
    frontend="patch_stub",
    num_prefix_embeds=256,
    source="arXiv:2404.16821 (InternVL2); hf:OpenGVLab/InternVL2-2B",
)
