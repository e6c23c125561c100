"""phi4-mini-3.8b — dense GQA transformer, RoPE + SwiGLU, 200k vocab.

[arXiv:2412.08905; hf microsoft/Phi-4-mini-instruct]  Assigned config:
32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    tie_embeddings=True,     # phi-4-mini ties the LM head
    rope_theta=10_000.0,
    source="arXiv:2412.08905 (Phi-4); hf:microsoft/Phi-4-mini-instruct",
)
