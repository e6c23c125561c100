"""llama4-maverick-400b-a17b — MoE 128e top-1 with interleaved dense layers.

[hf:meta-llama/Llama-4-Scout-17B-16E family; unverified]  Assigned config:
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts top-1.
Llama-4 style: MoE on every other layer (expert d_ff=8192 + 1 shared expert),
dense SwiGLU (d_ff=16384) on the rest; early-fusion multimodal is out of the
assigned backbone scope.  ~400B total / ~17B active parameters.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,               # expert width
    d_ff_dense=16384,        # interleaved dense-layer width
    vocab_size=202048,
    num_experts=128,
    top_k=1,
    moe_every=2,
    moe_offset=1,
    num_shared_experts=1,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (family); unverified",
)
