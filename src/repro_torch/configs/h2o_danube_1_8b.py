"""h2o-danube-1.8b — llama/mistral-mix dense LM with sliding-window attention.

[arXiv:2401.16818; hf h2oai/h2o-danube-1.8b-base]  Assigned config:
24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA.
head_dim = 2560/32 = 80.  Sliding window 4096 (mistral-style).
SWA makes the long_500k decode shape sub-quadratic (bounded KV) -> this arch
RUNS the long_500k cell (see DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10_000.0,
    source="arXiv:2401.16818 (H2O-Danube); hf:h2oai/h2o-danube-1.8b-base",
)
