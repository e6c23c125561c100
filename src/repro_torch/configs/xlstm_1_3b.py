"""xlstm-1.3b — recurrent xLSTM LM: sLSTM + mLSTM blocks (1:7).

[arXiv:2405.04517; unverified]  Assigned config:
48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304.
d_ff=0: xLSTM blocks carry their own up/down projections; there is no separate
FFN sub-block.  Every 8th layer is sLSTM (scalar memory, strictly sequential),
the rest mLSTM (matrix memory, chunkwise-parallel).  head_dim = 2048/4 = 512.
Attention-free -> the long_500k decode shape RUNS for this arch (O(1) state).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,
    source="arXiv:2405.04517 (xLSTM); unverified",
)
