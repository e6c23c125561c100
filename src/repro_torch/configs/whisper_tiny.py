"""whisper-tiny — encoder-decoder ASR transformer; conv frontend is a STUB.

[arXiv:2212.04356; unverified]  Assigned config:
4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865, enc-dec.
Per the assignment the audio conv frontend is a stub: input_specs() provides
precomputed frame embeddings (B, frames, d_model) for the encoder; the decoder
is a standard causal transformer with cross-attention.
Decode shapes exercise the DECODER step (32k self-KV horizon is mechanical —
beyond Whisper's trained 448-token horizon; shapes are the contract).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,                # decoder layers
    num_encoder_layers=4,
    is_encoder_decoder=True,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    frontend="audio_stub",
    tie_embeddings=True,         # whisper ties the decoder embedding
    rope_theta=10_000.0,         # repro uses RoPE in the decoder (sinusoidal in paper)
    source="arXiv:2212.04356 (Whisper); unverified",
)
