"""Config dataclasses of the port, copied from the JAX package's
``configs/base.py``: every field, default and value as there.

Every architecture gets a ``ModelConfig`` in its own module under
``repro_torch.configs``; the registry in ``repro_torch.configs.__init__``
maps ``--arch`` ids to them.  Shapes (the 4 input-shape regimes) are global
and live in ``SHAPES`` below, with the training (``OptimConfig``,
``TrainConfig``) and serving (``ServeConfig``) configs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (exact assigned values; see configs/<id>.py)."""

    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1               # layer i is MoE iff i % moe_every == moe_offset
    moe_offset: int = 1
    d_ff_dense: int = 0              # FFN width of interleaved dense layers (0 = d_ff)
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2
    moe_impl: str = "gspmd"          # gspmd (global dispatch, baseline) |
                                     # ep (shard_map expert-parallel all_to_all)

    # --- attention ---
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 = full attention
    qk_norm: bool = False
    attn_every: int = 1              # hybrid: layer i is attention iff i % attn_every == attn_offset
    attn_offset: int = 0             # (else SSM block); attn_every=1 -> all attention

    # --- SSM (mamba) ---
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0             # 0 -> ceil(d_model/16)

    # --- xLSTM ---
    slstm_every: int = 0             # >0: layer i is sLSTM iff i % slstm_every == 0 (else mLSTM)

    # --- encoder-decoder ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # --- modality frontend stubs ---
    frontend: str = "none"           # none | patch_stub | audio_stub
    num_prefix_embeds: int = 0       # vlm: number of precomputed patch embeddings

    # --- numerics / misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    vocab_pad_to: int = 256          # pad vocab for clean lane/shard divisibility
    remat: bool = True               # activation checkpointing per block
    scan_layers: bool = True         # lax.scan over stacked layer params
    inner_unroll: bool = False       # unroll inner chunk scans (cost probes)
    mlstm_unroll: bool = True        # allow inner_unroll to expand the mLSTM
                                     # chunk scan
    attn_chunk: int = 1024           # kv-chunk size for flash-style chunked attention
    mamba_chunk: int = 64            # chunk length for the chunked selective scan
    mlstm_chunk: int = 64            # chunk length for chunked mLSTM
    mlstm_scan_groups: int = 0       # >0: two-level sqrt-remat over mLSTM
                                     # chunks

    # source citation for the exact numbers (required by the assignment)
    source: str = ""

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_to)

    @property
    def d_inner(self) -> int:        # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(1, (self.d_model + 15) // 16)

    def is_moe_layer(self, i: int) -> bool:
        return self.num_experts > 0 and (i % self.moe_every == self.moe_offset % self.moe_every)

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        return i % self.attn_every == self.attn_offset

    def is_slstm_layer(self, i: int) -> bool:
        return self.slstm_every > 0 and i % self.slstm_every == 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Parameter count of ``models.model.init_params``, from shapes
        alone."""
        from repro_torch.models.model import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        """The parameters a token meets: the routed experts' at top_k / E."""
        from repro_torch.models.model import count_params
        return count_params(self, active_only=True)


# ---------------------------------------------------------------------------
# Shapes (assigned shape regimes)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode
    # decode shapes: seq_len is the *KV horizon*, one new token is generated.


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


# ---------------------------------------------------------------------------
# Mesh
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False
    # production: single pod (16,16) ("data","model"); multi-pod (2,16,16)
    # ("pod","data","model").  Overridable for tests.
    shape: Optional[Tuple[int, ...]] = None
    axis_names: Optional[Tuple[str, ...]] = None

    def resolved(self) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
        if self.shape is not None:
            return tuple(self.shape), tuple(self.axis_names)
        if self.multi_pod:
            return (2, 16, 16), ("pod", "data", "model")
        return (16, 16), ("data", "model")


# ---------------------------------------------------------------------------
# Training / serving
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    state_dtype: str = "float32"     # "bfloat16" halves optimizer memory (400B configs)


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    shape: ShapeConfig
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 0
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 50
    log_every: int = 10
    # fault tolerance knobs
    max_restarts: int = 3
    straggler_deadline_s: float = 0.0   # 0 = disabled
    grad_compression: str = "none"      # none | bf16 | int8_ef


@dataclass(frozen=True)
class ServeConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)
    kv_page_tokens: int = 2048          # tokens per KV page (bucket-per-page)
    max_pages_per_seq: int = 0          # 0 -> derived from shape.seq_len
    kv_dtype: str = "bfloat16"

    @property
    def pages_per_seq(self) -> int:
        if self.max_pages_per_seq:
            return self.max_pages_per_seq
        return (self.shape.seq_len + self.kv_page_tokens - 1) // self.kv_page_tokens


# ---------------------------------------------------------------------------
# HashMem (the paper's own workload, Table 1/2)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HashMemConfig:
    """Configuration of the HashMem structure itself (paper Table 1/2)."""

    num_buckets: int = 1 << 15
    slots_per_page: int = 512        # paper: 512-2048 columns per subarray row
    key_bits: int = 32               # paper evaluates 32-bit keys; 4/8/16 supported
    overflow_pages: int = 1 << 14    # pool for chained pages (pim_malloc arena)
    hash_fn: str = "murmur3_fmix"    # murmur3_fmix | mult_shift | identity
    salt: int = 0x9E3779B9
    backend: str = "perf"            # ref | area | perf | bitserial
    max_chain: int = 8               # static probe chain bound (RLU command depth)

    # --- online mutation engine (grow/compact) ---
    auto_grow: bool = True           # arena exhaustion triggers resize instead
                                     # of dropped writes (insert_auto)
    growth_factor: int = 2           # buckets/overflow scale per grow()
    resize: str = "rebuild"          # "rebuild" | "extendible"
    max_load_factor: float = 0.85    # proactive-grow threshold (live / slots)
    compact_tombstone_frac: float = 0.25  # compact() when tombstones exceed
                                          # this fraction of total slots
    compact_chain_len: int = 0       # >0: compaction also fires when any
                                     # bucket chain exceeds this many pages

    # --- fingerprint lane + displacement/stash (Dash / IcebergHT) ---
    fingerprint_bits: int = 0        # >0: per-slot fingerprint bit-planes
    displacement: bool = False       # insert tries the H2 bucket's direct page
    stash_slots: int = 0             # per-table stash entries

    @property
    def num_pages(self) -> int:
        return self.num_buckets + self.overflow_pages


# Paper microbenchmark: 100M uint32->uint32 pairs, 10M random probes
# (section 4.1.1).
PAPER_WORKLOAD = {
    "num_pairs": 100_000_000,
    "probe_fraction": 0.10,
    "key_bytes": 4,
    "value_bytes": 4,
}
