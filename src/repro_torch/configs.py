"""HashMem configuration (paper Tables 1/2), copied from the JAX package.

Same fields and defaults as ``repro.configs.base.HashMemConfig``, plus the
paper's workload (100M uint32->uint32 pairs, 10% probed) and its two table
sizes.  The port keeps its own copy so it never imports the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass


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

# Sized so that the paper's 100M pairs fit at the paper's load factor:
# 2^18 buckets x 512 slots/page = 134M direct slots (+ overflow arena).
PAPER_HASHMEM = HashMemConfig(
    num_buckets=1 << 18,
    slots_per_page=512,
    key_bits=32,
    overflow_pages=1 << 16,
    hash_fn="murmur3_fmix",
    backend="perf",
    max_chain=8,
)

# Scaled table for small runs.
SCALED_HASHMEM = HashMemConfig(
    num_buckets=1 << 12,
    slots_per_page=512,
    key_bits=32,
    overflow_pages=1 << 10,
    hash_fn="murmur3_fmix",
    backend="perf",
    max_chain=8,
)
