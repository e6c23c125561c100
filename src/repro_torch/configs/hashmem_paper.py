"""The paper's own table sizes (HashMem §4, Tables 1-2), copied from the
JAX package's ``configs/hashmem_paper.py``."""
from repro_torch.configs.base import HashMemConfig

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
