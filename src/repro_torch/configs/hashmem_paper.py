"""The paper's own workload config (HashMem §4, Tables 1-2), copied from
the JAX package's ``configs/hashmem_paper.py``: the table sizes, the
microbenchmark (100M uint32->uint32 pairs, 10M random probes) and the
DDR4_8Gb_x16_3200 timing the analytic model reads."""
from repro_torch.configs.base import PAPER_WORKLOAD, HashMemConfig

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

WORKLOAD = dict(PAPER_WORKLOAD)

# DDR4-3200 timing parameters of the analytic model, from the DDR4 JEDEC
# values DRAMsim3 uses for DDR4_8Gb_x16_3200; all in nanoseconds.
DDR4_TIMING = {
    "tCK": 0.625,        # clock period (ns) @ 1600 MHz (DDR-3200)
    "tRCD": 13.75,       # row activate -> column access
    "tRP": 13.75,        # precharge
    "tRAS": 32.0,        # row active time
    "tCAS": 13.75,       # column access strobe (CL22 * tCK)
    "tCCD_S": 2.5,       # column-to-column (short)
    "burst_ns": 2.5,     # BL8 transfer time
    "row_bytes": 1024,   # 8Kb row per x16 device... modeled at rank level: 8KB
    "rank_row_bytes": 8192,
    "channel_gbps": 25.6,  # DDR4-3200 single channel peak
}
