"""Key/value workload generators for the HashMem microbenchmark (paper §4.1.1)
and the YCSB core workloads' op mixes and key skew (the serving load).

numpy only, and the same draws as the JAX package's ``repro.data.kv_synth``
for the same seed, so both packages see the same data.
"""
from __future__ import annotations

import numpy as np


def kv_dataset(num_pairs: int, seed: int = 0):
    """Unique uint32 keys + values (paper: 100M pairs, 4B key + 4B value)."""
    rng = np.random.default_rng(seed)
    # unique keys below the sentinel range
    keys = rng.choice(np.uint32(0xFFFFFFF0), size=num_pairs, replace=False) \
        if num_pairs <= 2**26 else _unique_keys_large(rng, num_pairs)
    vals = rng.integers(0, 2**32 - 1, size=num_pairs, dtype=np.uint64) \
        .astype(np.uint32)
    return keys.astype(np.uint32), vals


def _unique_keys_large(rng, n):
    # sampling without replacement at 100M scale: random 64-bit, hash to 32,
    # dedupe, top-up
    keys = _sorted_unique((rng.integers(0, 0xFFFFFFF0, size=int(n * 1.2),
                                        dtype=np.uint64)).astype(np.uint32))
    while keys.size < n:
        extra = (rng.integers(0, 0xFFFFFFF0, size=n, dtype=np.uint64)
                 ).astype(np.uint32)
        keys = _sorted_unique(np.concatenate([keys, extra]))
    rng.shuffle(keys)
    return keys[:n]


def _sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` by sorting: the same sorted unique values.  With
    numpy 2.3, ``np.unique`` took minutes on 121M keys where a sort takes
    seconds."""
    a = np.sort(a)
    first = np.empty(a.size, bool)
    first[:1] = True
    np.not_equal(a[1:], a[:-1], out=first[1:])
    return a[first]


def probe_set(keys: np.ndarray, fraction: float, seed: int = 1):
    """Paper: 10% of keys probed, selected at random."""
    rng = np.random.default_rng(seed)
    n = int(len(keys) * fraction)
    idx = rng.choice(len(keys), size=n, replace=False)
    return keys[idx], idx


def zipfian_weights(n: int, theta: float = 0.99) -> np.ndarray:
    """YCSB Zipfian popularity weights over ranks 1..n (hot head, long tail).

    ``theta`` is the YCSB skew constant (0.99 is the YCSB default; 0 is
    uniform).  Returned weights are normalized to sum to 1.
    """
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** theta
    return w / w.sum()


# YCSB core workload op mixes (Cooper et al., SoCC'10).  "rmw" is
# read-modify-write; "scan" reads a short run of consecutive keys.  The
# standard key distribution per workload is noted for the loadgen defaults.
_YCSB_MIXES = {
    "A": {"read": 0.5, "update": 0.5},
    "B": {"read": 0.95, "update": 0.05},
    "C": {"read": 1.0},
    "D": {"read": 0.95, "insert": 0.05},
    "E": {"scan": 0.95, "insert": 0.05},
    "F": {"read": 0.5, "rmw": 0.5},
}
_YCSB_DISTS = {"A": "zipfian", "B": "zipfian", "C": "zipfian",
               "D": "latest", "E": "zipfian", "F": "zipfian"}


def ycsb_mix(workload: str) -> dict:
    """Op mix for YCSB core workload A-F as {op_kind: probability}."""
    wl = workload.upper()
    if wl not in _YCSB_MIXES:
        raise KeyError(f"unknown YCSB workload {workload!r}; "
                       f"available: {sorted(_YCSB_MIXES)}")
    return dict(_YCSB_MIXES[wl])


def ycsb_default_dist(workload: str) -> str:
    """The standard key distribution for a YCSB core workload."""
    return _YCSB_DISTS[workload.upper()]
