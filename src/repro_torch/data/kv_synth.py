"""Key/value workload generators for the HashMem microbenchmark (paper §4.1.1).

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
