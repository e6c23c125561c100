"""Key/value workload generators for the HashMem microbenchmark (paper §4.1.1),
the mixed mutation streams (``churn_workload``, ``zipfian_workload``), the
YCSB core workloads' op mixes and key skew (the serving load), and the
dictionary-word bucket-distribution study (paper Fig. 4).

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


def churn_workload(n_ops: int, keyspace: int = 4096, insert_batch: int = 8,
                   delete_batch: int = 4, probe_batch: int = 16,
                   p_insert: float = 0.5, p_delete: float = 0.25,
                   seed: int = 0):
    """Mixed online-mutation op stream for the mutation engine.

    Yields ``(op, keys, vals)`` tuples with op in {"insert", "delete",
    "probe"}; keys are drawn Zipf-skewed from a bounded keyspace so the
    stream produces duplicate keys, tombstone-then-reinsert patterns and
    hot buckets — the access shape a live serving table sees, as opposed to
    the paper's populate-once microbenchmark (kv_dataset above).
    """
    rng = np.random.default_rng(seed)
    pool = rng.choice(np.uint32(0xFFFFFFF0), size=keyspace,
                      replace=False).astype(np.uint32)
    # Zipf-ish ranks: hot head, long tail
    w = 1.0 / np.arange(1, keyspace + 1) ** 0.8
    w /= w.sum()
    for _ in range(n_ops):
        r = rng.random()
        if r < p_insert:
            k = rng.choice(pool, size=insert_batch, p=w)
            v = rng.integers(1, 2**31, size=insert_batch,
                             dtype=np.int64).astype(np.uint32)
            yield "insert", k, v
        elif r < p_insert + p_delete:
            yield "delete", rng.choice(pool, size=delete_batch, p=w), None
        else:
            yield "probe", rng.choice(pool, size=probe_batch, p=w), None


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


def zipfian_workload(n_ops: int, keyspace: int = 4096, theta: float = 0.99,
                     insert_batch: int = 8, delete_batch: int = 4,
                     probe_batch: int = 16, mix=None, workload: str = None,
                     seed: int = 0):
    """Zipfian-skewed mixed op stream in the same ``(op, keys, vals)`` shape
    as :func:`churn_workload`.

    ``mix`` maps {"insert", "delete", "probe"} to probabilities (defaults to
    churn_workload's 0.5/0.25/0.25).  Alternatively pass ``workload`` (YCSB
    A-F): reads/scans map to "probe", updates/inserts/rmw to "insert", and a
    small delete fraction is mixed in so tombstone paths stay exercised.
    """
    rng = np.random.default_rng(seed)
    if workload is not None:
        ym = ycsb_mix(workload)
        p_probe = ym.get("read", 0.0) + ym.get("scan", 0.0)
        p_insert = ym.get("update", 0.0) + ym.get("insert", 0.0) \
            + ym.get("rmw", 0.0)
        # fold a 5% delete share in proportionally so tombstones appear
        mix = {"probe": 0.95 * p_probe, "insert": 0.95 * p_insert,
               "delete": 0.05}
    mix = mix or {"insert": 0.5, "delete": 0.25, "probe": 0.25}
    total = sum(mix.values())
    p_ins, p_del = mix.get("insert", 0) / total, mix.get("delete", 0) / total
    pool = rng.choice(np.uint32(0xFFFFFFF0), size=keyspace,
                      replace=False).astype(np.uint32)
    w = zipfian_weights(keyspace, theta)
    for _ in range(n_ops):
        r = rng.random()
        if r < p_ins:
            k = rng.choice(pool, size=insert_batch, p=w)
            v = rng.integers(1, 2**31, size=insert_batch,
                             dtype=np.int64).astype(np.uint32)
            yield "insert", k, v
        elif r < p_ins + p_del:
            yield "delete", rng.choice(pool, size=delete_batch, p=w), None
        else:
            yield "probe", rng.choice(pool, size=probe_batch, p=w), None


def dictionary_words(n: int = 350_000, seed: int = 3) -> np.ndarray:
    """Synthetic 'dictionary': Zipf-weighted letter n-grams dictionary-encoded
    to uint32 (paper Fig. 4 maps the first 350k words of a dictionary).
    Word keys are the dictionary-encoded numeric ids the paper prescribes for
    string data (§4.1.1): FNV-1a over the letters, unique, below the
    sentinel range."""
    rng = np.random.default_rng(seed)
    # mimic word-length distribution 3..14, characters Zipf over 26 letters
    lengths = rng.integers(3, 15, size=n)
    p = 1.0 / np.arange(1, 27) ** 1.07
    p /= p.sum()
    out = np.zeros(n, np.uint32)
    seen = set()
    for i in range(n):
        while True:
            chars = rng.choice(26, size=lengths[i], p=p)
            h = 2166136261
            for c in chars:
                h = ((h ^ (int(c) + 97)) * 16777619) & 0xFFFFFFFF
            if h not in seen and h < 0xFFFFFFF0:
                seen.add(h)
                out[i] = h
                break
    return out
