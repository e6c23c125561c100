"""YCSB-style load generator for the serving engine.

Builds :class:`repro_torch.serving.engine.Request` streams from the YCSB core
workloads (A update-heavy, B read-mostly, C read-only, D read-latest,
E short-scans, F read-modify-write) with Zipfian / uniform / latest key
choice, on top of the shared generators in ``repro.data.kv_synth``
(``ycsb_mix`` / ``zipfian_weights``; the port's copy in
``repro_torch.data.kv_synth``).  Each request is a short session of
``ops_per_request`` ops, so continuous batching has multi-tick lifetimes to
schedule around.

The load phase (`preload`) inserts ``record_count`` keys 0..N-1; the run
phase draws op keys from the loaded range, extending it on "insert" ops
(the YCSB insertion-point counter), which is what the "latest" distribution
skews toward.

The PyTorch port of the JAX package's ``serving/loadgen.py``: the same
requests for the same seed, draw for draw.  Only the zipfian draw changes
form: ``Generator.choice(n, p=w)`` checks and cumsums the whole weight
vector on every draw (187.5 ms a draw at 16M records), so the CDF is cached
with the weights and each draw is the ``searchsorted`` of one
``rng.random()`` in it, which is what ``choice`` computes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.data.kv_synth import (ycsb_default_dist, ycsb_mix,
                                       zipfian_weights)
from repro_torch.serving.engine import Request
from repro_torch.serving.tenancy import Tenant

DISTRIBUTIONS = ("zipfian", "uniform", "latest")


@dataclass
class WorkloadSpec:
    """One tenant's workload: a YCSB mix (or explicit op probabilities)
    over a bounded key range."""
    workload: str = "A"                 # YCSB core workload id
    record_count: int = 1024            # preloaded keys 0..record_count-1
    ops_per_request: int = 4
    distribution: str = ""              # "" -> the workload's YCSB default
    theta: float = 0.99                 # zipfian skew constant
    scan_len: int = 8                   # max scan length (E)
    mix: dict | None = None             # overrides ycsb_mix(workload)

    def resolved_mix(self) -> dict:
        return dict(self.mix) if self.mix else ycsb_mix(self.workload)

    def resolved_dist(self) -> str:
        d = self.distribution or ycsb_default_dist(self.workload)
        assert d in DISTRIBUTIONS, d
        return d


class LoadGen:
    """Request-stream generator for one (tenant, workload) pair."""

    def __init__(self, spec: WorkloadSpec, tenant: Tenant | None = None,
                 seed: int = 0):
        self.spec = spec
        self.tenant = tenant
        self.rng = np.random.default_rng(seed)
        self.mix = spec.resolved_mix()
        self.dist = spec.resolved_dist()
        self.kinds = list(self.mix)
        self.probs = np.asarray([self.mix[k] for k in self.kinds])
        self.probs = self.probs / self.probs.sum()
        self.insert_point = spec.record_count    # YCSB insertion counter
        self._zipf_n = 0
        self._zipf_w = None
        self._zipf_cdf = None

    # -- key choice --------------------------------------------------------
    def _zipf(self, n: int) -> int:
        """Zipfian rank in [0, n).  The O(n) weight vector is rebuilt only
        when the key range has grown ~25% past the cached size (inserts bump
        ``insert_point`` on every op in insert-bearing workloads); between
        rebuilds ranks are drawn over the cached prefix — the hot head,
        which is where a zipfian draw lands anyway.  The draw is
        ``Generator.choice(n, p=w)``'s own arithmetic over the cached CDF:
        the same rank for the same generator state, in O(log n)."""
        if self._zipf_w is None or n < self._zipf_n or n > self._zipf_n * 1.25:
            self._zipf_n = n
            self._zipf_w = zipfian_weights(n, self.spec.theta)
            cdf = self._zipf_w.cumsum()
            cdf /= cdf[-1]
            self._zipf_cdf = cdf
        rank = int(self._zipf_cdf.searchsorted(self.rng.random(),
                                               side="right"))
        return min(rank, n - 1)

    def choose_key(self) -> int:
        n = max(self.insert_point, 1)
        if self.dist == "uniform":
            return int(self.rng.integers(0, n))
        if self.dist == "latest":
            # skew toward the most recently inserted keys: zipfian over
            # recency rank (YCSB's LatestGenerator)
            return (n - 1) - self._zipf(n)
        return self._zipf(n)

    def next_insert_key(self) -> int:
        k = self.insert_point
        self.insert_point += 1
        return k

    # -- ops / requests ----------------------------------------------------
    def next_op(self) -> tuple:
        kind = self.kinds[int(self.rng.choice(len(self.kinds), p=self.probs))]
        val = int(self.rng.integers(1, 2**31))
        if kind == "read":
            return ("read", self.choose_key())
        if kind == "update":
            return ("update", self.choose_key(), val)
        if kind == "insert":
            return ("insert", self.next_insert_key(), val)
        if kind == "scan":
            n = int(self.rng.integers(1, self.spec.scan_len + 1))
            return ("scan", self.choose_key(), n)
        if kind == "rmw":
            return ("rmw", self.choose_key(), val)
        raise ValueError(kind)

    def request(self) -> Request:
        ops = [self.next_op() for _ in range(self.spec.ops_per_request)]
        return Request(ops=ops, tenant=self.tenant)

    def requests(self, n: int) -> list:
        return [self.request() for _ in range(n)]

    # -- load phase --------------------------------------------------------
    def preload_kv(self, seed: int | None = None):
        """(keys, vals) for the YCSB load phase: keys 0..record_count-1."""
        rng = np.random.default_rng(self.rng.integers(2**31)
                                    if seed is None else seed)
        keys = np.arange(self.spec.record_count, dtype=np.uint32)
        vals = rng.integers(1, 2**31, self.spec.record_count,
                            dtype=np.int64).astype(np.uint32)
        return keys, vals


def preload_engine(engine, gens: list) -> None:
    """Run the load phase for every generator into the engine's shards."""
    for g in gens:
        keys, vals = g.preload_kv()
        engine.preload(keys, vals, tenant=g.tenant)


def build_ycsb_engine(workloads, *, slots=16, shards=1, record_count=1024,
                      ops_per_request=4, coalesce=True, backend="ref",
                      seed=0, max_pending=0, tenant_slots=0, metrics=None,
                      cfg=None, mesh=None, pipeline_depth=1,
                      fused_tick=None, trace=None, device=None):
    """One preloaded engine + one (tenant, LoadGen) per YCSB workload letter
    — the single assembly path of the serve.py kv CLI, so every run
    exercises identically-sized tables.  ``device``: None = the card,
    "cpu" = the plain PyTorch versions.  ``mesh`` and ``fused_tick=True``
    raise NotImplementedError (ROADMAP Queue 1 item 9).
    ``pipeline_depth``: multi-tick op pipelining (engine.py).
    Returns (engine, [LoadGen, ...])."""
    from repro_torch.configs import HashMemConfig
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.tenancy import TenantRegistry

    reg = TenantRegistry()
    gens = []
    for i, wl in enumerate(workloads):
        t = reg.register(f"tenant{i}-{wl}", max_slots=tenant_slots)
        gens.append(LoadGen(WorkloadSpec(wl, record_count=record_count,
                                         ops_per_request=ops_per_request),
                            t, seed=seed + i))
    cfg = cfg or HashMemConfig(num_buckets=max(256, record_count // 16),
                               slots_per_page=64,
                               overflow_pages=max(256, record_count // 16),
                               max_chain=8, backend=backend)
    eng = ServingEngine(cfg, num_shards=shards, max_slots=slots,
                        max_pending=max_pending, tenants=reg,
                        metrics=metrics, coalesce=coalesce, mesh=mesh,
                        pipeline_depth=pipeline_depth, fused_tick=fused_tick,
                        trace=trace, device=device)
    preload_engine(eng, gens)
    return eng, gens
