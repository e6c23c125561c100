"""Serving telemetry on bounded state: log-bucketed histograms, a top-K
hot-key sketch, per-phase latency blocks, and Prometheus exposition.

Everything is host-side, allocation-light, and — unlike the earlier
list-accumulating collector, which grew ``req_ticks``/``req_secs``/
``tick_ops`` without bound (an OOM on long serving runs) — **O(1) in run
length**: samples land in fixed-size :class:`LogHistogram` buckets
(HdrHistogram-style: exact below ``2*subbuckets`` units, <=
``1/(2*subbuckets)`` relative error above, so percentiles stay within ~1%
of exact at the default 64 sub-buckets), counts and occupancy in exact
running counters, chain telemetry in a bounded ring, and per-key op
frequencies in a :class:`SpaceSaving` top-K sketch (the classic
space-saving counter: every reported count overestimates by at most the
tracked ``err``, and any key with true frequency above ``count_min`` is
guaranteed present — the right shape for skew/hot-key diagnosis).

``snapshot()`` keeps the historical schema (latency/tick/occupancy/op
blocks, chain + rows-activated telemetry) and adds per-phase latency
blocks (fed by the engine's tracer spans via ``record_phase``), the
queue-vs-service split, and the hot-key table; ``to_prom()`` renders the
same state as Prometheus text exposition (counters, gauges, and summary
quantiles) for scraping.  Chain-length telemetry is sampled from the live
HashMem on a throttle, since the chain walk runs on the device and its
result crosses to the host.

A copy of the JAX package's ``serving/metrics.py``; only
``force_chain_sample`` differs: it walks the chains with the port's
``hashmap.chain_lengths`` and copies them to the host explicitly, once per
sample for all shards.
"""
from __future__ import annotations

import json
import math
import time

import numpy as np


def finite(x, default: float = 0.0) -> float:
    """float(x), with NaN/inf coerced to ``default`` — every scalar that can
    land in a BENCH_*.json row goes through here, so a drained-early engine
    (zero completed requests, zero ticks) can never leak NaN or Infinity
    into the trajectory files (Infinity isn't even valid JSON)."""
    x = float(x)
    return x if math.isfinite(x) else default


def percentile(samples, q: float) -> float:
    """q in [0, 100].  Total over the degenerate sample sets a serving run
    can produce: an EMPTY set (engine drained before any request completed)
    returns 0.0 instead of raising like ``np.percentile``, a single sample
    returns that sample for every q, and a non-finite result (NaN samples)
    is coerced to 0.0."""
    if not len(samples):
        return 0.0
    return finite(np.percentile(np.asarray(samples, np.float64), q))


class LogHistogram:
    """Bounded log-bucketed histogram over non-negative floats.

    Values are scaled to integer units of ``lsb`` and bucketed
    HdrHistogram-style: units below ``2*subbuckets`` get their own
    unit-wide bucket (EXACT — integer-valued series like latency-in-ticks
    never see quantization there), larger values land in octaves split
    into ``subbuckets`` linear sub-buckets, so the relative quantization
    error is at most ``1/(2*subbuckets)`` everywhere.  State is one fixed
    int64 count array plus exact count/sum/min/max — O(1) memory however
    many samples are recorded.  ``percentile()`` returns the bucket
    midpoint clamped into [min, max], which makes single-sample and
    constant series exact for every q.
    """

    _MAX_BITS = 52                     # unit magnitudes up to 2^52

    def __init__(self, lsb: float = 1.0, subbuckets: int = 64):
        assert subbuckets >= 2 and subbuckets & (subbuckets - 1) == 0, \
            "subbuckets must be a power of two"
        self.lsb = float(lsb)
        self.S = subbuckets
        self._s = subbuckets.bit_length() - 1
        self.counts = np.zeros((self._MAX_BITS - self._s + 2) * subbuckets,
                               np.int64)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _index(self, units: int) -> int:
        if units < 2 * self.S:
            return units
        e = units.bit_length() - 1
        return (e - self._s + 1) * self.S + ((units >> (e - self._s)) - self.S)

    def record(self, value: float, n: int = 1):
        v = float(value)
        if not math.isfinite(v) or v < 0.0:
            v = 0.0
        units = min(int(v / self.lsb), (1 << self._MAX_BITS) - 1)
        self.counts[self._index(units)] += n
        self.count += n
        self.total += v * n
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def _bucket_mid(self, idx: int) -> float:
        if idx < 2 * self.S:
            return idx * self.lsb      # unit-wide bucket: the value itself
        m = idx // self.S
        lo = (self.S + idx % self.S) << (m - 1)
        width = 1 << (m - 1)
        return (lo + width / 2.0) * self.lsb

    def percentile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        rank = max(1, int(math.ceil(q / 100.0 * self.count)))
        nz = np.nonzero(self.counts)[0]
        cum = np.cumsum(self.counts[nz])
        idx = int(nz[int(np.searchsorted(cum, rank))])
        return finite(min(max(self._bucket_mid(idx), self.vmin), self.vmax))

    def mean(self) -> float:
        return finite(self.total / self.count) if self.count else 0.0

    def min(self) -> float:
        return self.vmin if self.count else 0.0

    def max(self) -> float:
        return self.vmax if self.count else 0.0

    def quantiles(self, scale: float = 1.0) -> dict:
        return {"p50": self.percentile(50) * scale,
                "p99": self.percentile(99) * scale}


class SpaceSaving:
    """Space-saving top-K frequency sketch (Metwally et al.).

    Tracks at most ``k`` keys; a new key evicts the current minimum and
    inherits its count as the overestimation ``err``.  Guarantees: every
    reported count is ``true <= count <= true + err``, and any key whose
    true frequency exceeds the smallest tracked count is in the sketch —
    exactly what's needed to name the hot keys under zipfian skew without
    per-key state.
    """

    def __init__(self, k: int = 64):
        assert k >= 1
        self.k = k
        self._counts: dict = {}          # key -> [count, err]

    def offer(self, key, n: int = 1):
        c = self._counts.get(key)
        if c is not None:
            c[0] += n
        elif len(self._counts) < self.k:
            self._counts[key] = [n, 0]
        else:
            mkey = min(self._counts, key=lambda x: self._counts[x][0])
            mcount = self._counts.pop(mkey)[0]
            self._counts[key] = [mcount + n, mcount]

    def top(self, n: int = 16) -> list:
        """[(key, count, err)] sorted by count descending."""
        items = sorted(self._counts.items(), key=lambda kv: -kv[1][0])
        return [(k, c, e) for k, (c, e) in items[:n]]

    def __len__(self) -> int:
        return len(self._counts)


# the closed op-kind vocabulary: record_ops() rejects anything else, so a
# typo'd kind can't mint a phantom counter key that pollutes BENCH rows
OP_KINDS = ("read", "update", "insert", "delete", "scan", "rmw")

_CHAIN_WINDOW = 64                     # chain-sample ring bound


class MetricsCollector:
    """Per-engine telemetry sink (bounded; see module docstring).

    * ``record_request(ticks, seconds, queue_secs=, service_secs=)`` —
      request completion latency in engine ticks and wall seconds, plus
      the submit→admit (queue) vs admit→complete (service) split;
    * ``record_tick(ops, occupancy, seconds)`` — per-tick throughput and
      slot occupancy;
    * ``record_ops(kind, n, hits)`` — op counts and probe hit rates
      (``kind`` must be one of :data:`OP_KINDS`: ValueError otherwise);
    * ``record_phase(name, seconds)`` — per-phase latency (gather / route /
      fused_tick / writeback / ... — fed from the engine's tracer spans);
    * ``record_hot_keys(keys)`` — folded keys into the top-K sketch;
    * ``sample_chains(hm)`` — chain-length telemetry from a HashMem.
    """

    def __init__(self, chain_sample_every: int = 32, subbuckets: int = 64,
                 hot_k: int = 64):
        self.t0 = time.perf_counter()
        self.ticks = 0
        self.total_ops = 0
        self.occupancy_sum = 0
        self.occupancy_max = 0
        self.requests_completed = 0
        S = subbuckets
        self.req_ticks_h = LogHistogram(1.0, S)
        self.req_secs_h = LogHistogram(1e-6, S)
        self.queue_secs_h = LogHistogram(1e-6, S)
        self.service_secs_h = LogHistogram(1e-6, S)
        self.tick_ops_h = LogHistogram(1.0, S)
        self.tick_secs_h = LogHistogram(1e-6, S)
        self.rows_h = LogHistogram(1.0 / 1024, S)
        self.phase_h: dict[str, LogHistogram] = {}
        self._subbuckets = S
        self.ops = {k: 0 for k in OP_KINDS}
        self.hits = 0
        self.probes = 0
        self.hot = SpaceSaving(hot_k)
        self.chain_sample_every = chain_sample_every
        self._ticks_since_chain_sample = 0
        from collections import deque
        self.chain_samples: deque = deque(maxlen=_CHAIN_WINDOW)

    # -- recording ---------------------------------------------------------
    def record_request(self, ticks: int, seconds: float,
                       queue_secs: float | None = None,
                       service_secs: float | None = None):
        self.requests_completed += 1
        self.req_ticks_h.record(ticks)
        self.req_secs_h.record(seconds)
        if queue_secs is not None:
            self.queue_secs_h.record(queue_secs)
        if service_secs is not None:
            self.service_secs_h.record(service_secs)

    def record_tick(self, ops: int, occupancy: int, seconds: float):
        self.ticks += 1
        self.total_ops += int(ops)
        self.occupancy_sum += int(occupancy)
        if occupancy > self.occupancy_max:
            self.occupancy_max = int(occupancy)
        self.tick_ops_h.record(ops)
        self.tick_secs_h.record(seconds)

    def record_ops(self, kind: str, n: int, hits: int | None = None):
        if kind not in self.ops:
            raise ValueError(
                f"unknown op kind {kind!r} (must be one of {OP_KINDS})")
        self.ops[kind] += n
        if hits is not None:
            self.probes += n
            self.hits += hits

    def record_phase(self, name: str, seconds: float):
        h = self.phase_h.get(name)
        if h is None:
            h = self.phase_h[name] = LogHistogram(1e-6, self._subbuckets)
        h.record(seconds)

    def record_hot_keys(self, keys):
        for k in keys:
            self.hot.offer(int(k))

    def sample_chains(self, hms) -> bool:
        """Throttled chain-length sample over one HashMem, a list of shards
        or of their ``hashmap.chain_lengths`` walks (aggregated, so a single
        hot shard is visible in max_chain), or a zero-arg callable
        producing either — the engine passes its backend's
        ``chain_walks``, so walks (and, over ranks, their gather) happen
        only on sampled ticks; returns True when it sampled."""
        self._ticks_since_chain_sample += 1
        if self._ticks_since_chain_sample < self.chain_sample_every:
            return False
        self._ticks_since_chain_sample = 0
        self.force_chain_sample(hms)
        return True

    def force_chain_sample(self, hms):
        """Chain-length sample over every shard now: the shards' walks are
        concatenated on the device and cross to the host in ONE copy."""
        import torch

        from repro_torch.core import hashmap
        if callable(hms):
            hms = hms()
        if not isinstance(hms, (list, tuple)):
            hms = [hms]
        walks = [hm if isinstance(hm, torch.Tensor)
                 else hashmap.chain_lengths(hm) for hm in hms]
        cl = torch.cat(walks).cpu().numpy()
        cls = np.split(cl, np.cumsum([w.numel() for w in walks])[:-1])
        self.chain_samples.append({
            "tick": self.ticks,
            "mean_chain": float(cl.mean()),
            "max_chain": int(cl.max(initial=0)),
            "chain_p50": percentile(cl, 50),
            "chain_p99": percentile(cl, 99),
            "max_chain_per_shard": [int(c.max(initial=0)) for c in cls],
            "buckets": int(cl.shape[0]),
        })

    def record_rows_activated(self, mean_rows: float):
        """Per-sample mean DRAM-row activations per probe, from
        ``hashmap.rows_activated_per_probe`` on a sampled tick's probe keys
        (the engine throttles this alongside ``sample_chains``)."""
        self.rows_h.record(finite(mean_rows))

    # -- reduction ---------------------------------------------------------
    def snapshot(self) -> dict:
        wall = time.perf_counter() - self.t0
        ticks = self.ticks
        total_ops = self.total_ops
        return {
            "wall_seconds": finite(wall),
            "ticks": ticks,
            "total_ops": total_ops,
            "ops_per_sec": finite(total_ops / wall) if wall > 0 else 0.0,
            "ops_per_tick": finite(total_ops / ticks) if ticks else 0.0,
            "requests_completed": self.requests_completed,
            "request_latency_ticks": {
                "p50": self.req_ticks_h.percentile(50),
                "p99": self.req_ticks_h.percentile(99),
                "max": finite(self.req_ticks_h.max()),
            },
            "request_latency_ms": self.req_secs_h.quantiles(1e3),
            "queue_ms": self.queue_secs_h.quantiles(1e3),
            "service_ms": self.service_secs_h.quantiles(1e3),
            "tick_ms": self.tick_secs_h.quantiles(1e3),
            "phase_ms": {
                name: {**h.quantiles(1e3), "mean": h.mean() * 1e3,
                       "count": h.count}
                for name, h in sorted(self.phase_h.items())},
            "occupancy": {
                "mean": finite(self.occupancy_sum / ticks) if ticks else 0.0,
                "max": self.occupancy_max,
            },
            "op_counts": dict(self.ops),
            "probe_hit_rate": finite(self.hits / self.probes)
            if self.probes else 0.0,
            "hot_keys": [{"key": k, "count": c, "err": e}
                         for k, c, e in self.hot.top(8)],
            "chain_telemetry": list(self.chain_samples)[-8:],
            "chain_depth": {
                "p50": self.chain_samples[-1]["chain_p50"]
                if self.chain_samples else 0.0,
                "p99": self.chain_samples[-1]["chain_p99"]
                if self.chain_samples else 0.0,
            },
            "rows_activated": {
                "p50": self.rows_h.percentile(50),
                "p99": self.rows_h.percentile(99),
                "mean": self.rows_h.mean(),
            },
        }

    def to_json(self, **extra) -> str:
        # allow_nan=False turns any non-finite scalar that slipped past the
        # finite() coercions into a hard error instead of invalid JSON
        return json.dumps({**self.snapshot(), **extra}, indent=2,
                          allow_nan=False)

    def to_prom(self, prefix: str = "hashmem") -> str:
        """Prometheus text exposition of the collector state: op/tick/
        request counters, occupancy gauges, summary quantiles for the
        latency histograms (request/queue/service/tick and every recorded
        phase), and the hot-key table."""
        snap = self.snapshot()
        lines: list[str] = []

        def counter(name, value, labels=""):
            lines.append(f"# TYPE {prefix}_{name} counter")
            lines.append(f"{prefix}_{name}{labels} {value}")

        def gauge(name, value, labels="", typed=True):
            if typed:
                lines.append(f"# TYPE {prefix}_{name} gauge")
            lines.append(f"{prefix}_{name}{labels} {finite(value)}")

        def summary(name, h: LogHistogram):
            lines.append(f"# TYPE {prefix}_{name} summary")
            for q in (0.5, 0.9, 0.99):
                lines.append(f'{prefix}_{name}{{quantile="{q}"}} '
                             f"{finite(h.percentile(q * 100))}")
            lines.append(f"{prefix}_{name}_sum {finite(h.total)}")
            lines.append(f"{prefix}_{name}_count {h.count}")

        counter("ticks_total", snap["ticks"])
        counter("ops_total", snap["total_ops"])
        lines.append(f"# TYPE {prefix}_ops_by_kind_total counter")
        for kind, n in snap["op_counts"].items():
            lines.append(f'{prefix}_ops_by_kind_total{{kind="{kind}"}} {n}')
        counter("requests_completed_total", snap["requests_completed"])
        gauge("ops_per_sec", snap["ops_per_sec"])
        gauge("probe_hit_rate", snap["probe_hit_rate"])
        gauge("occupancy_mean", snap["occupancy"]["mean"])
        gauge("occupancy_max", snap["occupancy"]["max"])
        gauge("chain_depth_p99", snap["chain_depth"]["p99"])
        gauge("rows_activated_mean", snap["rows_activated"]["mean"])
        summary("request_latency_seconds", self.req_secs_h)
        summary("request_queue_seconds", self.queue_secs_h)
        summary("request_service_seconds", self.service_secs_h)
        summary("tick_seconds", self.tick_secs_h)
        lines.append(f"# TYPE {prefix}_phase_seconds summary")
        for name, h in sorted(self.phase_h.items()):
            for q in (0.5, 0.99):
                lines.append(
                    f'{prefix}_phase_seconds{{phase="{name}",'
                    f'quantile="{q}"}} {finite(h.percentile(q * 100))}')
            lines.append(f'{prefix}_phase_seconds_sum{{phase="{name}"}} '
                         f"{finite(h.total)}")
            lines.append(f'{prefix}_phase_seconds_count{{phase="{name}"}} '
                         f"{h.count}")
        lines.append(f"# TYPE {prefix}_hot_key_ops gauge")
        for k, c, _ in self.hot.top(8):
            lines.append(f'{prefix}_hot_key_ops{{key="{k:#x}"}} {c}')
        return "\n".join(lines) + "\n"
