"""Multi-tenant continuous-batching serving layer over HashMem, in PyTorch
(the JAX package's ``serving``).

  engine.py   — ServingEngine / SlotPool / Request: admission control,
                slot lifecycle, step-level op coalescing (one vectorized
                HashMem call per phase per host shard per tick, or one
                routed call per phase, or per tick, on a mesh)
  tenancy.py  — tenant-folded key space, quotas, per-tenant stats
  metrics.py  — bounded log-bucketed histograms, hot-key sketch,
                per-phase latency, Prometheus exposition
  tracing.py  — tick-level spans on a bounded ring, Chrome/Perfetto
                trace-event export (``ServingEngine(trace=True)``)
  loadgen.py  — YCSB-style workloads A-F (zipfian / uniform / latest)
"""
from repro_torch.serving.engine import (   # noqa: F401
    PAD_KEY, Request, ServingEngine, SlotPool,
)
from repro_torch.serving.loadgen import (  # noqa: F401
    LoadGen, WorkloadSpec, build_ycsb_engine, preload_engine,
)
from repro_torch.serving.metrics import (  # noqa: F401
    LogHistogram, MetricsCollector, SpaceSaving,
)
from repro_torch.serving.tracing import NULL_TRACER, Tracer  # noqa: F401
from repro_torch.serving.tenancy import (  # noqa: F401
    Tenant, TenantRegistry, TenantSpace,
)
