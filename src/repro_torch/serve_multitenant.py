"""Three tenants, three YCSB workloads, one HashMem: the multi-tenant
continuous-batching serving engine end to end (the JAX package's
``examples/serve_multitenant.py``, at the same sizes).

  * "webapp"    — workload A (update-heavy, zipfian) with a tight slot
                  quota, so the engine throttles it instead of letting it
                  starve the others;
  * "analytics" — workload E (short scans, zipfian);
  * "feed"      — workload D (read-latest: reads skew to fresh inserts).

All three share ONE table through tenant-folded keys; every tick coalesces
the whole batch into at most one probe/delete/insert call, and the JSON
telemetry at the end shows per-tenant attribution plus engine-wide
p50/p99 latency, throughput, occupancy, and chain depth.

    python -m repro_torch.serve_multitenant                 # on the card
    python -m repro_torch.serve_multitenant --device cpu    # plain versions
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import HashMemConfig
from repro_torch.serving import (LoadGen, ServingEngine, TenantRegistry,
                                 WorkloadSpec, preload_engine)


def main(device=None):
    reg = TenantRegistry()
    tenants = [
        (reg.register("webapp", max_slots=6),
         WorkloadSpec("A", record_count=2048, ops_per_request=6)),
        (reg.register("analytics"),
         WorkloadSpec("E", record_count=1024, ops_per_request=4,
                      scan_len=12)),
        (reg.register("feed"),
         WorkloadSpec("D", record_count=1024, ops_per_request=5)),
    ]
    gens = [LoadGen(spec, t, seed=10 + t.tid) for t, spec in tenants]

    eng = ServingEngine(
        HashMemConfig(num_buckets=512, slots_per_page=64,
                      overflow_pages=512, max_chain=8, backend="perf"),
        max_slots=16, max_pending=64, tenants=reg, device=device)
    preload_engine(eng, gens)
    print(f"device: {eng.device}")

    for g in gens:
        outcome = eng.submit_all(g.requests(24))
        print(f"{g.tenant.name:10s} submitted 24 requests -> {outcome}")

    snap = eng.run()
    print(f"\ndrained in {eng.ticks} ticks: {snap['total_ops']} ops, "
          f"{snap['ops_per_sec']:.0f} ops/s, "
          f"{sum(eng.batch_calls.values())} HashMem calls "
          f"({sum(eng.batch_calls.values()) / eng.ticks:.1f}/tick), "
          f"grows={eng.grow_events} compactions={eng.compact_events}")
    print(f"request latency p50={snap['request_latency_ticks']['p50']:.0f} "
          f"p99={snap['request_latency_ticks']['p99']:.0f} ticks; "
          f"occupancy mean={snap['occupancy']['mean']:.1f}/16")
    print("\nper-tenant stats:")
    print(json.dumps(reg.stats(), indent=2))
    return reg, eng


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="'cpu' for the plain PyTorch versions; the "
                             "card by default")
    main(parser.parse_args().device)
