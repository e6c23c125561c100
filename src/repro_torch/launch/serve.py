"""Serving CLI of the port: the ``kv`` mode of the JAX package's
``launch/serve.py`` over ``repro_torch.serving``.

``kv`` runs the multi-tenant continuous-batching KV engine under a
YCSB-style load: one tenant per workload letter (A-F), the YCSB load phase,
admission quotas, step-level op coalescing, JSON metrics.

    python -m repro_torch.launch.serve --mode kv --workloads A,B,E \\
        --requests 64 --slots 16                    # on the card
    python -m repro_torch.launch.serve --mode kv --device cpu ...

The flags are the JAX CLI's, plus ``--device``.  ``--backend`` defaults to
``perf`` here (``ref`` in the JAX CLI): on the card ``ref`` is the plain
PyTorch compare and launches no kernel.  ``--mode decode`` waits for the
model zoo (ROADMAP Queue 1 item 12); ``--mesh-shards`` and
``--no-fused-tick`` wait for the mesh backend (item 9).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.serving import build_ycsb_engine


def serve_kv(*, workloads="A", tenants=None, requests=64, slots=16,
             shards=1, record_count=1024, ops_per_request=4,
             max_pending=0, tenant_slots=0, seed=0, backend="perf",
             pipeline=1, verbose=True, trace_out=None, metrics_prom=None,
             device=None):
    """Thin driver over the multi-tenant KV serving engine: one tenant per
    workload letter (comma-separated), YCSB load phase, then a drained
    continuous-batching run on ``device`` (None: the card).  ``pipeline``
    > 1 enables multi-tick op pipelining.  ``trace_out`` turns on tick
    tracing and writes Chrome/Perfetto trace-event JSON there after the
    drain (``tools/trace_report.py`` reads it); ``metrics_prom`` writes the
    Prometheus text exposition of the run's metrics.  Returns
    (engine, snapshot)."""
    wls = [w.strip().upper() for w in workloads.split(",") if w.strip()]
    n_tenants = tenants or len(wls)
    eng, gens = build_ycsb_engine(
        [wls[i % len(wls)] for i in range(n_tenants)], slots=slots,
        shards=shards, record_count=record_count,
        ops_per_request=ops_per_request, backend=backend, seed=seed,
        max_pending=max_pending, tenant_slots=tenant_slots,
        pipeline_depth=pipeline, trace=bool(trace_out), device=device)
    per = requests // n_tenants
    reqs = [r for g in gens for r in g.requests(per)]
    eng.submit_all(reqs)
    snap = eng.run()
    if trace_out:
        n = eng.export_trace(trace_out, workloads=workloads)
        if verbose:
            print(f"wrote {n} trace events -> {trace_out}")
    if metrics_prom:
        with open(metrics_prom, "w") as f:
            f.write(eng.metrics.to_prom())
        if verbose:
            print(f"wrote Prometheus exposition -> {metrics_prom}")
    if verbose:
        print(json.dumps({**snap, "engine": eng.stats()}, indent=2,
                         default=str))
    return eng, snap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="kv", choices=["decode", "kv"])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions; the card by "
                         "default")
    ap.add_argument("--backend", default="perf",
                    choices=["ref", "perf", "area", "bitserial"],
                    help="probe backend of the tables (default perf: on the "
                         "card ref runs no kernel)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--workloads", default="A",
                    help="comma-separated YCSB letters, one tenant per "
                         "entry, e.g. A,B,E")
    ap.add_argument("--slots", type=int, default=16,
                    help="concurrent request slots")
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--record-count", type=int, default=1024)
    ap.add_argument("--ops-per-request", type=int, default=4)
    ap.add_argument("--mesh-shards", type=int, default=0,
                    help="mesh-backed shards: not ported yet (ROADMAP "
                         "Queue 1 item 9); only 0 (host shards) runs")
    ap.add_argument("--pipeline", type=int, default=1,
                    help="multi-tick op pipelining depth (1 = off)")
    ap.add_argument("--no-fused-tick", action="store_true",
                    help="a mesh-backend option: not ported yet (ROADMAP "
                         "Queue 1 item 9)")
    ap.add_argument("--trace-out", default=None,
                    help="enable tick tracing and write Chrome/Perfetto "
                         "trace-event JSON here (tools/trace_report.py "
                         "reads it)")
    ap.add_argument("--metrics-prom", default=None,
                    help="write the Prometheus text exposition of the run's "
                         "metrics here")
    args = ap.parse_args(argv)

    if args.mode == "decode":
        ap.error("--mode decode is not ported yet: it needs the model zoo "
                 "(ROADMAP Queue 1 item 12)")
    if args.mesh_shards > 0 or args.no_fused_tick:
        ap.error("--mesh-shards and --no-fused-tick need the mesh backend, "
                 "not ported yet (ROADMAP Queue 1 item 9)")
    serve_kv(workloads=args.workloads, requests=args.requests,
             slots=args.slots, shards=args.shards,
             record_count=args.record_count,
             ops_per_request=args.ops_per_request, backend=args.backend,
             pipeline=args.pipeline, trace_out=args.trace_out,
             metrics_prom=args.metrics_prom, device=args.device)


if __name__ == "__main__":
    main()
