"""Serving CLI of the port: the JAX package's ``launch/serve.py`` over
``repro_torch``, with its two modes.

  * ``decode`` (default): batched LM decode with the HashMem-managed paged
    KV cache.  Slot lifecycle and admission come from the serving engine's
    ``SlotPool``; all page-table traffic in a step is COALESCED -- one
    batched HashMem delete for every sequence finishing in the step
    (``free_seqs``) and one batched insert for every sequence admitted in
    it (``alloc_seqs``) -- and ``PageTableManager.tick()`` runs the
    compaction triggers on the step clock.  Every family but encdec, which
    the reference's loop cannot serve either (``refuse_encdec``).  As in
    JAX, a slot that takes a new sequence keeps the recurrent (mamba,
    mLSTM, sLSTM) states its last one left, idle slots route through the
    MoE layers with the live ones, and a vlm decodes tokens only.

  * ``kv``: the multi-tenant continuous-batching KV engine under a
    YCSB-style load: one tenant per workload letter (A-F), the YCSB load
    phase, admission quotas, step-level op coalescing, JSON metrics.

    python -m repro_torch.launch.serve --arch llama3-8b --smoke \\
        --requests 12 --batch 4 --max-new 16        # on the card
    python -m repro_torch.launch.serve --arch qwen3-8b --smoke --device cpu
    python -m repro_torch.launch.serve --arch olmoe-1b-7b --smoke --device cpu
    python -m repro_torch.launch.serve --arch xlstm-1.3b --smoke --device cpu
    python -m repro_torch.launch.serve --mode kv --workloads A,B,E \\
        --requests 64 --slots 16 [--device cpu]
    python -m repro_torch.launch.serve --mode kv --device cpu \\
        --mesh-shards 4 [--no-fused-tick]           # 4 stacked shards
    python -m repro_torch.launch.serve --mode kv --device cpu \\
        --mesh-shards 2 --ranks                     # 2 rank processes

The flags are the JAX CLI's, plus ``--device``, less ``--mesh``: decode
runs on one card, with the geometry of JAX's default ``(1, 1)`` mesh.
``--backend`` defaults to ``perf`` here (``ref`` in the JAX CLI): on the
card ``ref`` is the plain PyTorch compare and launches no kernel.
``--mesh-shards N`` stacks N shards on the one device (``launch/mesh.py``);
with ``--ranks`` it serves from N rank processes, one shard a rank (the
JAX CLI's one shard a device), over ``torch.distributed``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ServeConfig, ShapeConfig, get_config, \
    smoke_config
from repro_torch.core.layout import resolve_device
from repro_torch.core.paged_kv import PageTableManager
from repro_torch.distributed import steps as dsteps
from repro_torch.models import model
from repro_torch.serving import SlotPool, build_ycsb_engine

# JAX's serving CLI decodes on a (1, 1) ("data", "model") mesh; the port
# takes its geometry (one batch group, one channel) on one card.
DECODE_MESH = {"data": 1, "model": 1}


def _host_buffer(shape, dev):
    """An int32 host array for the step's inputs, and the tensor behind it:
    pinned when the step runs on the card, so each step's copy goes with
    ``non_blocking`` (the step's one host sync, the next tokens, comes
    after it, so the host never rewrites a buffer still being copied)."""
    t = torch.zeros(shape, dtype=torch.int32)
    if dev.type == "cuda":
        t = t.pin_memory()
    return t, t.numpy()


def refuse_encdec(cfg):
    """Raise for an encoder-decoder arch.  The reference's ``serve`` calls
    ``model.init_decode_states`` without ``enc_frames``
    (``src/repro/launch/serve.py:57``) and fails on them; the port keeps
    the limitation and says so.  Encdec decode runs at the library level:
    ``model.init_decode_states(..., enc_frames=...)``, then
    ``model.decode_step``."""
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{cfg.name}: the serving loop does not serve encoder-decoder "
            f"archs: the reference's serve builds the decode states without "
            f"enc_frames (src/repro/launch/serve.py:57) and fails; decode "
            f"through model.init_decode_states(..., enc_frames=...) and "
            f"model.decode_step")


@torch.no_grad()
def serve(cfg, *, batch=4, horizon=256, page_tokens=32, requests=8,
          max_new=16, prompt_len=8, seed=0, backend="perf", verbose=True,
          compact_chain_len=None, device=None):
    """Continuous-batching greedy decode of ``requests`` random prompts on
    ``device`` (None: the card), step for step as the JAX package's
    ``serve``: a model drawn from ``seed``, float32 KV pools, a page table
    on a ``backend`` HashMem.  Each step runs the model on every slot
    (idle ones too), then frees the finished sequences in one batched
    delete, refills the slots with one batched insert and ticks the page
    table.  Builds no autograd graph.  Returns (done requests, the
    PageTableManager, steps run).  Refuses encdec (``refuse_encdec``)."""
    refuse_encdec(cfg)
    dev = resolve_device(device)
    shape = ShapeConfig("serve", horizon, batch, "decode")
    scfg = ServeConfig(model=cfg, shape=shape, kv_page_tokens=page_tokens)
    serve_step, ctx = dsteps.build_serve_step(cfg, scfg, mesh=DECODE_MESH)

    params = model.init_params(cfg, seed, dev)
    states = model.init_decode_states(params, cfg, batch, ctx,
                                      kv_dtype=torch.float32)
    mgr = PageTableManager(ctx.pool_pages, backend=backend,
                           compact_chain_len=compact_chain_len, device=dev)
    rng = np.random.default_rng(seed)

    pool = SlotPool(batch)
    bt_t, block_tables = _host_buffer((batch, ctx.n_pages), dev)
    pos_t, pos = _host_buffer((batch,), dev)
    tok_t, tokens = _host_buffer((batch, 1), dev)
    done = []
    t0 = time.time()
    steps_run = 0

    def place(newly):
        """Coalesced admission: ONE page-table insert for every sequence
        admitted this step, then each slot's block table, position and
        first token.  The slot's decode states are not reset, as in JAX's
        ``serve``: a mamba layer's conv and SSM states carry the previous
        sequence's into the new one (ROADMAP Queue 3)."""
        if not newly:
            return
        phys = mgr.alloc_seqs([(req["id"], ctx.n_pages, 0)
                               for _, req in newly])
        for slot, req in newly:
            block_tables[slot] = phys[req["id"]]
            pos[slot] = 0
            tokens[slot, 0] = req["prompt"][0]
            req["fed"] = 1

    for i in range(requests):
        pool.submit({"id": i,
                     "prompt": rng.integers(0, cfg.vocab_size,
                                            prompt_len).tolist(),
                     "out": []})
    place(pool.active())

    while not pool.idle():
        nt, _, states = serve_step(
            params, states, tok_t.to(dev, non_blocking=True),
            pos_t.to(dev, non_blocking=True),
            bt_t.to(dev, non_blocking=True))
        nt = nt.cpu().numpy()
        steps_run += 1
        finished = []
        for b, req in pool.active():
            pos[b] += 1
            if req["fed"] < len(req["prompt"]):
                tokens[b, 0] = req["prompt"][req["fed"]]   # prompt feeding
                req["fed"] += 1
            else:
                req["out"].append(int(nt[b]))
                tokens[b, 0] = int(nt[b])
                if len(req["out"]) >= max_new or pos[b] >= horizon - 1:
                    finished.append((b, req))
        # tombstone + recycle: ONE batched delete for the whole step
        mgr.free_seqs([req["id"] for _, req in finished])
        for b, req in finished:
            pool.release(b)
            done.append(req)
        place(pool.refill())
        mgr.tick()             # step-clock compaction (not only on frees)

    dt_val = time.time() - t0
    if verbose:
        print(f"served {len(done)} requests in {steps_run} decode steps, "
              f"{dt_val:.1f}s; live pages after drain: {mgr.live_pages()}; "
              f"page-table grows={mgr.grow_events} "
              f"compactions={mgr.compact_events}")
        for req in done[:4]:
            print(f"  req {req['id']}: prompt {req['prompt'][:4]}... -> "
                  f"out {req['out'][:8]}")
    return done, mgr, steps_run


def serve_kv(*, workloads="A", tenants=None, requests=64, slots=16,
             shards=1, record_count=1024, ops_per_request=4,
             max_pending=0, tenant_slots=0, seed=0, backend="perf",
             mesh_shards=0, pipeline=1, fused_tick=None, verbose=True,
             trace_out=None, metrics_prom=None, ranks=False,
             device=None):
    """Thin driver over the multi-tenant KV serving engine: one tenant per
    workload letter (comma-separated), YCSB load phase, then a drained
    continuous-batching run on ``device`` (None: the card).
    ``mesh_shards`` > 0 routes the table through the RLU mesh path
    (``mesh_shards`` shards stacked on the device, or with ``ranks`` one
    shard a rank process over ``torch.distributed``: nccl when there is a
    card a rank, else gloo); ``pipeline`` > 1 enables multi-tick op
    pipelining;
    ``fused_tick=False`` issues one mesh call per phase instead of one a
    tick.  ``trace_out`` turns on tick tracing and writes Chrome/Perfetto
    trace-event JSON there after the drain (``tools/trace_report.py``
    reads it); ``metrics_prom`` writes the Prometheus text exposition of
    the run's metrics.  Returns (engine, snapshot); over ranks (None, rank
    0's snapshot), and only rank 0 prints and writes files."""
    kw = dict(workloads=workloads, tenants=tenants, requests=requests,
              slots=slots, shards=shards, record_count=record_count,
              ops_per_request=ops_per_request, max_pending=max_pending,
              tenant_slots=tenant_slots, seed=seed, backend=backend,
              pipeline=pipeline, fused_tick=fused_tick, verbose=verbose,
              trace_out=trace_out, metrics_prom=metrics_prom)
    if ranks:
        from repro_torch.launch.mesh import spawn_ranks
        if mesh_shards < 1:
            raise ValueError("ranks=True needs mesh_shards >= 1, one a rank")
        on_cpu = device is not None and torch.device(device).type == "cpu"
        if not on_cpu:
            from repro_torch.kernels import build
            build.build_all()       # here, not in N ranks at once
        dist = "gloo" if on_cpu or torch.cuda.device_count() < mesh_shards \
            else "nccl"
        snaps = spawn_ranks(_serve_kv_rank, mesh_shards, kw, backend=dist,
                            device=device)
        return None, snaps[0]
    from repro_torch.launch.mesh import make_serving_mesh
    mesh = make_serving_mesh(mesh_shards, device=device) if mesh_shards \
        else None
    return _serve_kv_on(mesh, device=device, **kw)


def _serve_kv_rank(mesh, kw):
    """One rank of ``serve_kv(ranks=True)``: the same engine and stream on
    every rank; rank 0 alone prints and writes."""
    lead = mesh.rank == 0
    kw = dict(kw, verbose=kw["verbose"] and lead,
              trace_out=kw["trace_out"] if lead else None,
              metrics_prom=kw["metrics_prom"] if lead else None)
    return _serve_kv_on(mesh, device=mesh.device, **kw)[1]


def _serve_kv_on(mesh, *, workloads, tenants, requests, slots, shards,
                 record_count, ops_per_request, max_pending, tenant_slots,
                 seed, backend, pipeline, fused_tick, verbose, trace_out,
                 metrics_prom, device):
    from repro_torch.launch.mesh import RankMesh
    wls = [w.strip().upper() for w in workloads.split(",") if w.strip()]
    n_tenants = tenants or len(wls)
    eng, gens = build_ycsb_engine(
        [wls[i % len(wls)] for i in range(n_tenants)], slots=slots,
        shards=shards, record_count=record_count,
        ops_per_request=ops_per_request, backend=backend, seed=seed,
        max_pending=max_pending, tenant_slots=tenant_slots, mesh=mesh,
        pipeline_depth=pipeline, fused_tick=fused_tick,
        trace=bool(trace_out), device=device)
    per = requests // n_tenants
    reqs = [r for g in gens for r in g.requests(per)]
    eng.submit_all(reqs)
    snap = eng.run()
    # a rank engine's stats gather from every rank: all ranks ask
    stats = eng.stats() if verbose or isinstance(mesh, RankMesh) else None
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
        print(json.dumps({**snap, "engine": stats}, indent=2, default=str))
    return eng, snap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="decode", choices=["decode", "kv"])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions; the card by "
                         "default")
    ap.add_argument("--backend", default="perf",
                    choices=["ref", "perf", "area", "bitserial"],
                    help="probe backend of the tables (default perf: on the "
                         "card ref runs no kernel)")
    ap.add_argument("--requests", type=int, default=8)
    # decode-mode knobs
    ap.add_argument("--arch", default=None, help="(decode mode) model arch")
    ap.add_argument("--smoke", action="store_true",
                    help="(decode mode) the arch's reduced smoke config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--horizon", type=int, default=256)
    ap.add_argument("--page-tokens", type=int, default=32)
    ap.add_argument("--compact-chain-len", type=int, default=None,
                    help="page-table compaction when any bucket chain "
                         "exceeds this many pages (skewed frees); default: "
                         "tombstone-fraction trigger only")
    # kv-mode knobs
    ap.add_argument("--workloads", default="A",
                    help="comma-separated YCSB letters, one tenant per "
                         "entry, e.g. A,B,E")
    ap.add_argument("--slots", type=int, default=16,
                    help="concurrent request slots")
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--record-count", type=int, default=1024)
    ap.add_argument("--ops-per-request", type=int, default=4)
    ap.add_argument("--mesh-shards", type=int, default=0,
                    help=">0: mesh-backed shards, that many stacked on the "
                         "device; 0: host-routed shards")
    ap.add_argument("--pipeline", type=int, default=1,
                    help="multi-tick op pipelining depth (1 = off)")
    ap.add_argument("--ranks", action="store_true",
                    help="with --mesh-shards N: one shard a rank, N rank "
                         "processes over torch.distributed (nccl with a card "
                         "a rank, else gloo; only rank 0 prints)")
    ap.add_argument("--no-fused-tick", action="store_true",
                    help="on a mesh, one call per phase instead of one "
                         "fused call a tick (the mesh default)")
    ap.add_argument("--trace-out", default=None,
                    help="enable tick tracing and write Chrome/Perfetto "
                         "trace-event JSON here (tools/trace_report.py "
                         "reads it)")
    ap.add_argument("--metrics-prom", default=None,
                    help="write the Prometheus text exposition of the run's "
                         "metrics here")
    args = ap.parse_args(argv)

    if args.mode == "decode":
        if args.arch is None:
            ap.error("--arch is required in decode mode")
        cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
        try:
            refuse_encdec(cfg)
        except ValueError as e:
            ap.error(str(e))
        serve(cfg, batch=args.batch, requests=args.requests,
              max_new=args.max_new, horizon=args.horizon,
              page_tokens=args.page_tokens, backend=args.backend,
              compact_chain_len=args.compact_chain_len, device=args.device)
        return
    serve_kv(workloads=args.workloads, requests=args.requests,
             slots=args.slots, shards=args.shards,
             record_count=args.record_count,
             ops_per_request=args.ops_per_request, backend=args.backend,
             mesh_shards=args.mesh_shards, pipeline=args.pipeline,
             fused_tick=False if args.no_fused_tick else None,
             trace_out=args.trace_out,
             metrics_prom=args.metrics_prom, ranks=args.ranks,
             device=args.device)


if __name__ == "__main__":
    main()
