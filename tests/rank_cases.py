"""What each rank of a spawned ``torch.distributed`` world runs for
``tests/test_torch_rlu_ranks.py`` and ``tests/test_torch_serving_ranks.py``.
The functions take the rank's ``RankMesh`` first (``launch.mesh.
spawn_ranks`` calls them in a new process) and import no JAX, so a rank
starts in a second or two."""
import numpy as np

from repro_torch.configs import HashMemConfig
from repro_torch.core import hashmap as thm
from repro_torch.core import rlu as trlu
from repro_torch.distributed.sharding import shard_stacked_hashmem
from repro_torch.launch.mesh import sub_mesh

from rlu_cases import case_inputs, past_pool

TICK_KEYS = ("v", "f", "df", "ok")


def below_need(q, cfg, D, sb) -> int:
    """A routing cap one below the measured need of batch ``q`` (at least
    1): an overflowing destination drops its last entries."""
    return max(1, trlu.routing_cap(q, cfg, D, sb, quantum=1) - 1)


def phase_caps(pq, dq, ik, cfg, D, sb):
    """{name: (probe, delete, insert) caps}: the worst case (None), the
    measured need and one below it."""
    qs = (pq, dq, ik)
    return {"none": (None, None, None),
            "need": tuple(trlu.routing_cap(q, cfg, D, sb) for q in qs),
            "below": tuple(below_need(q, cfg, D, sb) for q in qs)}


def run_case(mesh, hs, name, D, block, place):
    """Every routed phase of case ``name`` on ``hs`` (the stacked table on a
    ServingMesh, the rank's shard on a RankMesh), ``block(x)`` taking what
    this process passes of a whole batch and ``place`` taking a stacked CPU
    table to the mesh.  Returns {key: array}: outputs in the process's
    batch order, and leaves after each write phase."""
    cfg, sb, keys, vals, pq, dq, ik, iv = case_inputs(name)
    out = {}

    def leaves(pre, hm):
        for n, a in thm.to_numpy(hm).items():
            out[f"{pre}/{n}"] = a

    if name == "past_pool":
        full = trlu.build_sharded(cfg, keys, vals, D, sb, device="cpu")
        lv, pq, dq = past_pool(thm.to_numpy(full), cfg, sb, pq, dq)
        hs = place(thm.from_numpy(cfg, lv, device="cpu"))
    for cname, caps in phase_caps(pq, dq, ik, cfg, D, sb).items():
        v, f = trlu.probe_sharded(mesh, hs, block(pq), cfg, cap=caps[0],
                                  shard_by=sb)
        out[f"probe_{cname}/v"], out[f"probe_{cname}/f"] = v, f
        hs2, df = trlu.delete_sharded(mesh, hs, block(dq), cfg, cap=caps[1],
                                      shard_by=sb)
        out[f"delete_{cname}/f"] = df
        leaves(f"delete_{cname}", hs2)
        hs3, ok = trlu.insert_mesh(mesh, hs2, block(ik), block(iv), cfg,
                                   cap=caps[2], shard_by=sb)
        out[f"insert_{cname}/ok"] = ok
        leaves(f"insert_{cname}", hs3)
        hs4, *res = trlu.tick_mesh(mesh, hs, block(pq), block(dq), block(ik),
                                   block(iv), cfg, caps=caps, shard_by=sb)
        for k, a in zip(TICK_KEYS, res):
            out[f"tick_{cname}/{k}"] = a
        leaves(f"tick_{cname}", hs4)
    return {k: (v.cpu().numpy() if hasattr(v, "numpy") else v)
            for k, v in out.items()}


def rlu_cases_rank(mesh, names):
    """Every ``CASES`` table on this rank: its shard from the ranked
    ``build_sharded`` (leaves under ``{name}/build``), then ``run_case``."""
    D, r = mesh.num_shards, mesh.rank

    def block(x):
        n = x.size // D
        return x[r * n:(r + 1) * n]
    out = {}
    for name in names:
        cfg, sb, keys, vals, *_ = case_inputs(name)
        hs = trlu.build_sharded(cfg, keys, vals, D, sb, mesh=mesh)
        for n, a in thm.to_numpy(hs).items():
            out[f"{name}/build/{n}"] = a
        res = run_case(mesh, hs, name, D, block,
                       lambda full: shard_stacked_hashmem(mesh, full))
        out.update({f"{name}/{k}": v for k, v in res.items()})
    return out


def grow_case():
    """A batch far past every shard's capacity (rebuild growth), as
    ``tests/test_torch_rlu.py`` forces it: (cfg, build keys, inserted
    keys)."""
    cfg = HashMemConfig(num_buckets=4, slots_per_page=32, overflow_pages=4,
                        max_chain=3, backend="perf", auto_grow=True)
    rng = np.random.default_rng(17)
    k0 = rng.choice(2**30, 64, replace=False).astype(np.uint32)
    k1 = np.setdiff1d(rng.choice(2**30, 1500, replace=False)
                      .astype(np.uint32), k0)
    return cfg, k0, k1


def extendible_case():
    """Two batches of 48 keys into 2 ``highbits`` shards of an extendible
    table: local splits and a synchronized doubling."""
    cfg = HashMemConfig(num_buckets=4, slots_per_page=4, overflow_pages=60,
                        max_chain=2, backend="ref", auto_grow=True,
                        resize="extendible", max_load_factor=1.0)
    rng = np.random.default_rng(9)
    keys = rng.choice(0xFFFFFFF0, 96, replace=False).astype(np.uint32)
    return cfg, [keys[:48], keys[48:]]


def insert_sharded_rank(mesh, kind):
    """``insert_sharded`` over the ranks: "grow" (built, then one batch
    past capacity) or "extendible" (two batches).  Returns per step (ok,
    cfg' as a dict, events so far, the rank's leaves)."""
    import dataclasses
    D = mesh.num_shards
    steps, ev = [], {}
    if kind == "grow":
        cfg, k0, k1 = grow_case()
        hs = trlu.build_sharded(cfg, k0, k0 * 2, D, mesh=mesh)
        batches, sb = [(k1, k1 * 2)], "mod"
    else:
        cfg, kb = extendible_case()
        hs = thm.stack([thm.create(cfg, device=mesh.device)])
        batches, sb = [(k, k + 1) for k in kb], "highbits"
    for k, v in batches:
        hs, ok, cfg = trlu.insert_sharded(hs, k, v, cfg, D, shard_by=sb,
                                          events=ev, mesh=mesh)
        steps.append((ok.cpu().numpy(), dataclasses.asdict(cfg), dict(ev),
                      thm.to_numpy(hs)))
    return steps


def stacked_case(name, D):
    """``run_case`` on the stacked backend on the CPU, whole batches: what
    the concatenated rank outputs must equal."""
    from repro_torch.launch.mesh import make_serving_mesh
    cfg, sb, keys, vals, *_ = case_inputs(name)
    hs = trlu.build_sharded(cfg, keys, vals, D, sb, device="cpu")
    return run_case(make_serving_mesh(D, device="cpu"), hs, name, D,
                    lambda x: x, lambda full: full)


def rlu_world(mesh, names, names2):
    """What one rank of the test world of 4 runs: the ``CASES`` tables
    ``names`` and ``insert_sharded`` with growth; then, on the first two
    ranks as a mesh of their own (``sub_mesh``), the tables ``names2`` and
    ``insert_sharded`` with extendible splits.  Returns {shards: {"cases":
    ..., "insert": ...}}."""
    two = sub_mesh(mesh, 2)
    out = {4: {"cases": rlu_cases_rank(mesh, names),
               "insert": insert_sharded_rank(mesh, "grow")}}
    if two is not None:
        out[2] = {"cases": rlu_cases_rank(two, names2),
                  "insert": insert_sharded_rank(two, "extendible")}
    return out


# ---------------------------------------------------------------------------
# The serving engine over ranks
# ---------------------------------------------------------------------------

ENGINE_VARIANTS = {"fused_d1": {}, "fused_d2": dict(pipeline_depth=2),
                   "unfused_d1": dict(fused_tick=False),
                   "unfused_d2": dict(fused_tick=False, pipeline_depth=2)}
ENGINE_CASES = ([f"{b}_{v}" for b in ("perf", "bitserial")
                 for v in ENGINE_VARIANTS]
                + ["per_request", "grows", "extendible"])
CLOCK_KEYS = ("wall_seconds", "ops_per_sec", "request_latency_ms",
              "queue_ms", "service_ms", "tick_ms", "phase_ms")


def engine_case(name):
    """(cfg, request streams, preload pairs or None, engine kwargs) of one
    serving case: a zipfian-contended stream on a ``perf`` or
    ``bitserial`` table under each fused/unfused, depth 1/2 variant; the
    per-request baseline; a tiny table that grows and an extendible one
    that splits, both under insert-heavy streams at depth 2."""
    from model import make_engine_schedule, make_insert_heavy_schedule
    if name in ("grows", "extendible"):
        ext = name == "extendible"
        cfg = HashMemConfig(num_buckets=4, slots_per_page=4,
                            overflow_pages=60 if ext else 8, max_chain=2,
                            backend="ref", auto_grow=True,
                            max_load_factor=1.0 if ext else 0.95,
                            resize="extendible" if ext else "rebuild")
        streams = make_insert_heavy_schedule(
            9 if ext else 5, n_requests=48, ops_per_request=3, keyspace=96,
            zipf_theta=0.6 if ext else 0.0)
        return cfg, streams, None, dict(pipeline_depth=2)
    backend, _, variant = name.partition("_")
    kw = dict(coalesce=False) if name == "per_request" \
        else ENGINE_VARIANTS[variant]
    cfg = HashMemConfig(num_buckets=16, slots_per_page=32,
                        overflow_pages=32, max_chain=4,
                        backend="perf" if name == "per_request" else backend)
    streams = make_engine_schedule(1, n_requests=16, ops_per_request=3,
                                   keyspace=48, zipf_theta=0.99)
    rng = np.random.default_rng(1)
    pk = rng.choice(48, 16, replace=False).astype(np.uint32)
    pv = rng.integers(1, 2**30, 16).astype(np.uint32)
    return cfg, streams, (pk, pv), kw


def run_engine_case(name, mesh, device):
    """One case through ``ServingEngine(mesh=mesh)``: (results, schedule,
    snapshot and stats without their clock fields, this process's leaves,
    batch calls)."""
    from repro_torch.serving import Request, ServingEngine
    cfg, streams, preload, kw = engine_case(name)
    eng = ServingEngine(cfg, mesh=mesh, max_slots=8, record_schedule=True,
                        device=device, **kw)
    if preload is not None:
        eng.preload(*preload)
    reqs = [Request(ops=list(ops)) for ops in streams]
    eng.submit_all(reqs)
    snap = eng.run()
    snap = {k: v for k, v in snap.items() if k not in CLOCK_KEYS}
    st = eng.stats()
    return ([r.results for r in reqs], eng.schedule, snap, st,
            thm.to_numpy(eng.backend.hm_stacked), dict(eng.batch_calls))


def serving_world(mesh, names):
    """Every serving case on the world of 4, then on its first two ranks
    (``sub_mesh``): {shards: {case: outcome}}."""
    two = sub_mesh(mesh, 2)
    out = {4: {n: run_engine_case(n, mesh, mesh.device) for n in names}}
    if two is not None:
        out[2] = {n: run_engine_case(n, two, two.device) for n in names}
    return out


def fail_on_rank_one(mesh):
    """A rank function that raises on rank 1 after a collective."""
    import torch
    import torch.distributed as dist
    t = torch.ones(1)
    dist.all_reduce(t)
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return float(t)
