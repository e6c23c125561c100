#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port of HashMem on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, ``nvcc``
and CUDA PyTorch.  It imports only ``torch``, ``numpy`` and the port
(``src/repro_torch``), and:

  1. prints the card (``torch`` and ``nvidia-smi``);
  2. builds every kernel from ``src/repro_torch/kernels/csrc`` into
     ``build/repro_torch``, one ``nvcc`` per source, all at once;
  3. holds each CUDA kernel (``probe_perf``, ``probe_area``,
     ``probe_bitserial``) against its plain PyTorch version, bit for bit, on
     small and paper-shaped cases (one a displaced (Q, 9) schedule whose
     holes come from the fingerprint pre-pass, column 0 included), the
     bit-serial kernel also on the edges of its sector-by-sector walk, at
     key widths 1/4/8/13/16/31/32 and on planes that are not 16-byte
     aligned; and small tables (a ``perf`` one and a bit-serial one at
     key_bits=8; a displaced one with fingerprints and a stash in both; an
     extendible one that splits and doubles) built, mutated, grown and
     compacted on the card against the same tables on the CPU; and small
     serving engines (three shards, pipeline depth 2, YCSB A/B/E/F) on each
     backend and on a tiny table that grows at drain time, on the card
     against the CPU: equal results, schedules, metrics and tables;
  4. drives the ``perf`` path at PAPER_HASHMEM with the paper's workload:
     build 100M pairs, probe 10% of them, probe 1M held-back keys, insert
     those, delete 1M built keys, probe again, checking every found flag and
     value; then times ``probe_perf`` against its bound;
  5. drives the bit-serial path at PAPER_HASHMEM on the same 100M pairs:
     build with bit-planes, probe through ``bitserial``, ``area`` and
     ``perf``, insert, delete, compact, checking the planes after each
     write;
  6. times the three kernels at that path's shapes (``perf`` and ``area``
     in turns) against their bounds, traces one ``hashmap.probe`` through
     ``bitserial``;
  7. drives the displaced path at PAPER_HASHMEM with 12-bit fingerprints,
     displacement and a 256-entry stash on the same data: build through the
     displaced replay, probe, insert a burst of keys into one bucket (round
     2, H2 relocation, places what its direct page cannot take), insert the
     held-back keys, delete 1M keys with duplicate queries, compact; the
     fingerprint lane equals ``pack_fprints(keys)`` and every probe equals
     the expected map after every write; then rows activated per probe with
     fingerprints on and off, the end-to-end probe rate, each step of the
     probe alone, a trace split by step, and ``probe_perf`` on the filtered
     schedule against plain and its bound;
  8. serves YCSB A-F from six tenants at paper scale: 16M pairs each (96M
     in all) preloaded into one PAPER_HASHMEM ``perf`` table through
     ``engine.preload``, 2048 requests of 4 ops per tenant through 4096
     slots at pipeline depth 1 and, on a fresh engine, depth 2 (equal
     results and schedules), every result checked against the DictModel
     replay (``tests/model.py``), the trace checked by
     ``tools/trace_report.py``, ``probe_perf`` launched on every tick with a
     probe or delete phase and no synchronise in the issue path; reports
     ops/s, ticks, latency in ticks and ms, per-phase host time, device
     busy and idle share over a ``torch.profiler`` window, stalls, rows
     activated and peak memory; then the per-request baseline
     (``coalesce=False``) on 64 requests per tenant; prints the
     ``kernels`` line;
  9. prints the device line last.

Any failed check raises and the script exits non-zero.  Without a card, or
without the rest of the repo beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_BUILD = 100_000_000            # PAPER_WORKLOAD["num_pairs"]
N_HELD = 1_000_000               # generated beyond the build, inserted later
N_DELETE = 1_000_000
TIMED_RUNS = 7
KERNELS = ("probe_perf", "probe_area", "probe_bitserial")

# The card the port targets, the H100 SXM (NVIDIA data sheet): its memory
# rate in bytes/s, and its 67 TFLOP/s non-tensor float32 rate, which bounds
# the probes' 32-bit compares.  Memory moves in 32-byte sectors.
CARD = "H100 80GB HBM3"
HBM_RATE = 3.35e12
ALU32_RATE = 67e12
SECTOR = 32


def fail(msg: str):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        raise AssertionError(msg)


def sync():
    import torch
    torch.cuda.synchronize()


def cuda_ms(fn, runs: int):
    """Median milliseconds of ``runs`` calls, timed with CUDA events after
    one warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_s(fn):
    """(result, seconds) of ``fn`` on the host clock, ended by a sync."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def reset_launches(wrappers):
    for w in wrappers.values():
        w.launches = 0


def read_launches(wrappers):
    sync()
    return {name: w.launches for name, w in wrappers.items()}


def build_kernels(build):
    """One nvcc per source, all started together; then load each."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for f in [pool.submit(build.compile_source, n) for n in KERNELS]:
            f.result()
    for name in KERNELS:
        build.load(name)
    print(f"build: {', '.join(KERNELS)} built for sm_90a in "
          f"{time.perf_counter() - t0:.3f} s (in parallel)")
    for name in KERNELS:
        for line in build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# Synthetic probe cases (numpy, seeded)
# ---------------------------------------------------------------------------

def make_case(rng, P, S, Q, C, holes=0.0, fill=0.7, tombstones=0.05,
              key_bits=32):
    """A pool with unique keys (below 2**key_bits; with repeats where that
    space is small), tombstones and empty slots, and a schedule whose first
    half holds each query's page (hits) and whose second half is random
    pages (mostly misses); ``holes`` blanks that share of steps, never a
    hit's own page."""
    kp = np.full((P, S), 0xFFFFFFFF, np.uint32)
    vp = np.zeros((P, S), np.uint32)
    n = int(P * S * fill)
    space = min(max(2**key_bits - 2, 2), 0xFFFFFFF0)
    pos = rng.choice(P * S, size=n, replace=False)
    kp.reshape(-1)[pos] = rng.choice(space, size=n, replace=n > space)
    vp.reshape(-1)[pos] = rng.integers(0, 2**32, n, dtype=np.uint64)
    tomb = rng.choice(pos, size=int(n * tombstones), replace=False)
    kp.reshape(-1)[tomb] = 0xFFFFFFFE
    live = np.setdiff1d(pos, tomb)
    h = Q // 2
    hit = rng.choice(live, size=h)
    pages = rng.integers(0, P, (Q, C)).astype(np.int32)
    pages[rng.random((Q, C)) < holes] = -1
    col = rng.integers(0, C, h)
    pages[np.arange(h), col] = hit // S
    queries = np.concatenate([kp.reshape(-1)[hit],
                              rng.choice(space, Q - h).astype(np.uint32)])
    return kp, vp, queries.astype(np.uint32), pages


def to_card(kp, vp, queries, pages):
    import torch
    from repro_torch.core.layout import interleave
    pool = interleave(torch.from_numpy(kp.view(np.int32)),
                      torch.from_numpy(vp.view(np.int32))).cuda()
    return (pool, torch.from_numpy(queries.view(np.int32)).cuda(),
            torch.from_numpy(pages).cuda())


def kernel_cases():
    rng = np.random.default_rng(0)
    for P, S, Q, C in [(16, 128, 32, 1), (32, 256, 64, 4), (8, 512, 16, 2),
                       (64, 128, 128, 3)]:
        yield f"P{P}_S{S}_Q{Q}_C{C}", make_case(rng, P, S, Q, C)
    yield "interior_holes", make_case(rng, 64, 256, 4096, 6, holes=0.4)
    kp = np.full((4, 128), 0xFFFFFFFF, np.uint32)
    vp = np.arange(512, dtype=np.uint32).reshape(4, 128)
    kp[1, 5] = 42; kp[3, 77] = 42; kp[3, 9] = 42; kp[0, [100, 31, 64]] = 7
    yield "first_match_order", (kp, vp, np.array([42, 42, 7], np.uint32),
                                np.array([[1, 3], [3, 1], [-1, 0]], np.int32))
    kp2 = kp.copy(); kp2[1, :40] = np.arange(40) + 1000; kp2[3, 6] = 0xFFFFFFFE
    yield "sentinel_queries", (kp2, vp, np.array([0xFFFFFFFF, 0xFFFFFFFE,
                                                  0xFFFFFFF0], np.uint32),
                               np.array([[-1, 1], [1, 3], [2, 0]], np.int32))
    yield "page_past_pool", (kp, vp, np.array([42, 7], np.uint32),
                             np.array([[-1, 9], [7, -1]], np.int32))
    yield "odd_S200", make_case(rng, 48, 200, 2048, 3, holes=0.2)
    yield "strip_S64", make_case(rng, 32, 64, 2048, 3, holes=0.2)
    yield "words_S2048", make_case(rng, 16, 2048, 1024, 3, holes=0.2)
    kp3 = np.full((2, 512), 0xFFFFFFFF, np.uint32)
    vp3 = np.arange(1024, dtype=np.uint32).reshape(2, 512)
    kp3[0, [450, 300, 130, 200]] = 9; kp3[1, 3] = 9; kp3[1, [500, 129]] = 11
    yield "first_match_across_chunks", (
        kp3, vp3, np.array([9, 9, 11], np.uint32),
        np.array([[0, 1], [1, 0], [0, 1]], np.int32))
    yield "paper_shape_S512_C8", make_case(rng, 8192, 512, 1 << 18, 8,
                                           holes=0.6)
    yield "fp_filtered_S512_C9", fp_filtered_case(rng)


def fp_filtered_case(rng, P=4096, S=512, Q=1 << 16, C=9, fp_bits=12):
    """A (Q, max_chain + 1) schedule, the displaced probe's shape, whose
    holes come from the port's fingerprint pre-pass (run on the CPU): a
    random page survives only where its fingerprint lane holds a slot with
    the query's fingerprint, so most steps are -1, column 0 included."""
    import torch
    from repro_torch.core import hashmap
    from repro_torch.core.layout import empty_store, interleave, pack_fprints
    kp, vp, queries, pages = make_case(rng, P, S, Q, C)
    store = empty_store(P, S, 32, "cpu")
    store.pool = interleave(torch.from_numpy(kp.view(np.int32)),
                            torch.from_numpy(vp.view(np.int32)))
    store.fprints, store.fp_bits = pack_fprints(store.key_pages, fp_bits), \
        fp_bits
    kept = hashmap._fp_filter(store, queries, torch.from_numpy(pages)).numpy()
    check((kept[:, 0] == -1).any() and (kept[:, 0] >= 0).any()
          and (kept[:Q // 2] >= 0).any(axis=1).all(),
          "fingerprint pre-pass left no holes in column 0, or dropped a hit")
    return kp, vp, queries, kept


def sector_edges(S):
    """Edges of the bit-serial kernel's walk one 256-slot chunk (one 32-byte
    sector of each plane) at a time, on pages of random keys >= 1000:
    the only match at slot 255 or at 256; matches in both chunks of a row
    (the first wins); a hit on step 2 after a full-row miss on step 1, at
    the row's last slot or at slot 0; a query that matches nothing, with a
    page id past the pool.  Keys 101..107 are the queries."""
    rng = np.random.default_rng(S)
    kp = rng.integers(1000, 0xFFFFFFF0, (4, S), dtype=np.uint64)
    kp = kp.astype(np.uint32)
    vp = rng.integers(0, 2**32, (4, S), dtype=np.uint64).astype(np.uint32)
    kp[0, 255] = 101
    kp[0, 256] = 102
    kp[1, [S - 200, 100]] = 103
    kp[1, [256, 255]] = 104
    kp[2, 5] = 104
    kp[2, S - 1] = 105
    kp[2, 0] = 106
    queries = np.arange(101, 108, dtype=np.uint32)
    pages = np.array([[0, 1, 2], [0, -1, 1], [1, 0, -1], [-1, 1, 2],
                      [3, 2, 1], [3, 2, 0], [3, 9, 1]], np.int32)
    return kp, vp, queries, pages


def sector_edge_hits(S):
    """(page, slot) of each ``sector_edges(S)`` query's first match, or
    None."""
    return [(0, 255), (0, 256), (1, 100), (1, 255), (2, S - 1), (2, 0), None]


def bitserial_cases():
    """The bit-serial kernel's own cases, each (name, (kp, vp, queries,
    pages), key_bits): the sector edges at W = 16 and W = 64, then random
    tables at the paper's key widths 4/8/16/32 and at 1/13/31, the odd
    widths also with queries that differ from the keys above bit
    key_bits; then rows whose last 256-slot chunk is ragged, at key_bits
    32 and 13: S = 320 (W = 10, 4-byte loads, a chunk of two words) and
    S = 384 (W = 12, 16-byte loads, a chunk of four)."""
    for S in (512, 2048):
        yield f"sector_edges_S{S}", sector_edges(S), 32
    rng = np.random.default_rng(4)
    for b in (4, 8, 16, 32, 1, 13, 31):
        kp, vp, q, pages = make_case(rng, 64, 512, 8192, 4, holes=0.3,
                                     key_bits=b, fill=0.5)
        yield f"key_bits{b}", (kp, vp, q, pages), b
        if b in (1, 13, 31):
            yield (f"key_bits{b}_high_query_bits",
                   (kp, vp, q | np.uint32(1 << b), pages), b)
    rng = np.random.default_rng(5)
    for S in (320, 384):
        for b in (32, 13):
            yield (f"ragged_S{S}_key_bits{b}",
                   make_case(rng, 32, S, 2048, 3, holes=0.3, key_bits=b,
                             fill=0.5), b)


def misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary."""
    import torch
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    off = next(i for i in range(4) if (buf.data_ptr() + 4 * i) % 16 == 4)
    view = buf[off:off + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def compare(name, kernel, got, want):
    sync()
    bad = int((got != want).any(dim=1).sum())
    check(bad == 0, f"{kernel} != plain on {name}: {bad} rows differ")
    return f"{kernel} equal (found {int(got[:, 1].sum())})"


def check_kernel_cases(k, ref, pack_bitplanes, load_width):
    """Every kernel against its plain version on every case.  ``area``
    must refuse S = 200 (not a multiple of its 128-slot strip) and the
    bit-serial layout S = 200 (not whole 32-slot words).  Then the
    bit-serial cases (``bitserial_cases``; at key_bits = 32 through all
    three kernels), the sector edges also with their known hits and on a
    planes view that is not 16-byte aligned, which the kernel reads with
    4-byte loads."""
    for name, case in kernel_cases():
        pool, q, pages = to_card(*case)
        S = pool.shape[1]
        notes = [compare(name, "perf", k["probe_perf"](pool, q, pages),
                         ref.probe_pages_ref(pool, q, pages))]
        if S % min(128, S):
            try:
                k["probe_area"](pool, q, pages)
            except ValueError:
                notes.append("area refused")
            else:
                raise AssertionError(f"probe_area accepted S={S}")
        else:
            notes.append(compare(name, "area", k["probe_area"](pool, q, pages),
                                 ref.probe_pages_ref(pool, q, pages)))
        if S % 32:
            try:
                pack_bitplanes(pool[..., 0], 32)
            except ValueError:
                notes.append("bit-planes refused")
            else:
                raise AssertionError(f"pack_bitplanes accepted S={S}")
        else:
            planes = pack_bitplanes(pool[..., 0], 32)
            notes.append(compare(
                name, "bitserial",
                k["probe_bitserial"](planes, pool, q, pages, 32),
                ref.probe_bitplanes_ref(planes, pool, q, pages, 32))
                + f", {load_width(planes)}-byte loads")
        print(f"kernel_check {name}: Q={case[2].size}; " + "; ".join(notes))
    for name, case, b in bitserial_cases():
        pool, q, pages = to_card(*case)
        planes = pack_bitplanes(pool[..., 0], b)              # on the card
        want = ref.probe_bitplanes_ref(planes, pool, q, pages, b)
        got = k["probe_bitserial"](planes, pool, q, pages, b)
        notes = [compare(name, "bitserial", got, want)
                 + f", {load_width(planes)}-byte loads"]
        S = pool.shape[1]
        if b == 32:
            # area takes whole 128-slot strips only (refused above at S=200)
            for kname in ("probe_perf",) + (("probe_area",) if S % 128 == 0
                                            else ()):
                notes.append(compare(name, kname[6:], k[kname](pool, q, pages),
                                     ref.probe_pages_ref(pool, q, pages)))
        if name.startswith("sector_edges"):
            hits = [None if r[1] == 0 else (r[2], r[3])
                    for r in got.cpu().tolist()]
            check(hits == sector_edge_hits(S),
                  f"bitserial on {name}: hits {hits}")
            odd = misaligned(planes)
            width = load_width(odd)
            check(width == 4, f"misaligned planes took {width}-byte loads")
            notes.append(compare(name + "_misaligned", "bitserial",
                                 k["probe_bitserial"](odd, pool, q, pages, b),
                                 want) + f" on planes at data_ptr % 16 = "
                         f"{odd.data_ptr() % 16}, {width}-byte loads")
        print(f"kernel_check {name}: Q={case[2].size}, key_bits={b}; "
              + "; ".join(notes))


def compare_runs(runs, what):
    """Each run is (leaves after every step, outputs, extra); the card's
    must equal the CPU's: every leaf, every output tensor, the extra."""
    import torch
    (gs, go, gx), (cs, co, cx) = runs["cuda"], runs["cpu"]
    check(len(gs) == len(cs) and len(go) == len(co), f"{what}: runs differ")
    for i, (a, b) in enumerate(zip(gs, cs)):
        check(a.keys() == b.keys(), f"{what}: leaves differ at step {i}")
        for name in a:
            check(np.array_equal(a[name], b[name]),
                  f"{what}: {name} differs between card and CPU after "
                  f"step {i}")
    for i, (a, b) in enumerate(zip(go, co)):
        check(torch.equal(a, b), f"{what}: output {i} differs between card "
              f"and CPU")
    check(gx == cx, f"{what}: {gx} on the card, {cx} on the CPU")


def check_small_tables_vs_cpu(hashmap, HashMemConfig):
    """Small tables driven on the card and on the CPU, with equal leaves
    after every step (planes, fingerprints, stash and depths included) and
    equal masks, probes through every backend and events:

      * a perf table and a bit-serial table at key_bits=8, built, inserted
        into (with a valid mask), deleted from, grown, compacted and
        auto-grown;
      * a displaced table (fingerprints, displacement and a stash) in perf
        and in bit-serial at key_bits=8, S=32, filled with one-bucket keys
        so that the direct page, the H2 chain and the stash all take keys,
        then deleted from (duplicate queries), grown and compacted;
      * an extendible table driven by ``insert_auto`` until groups split
        and the directory doubles."""
    from repro_torch.core import hashing
    base = HashMemConfig(num_buckets=64, slots_per_page=128, overflow_pages=16,
                         max_chain=3, max_load_factor=0.6)
    rng = np.random.default_rng(1)
    keys = rng.choice(0xFFFFFFF0, 20_000, replace=False).astype(np.uint32)
    keys[:2000] = keys[2000:4000]                         # duplicates
    vals = rng.integers(0, 2**32, keys.size, dtype=np.uint64).astype(np.uint32)
    for cfg in (base, dataclasses.replace(base, backend="bitserial",
                                          key_bits=8)):
        runs = {dev: drive_chained(hashmap, cfg, keys, vals, dev)
                for dev in ("cuda", "cpu")}
        compare_runs(runs, f"small table {cfg.backend}")
        (steps, outs, events) = runs["cuda"]
        check(not bool(outs[0].all()), "small table: no insert was refused")
        print(f"small_table {cfg.backend} key_bits={cfg.key_bits}: build/"
              f"insert/delete/grow/compact/insert_auto and probes through "
              f"{'/'.join(backends_of(cfg))} on the card equal the CPU "
              f"(refused {int((~outs[0]).sum())}, deleted "
              f"{int(outs[1].sum())}, insert_auto events {events}, leaves "
              f"{'/'.join(steps[-1])})")

    dcfg = HashMemConfig(num_buckets=8, slots_per_page=32, overflow_pages=8,
                         max_chain=2, auto_grow=False, displacement=True,
                         fingerprint_bits=8, stash_slots=16)
    dkeys = (rng.choice(0xFFFFFFF0, 100, replace=False).astype(np.uint32),
             one_bucket_keys(hashing, 72, 8, 5, same_b2=True),
             one_bucket_keys(hashing, 40, 8, 2, same_b2=False),
             rng.choice(0xFFFFFFF0, 30).astype(np.uint32))
    for cfg in (dcfg, dataclasses.replace(dcfg, backend="bitserial",
                                          key_bits=8)):
        runs = {dev: drive_displaced(hashmap, cfg, dkeys, dev)
                for dev in ("cuda", "cpu")}
        compare_runs(runs, f"displaced table {cfg.backend}")
        steps, outs, classes = runs["cuda"]
        check(min(classes.values()) > 0, f"displaced table: a class took no "
              f"key: {classes}")
        print(f"small_displaced {cfg.backend} key_bits={cfg.key_bits}: "
              f"build/insert/delete (duplicate queries)/grow/compact, probes "
              f"through {'/'.join(backends_of(cfg))} and rows activated on "
              f"the card equal the CPU; classes after the insert {classes}; "
              f"leaves {'/'.join(steps[-1])}")

    ecfg = HashMemConfig(num_buckets=8, slots_per_page=4, overflow_pages=248,
                         max_chain=3, resize="extendible", max_load_factor=1.0)
    colliders = one_bucket_keys(hashing, 48, 8, 3, same_b2=False)
    runs = {dev: drive_extendible(hashmap, ecfg, colliders, dev)
            for dev in ("cuda", "cpu")}
    compare_runs(runs, "extendible table")
    steps, outs, events = runs["cuda"]
    check(events.get("splits", 0) > 0 and events.get("doublings", 0) > 0,
          f"extendible table: events {events}, want splits and doublings")
    print(f"small_extendible: insert_auto/delete/probe through "
          f"{'/'.join(backends_of(ecfg))} on the card equal the CPU; events "
          f"{events}; leaves {'/'.join(steps[-1])}")


def backends_of(cfg):
    return ("perf", "area", "ref") + (
        ("bitserial",) if cfg.backend == "bitserial" else ())


def one_bucket_keys(hashing, n, num_buckets, bucket, same_b2):
    """``n`` distinct keys whose H1 bucket is ``bucket``; with ``same_b2``
    their H2 bucket is the same one (displacement cannot move them), else
    never (it must)."""
    import torch
    cand = torch.arange(1, 1 << 22)
    b1 = hashing.hash_to_bucket(cand, num_buckets)
    b2 = hashing.hash_to_bucket2(cand, num_buckets)
    keys = cand[(b1 == bucket) & ((b2 == b1) == same_b2)][:n]
    check(keys.numel() == n, f"mined {keys.numel()} of {n} one-bucket keys")
    return keys.numpy().astype(np.uint32)


def drive_chained(hashmap, cfg, keys, vals, dev):
    steps, outs = [], []
    hm = hashmap.build(cfg, keys[:9000], vals[:9000], device=dev)
    steps.append(hashmap.to_numpy(hm))
    hm, ok = hashmap.insert(hm, keys[9000:14000], vals[9000:14000],
                            valid=np.arange(5000) % 7 != 0)
    steps.append(hashmap.to_numpy(hm))
    hm, found = hashmap.delete(hm, keys[::5])
    steps.append(hashmap.to_numpy(hm))
    hm = hashmap.grow(hm)
    steps.append(hashmap.to_numpy(hm))
    hm = hashmap.compact(hm)
    steps.append(hashmap.to_numpy(hm))
    events = {}
    hm, ok2 = hashmap.insert_auto(hm, keys[14000:], vals[14000:],
                                  events=events)
    steps.append(hashmap.to_numpy(hm))
    outs += [ok.cpu(), found.cpu(), ok2.cpu()]
    for backend in backends_of(cfg):
        v, f = hashmap.probe(hm, keys, backend=backend)
        outs += [v.cpu(), f.cpu()]
    return steps, outs, events


def placement_classes(hashmap, hm):
    """Live entries on their H1 bucket's direct page, elsewhere in the pool
    (an H2 page or an overflow page), and in the stash."""
    import torch
    from repro_torch.core.layout import EMPTY_BITS, TOMBSTONE_BITS, from_bits
    cfg = hm.config
    kp = hm.key_pages.reshape(-1)
    live = (kp != EMPTY_BITS) & (kp != TOMBSTONE_BITS)
    page = torch.nonzero(live).squeeze(1) // cfg.slots_per_page
    b1 = hashmap.hash_to_bucket(from_bits(kp[live]), cfg.num_buckets,
                                cfg.hash_fn, cfg.salt)
    direct = int((page == hm.bucket_head[b1]).sum())
    return {"direct": direct, "pool_elsewhere": int(live.sum()) - direct,
            "stash": hashmap.stats(hm)["stash_live"]}


def drive_displaced(hashmap, cfg, keys, dev):
    base, same, reloc, miss = keys
    queries = np.concatenate(keys)
    steps, outs = [], []

    def record(hm):
        steps.append(hashmap.to_numpy(hm))
        for backend in backends_of(cfg):
            v, f = hashmap.probe(hm, queries, backend=backend)
            outs.extend([v.cpu(), f.cpu()])
        for fp in (True, False):
            outs.append(hashmap.rows_activated_per_probe(hm, queries,
                                                         fp).cpu())

    hm = hashmap.build(cfg, base, base * np.uint32(3), device=dev)
    record(hm)
    new = np.concatenate([same, reloc])
    hm, ok = hashmap.insert(hm, new, new + np.uint32(7))
    outs.append(ok.cpu())
    classes = placement_classes(hashmap, hm)
    record(hm)
    dk = np.concatenate([same[::9], same[-6:], same[-6:-3], reloc[::7],
                         base[:5], miss[:3]])            # duplicate queries
    hm, found = hashmap.delete(hm, dk)
    outs.append(found.cpu())
    record(hm)
    hm = hashmap.grow(hm)
    record(hm)
    hm = hashmap.compact(hm)
    record(hm)
    return steps, outs, classes


def drive_extendible(hashmap, cfg, colliders, dev):
    rng = np.random.default_rng(17)
    hm = hashmap.create(cfg, device=dev)
    steps, outs, events = [], [], {}
    for step in range(8):
        ins = np.concatenate([rng.integers(1, 4000, 12, dtype=np.uint32),
                              colliders[6 * step:6 * (step + 1)]])
        vals = rng.integers(1, 2**20, ins.size, dtype=np.uint32)
        hm, ok = hashmap.insert_auto(hm, ins, vals, events=events)
        hm, found = hashmap.delete(hm, rng.integers(1, 4000, 4,
                                                    dtype=np.uint32))
        steps.append(hashmap.to_numpy(hm))
        outs += [ok.cpu(), found.cpu()]
        for backend in backends_of(cfg):
            v, f = hashmap.probe(hm, ins, backend=backend)
            outs += [v.cpu(), f.cpu()]
    return steps, outs, events


SPANS = ("probe.schedule", "probe.fp_filter", "probe.kernel", "probe.stash")


def profile_probe(probe, label: str = "hashmap.probe", top: int = 8):
    """Device time by kernel over one traced end-to-end probe call
    (torch.profiler), the device's busy share of that call's wall time, and
    the device time of the kernels that ran inside each of
    ``hashmap.probe_with_buckets``'s ``record_function`` ranges (``SPANS``),
    read from the ranges' windows on the device timeline.  The ranges' own
    device-side events are not kernels and count in no sum.  Returns (busy
    ms, wall ms, {span: ms, or None if the trace has no such window})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        probe()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6

    def on_device(e, annotation):
        return e.device_type == DeviceType.CUDA and \
            bool(getattr(e, "is_user_annotation", False)) == annotation

    evs = [e for e in prof.key_averages() if on_device(e, False)]
    busy_us = sum(e.self_device_time_total for e in evs)
    print(f"profile: traced {label} wall {wall_us / 1e3:.4f} ms, device "
          f"busy {busy_us / 1e3:.4f} ms ({busy_us / wall_us * 100:.1f}%), "
          f"{sum(e.count for e in evs)} device ops")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.4f} ms x{e.count:<3d} "
              f"{e.key[:90]}")
    events = prof.events()
    kernels = [e.time_range for e in events if on_device(e, False)]
    spans = {}
    for name in SPANS:
        windows = [e.time_range for e in events
                   if on_device(e, True) and e.name == name]
        spans[name] = sum(k.elapsed_us() for k in kernels if any(
            w.start <= k.start < w.end for w in windows)) / 1e3 \
            if windows else None
    return busy_us / 1e3, wall_us / 1e3, spans


# ---------------------------------------------------------------------------
# Bounds: what the probe needs, counted from this run's data
# ---------------------------------------------------------------------------

def walked(pages, out):
    """Found mask, and the number of valid schedule steps walked before
    each query's hit (all valid steps for a miss)."""
    import torch
    C = pages.shape[1]
    found = out[:, 1] != 0
    hit_col = (pages == out[:, 2:3]) & (pages >= 0) & found[:, None]
    first = torch.where(found, hit_col.to(torch.uint8).argmax(1), C)
    before = torch.arange(C, device=pages.device)[None, :] < first[:, None]
    return found, int(((pages >= 0) & before).sum())


def row_bound(pages, out, S, io_bytes):
    """perf and area: whole (key, value) rows for the steps before the hit,
    the hit row's slots up to the hit slot in whole sectors."""
    import torch
    found, rows = walked(pages, out)
    hit_slots = out[found, 3].to(torch.int64) + 1
    hit_bytes = int(((hit_slots * 8 + SECTOR - 1) // SECTOR * SECTOR).sum())
    nbytes = rows * S * 8 + hit_bytes + io_bytes
    ops = rows * S + int(hit_slots.sum())
    note = (f"{rows} whole rows + {hit_bytes / 1e9:.3f} GB of hit rows up to "
            f"the hit slot, mean slot {float(hit_slots.double().mean()):.1f}")
    return nbytes, ops, note


def plane_bound(pages, out, b, W, io_bytes):
    """bitserial: whole plane rows (b x W words) for the steps before the
    hit; on the hit step each plane up to the hit's word in whole sectors
    (a plane starts on a sector where W is a multiple of 8, as at the
    paper's W = 16), and one value sector."""
    import torch
    found, rows = walked(pages, out)
    hit_words = out[found, 3].to(torch.int64) // 32 + 1
    hit_bytes = int(((hit_words * 4 + SECTOR - 1) // SECTOR * SECTOR).sum()) \
        * b + int(found.sum()) * SECTOR
    nbytes = rows * b * W * 4 + hit_bytes + io_bytes
    ops = 2 * b * (rows * W + int(hit_words.sum()))   # xor + or per word
    note = (f"{rows} whole plane rows ({b}x{W} words) + {hit_bytes / 1e9:.3f}"
            f" GB of hit-step planes up to the hit word and values")
    return nbytes, ops, note


def bound_of(nbytes, ops):
    bytes_s, ops_s = nbytes / HBM_RATE, ops / ALU32_RATE
    return max(bytes_s, ops_s) * 1e3, ("bytes" if bytes_s >= ops_s
                                       else "operations")


def mismatch(out, plain):
    import torch
    diff = (out.to(torch.int64) & 0xFFFFFFFF) - (plain.to(torch.int64)
                                                 & 0xFFFFFFFF)
    return int((diff != 0).any(dim=1).sum()), int(diff.abs().max())


# ---------------------------------------------------------------------------
# The displaced path at paper scale
# ---------------------------------------------------------------------------

N_BURST = 4096                   # keys inserted into one H1 bucket at once
HOT_BUCKET = 0


def hot_bucket_keys(hashmap, cfg, n, taken):
    """``n`` keys whose H1 bucket is ``HOT_BUCKET`` and that are not in
    ``taken`` (an int64 tensor on the card), found by hashing a candidate
    range on the card, 2**26 keys at a time."""
    import torch
    got, lo = [], 0
    while sum(t.numel() for t in got) < n:
        check(lo < 0xFFFFFFF0, "candidate range exhausted")
        cand = torch.arange(lo, min(lo + (1 << 26), 0xFFFFFFF0),
                            device="cuda")
        cand = cand[hashmap.hash_to_bucket(cand, cfg.num_buckets, cfg.hash_fn,
                                           cfg.salt) == HOT_BUCKET]
        got.append(cand[~torch.isin(cand, taken)])
        lo += 1 << 26
    return torch.cat(got)[:n].cpu().numpy().astype(np.uint32)


def displaced_path(hashmap, k, ref, data, smi):
    """Phase 7: the fingerprint/displacement/stash config of
    ``benchmarks/kernel_bench.py`` on the paper's table, with the paper's
    workload.  Build through the displaced replay, probe, insert a burst of
    keys into one bucket (its direct page overflows, so H2 relocation runs),
    insert the held-back keys, delete 1M built keys with duplicate queries,
    probe, compact; the fingerprint lane equals ``pack_fprints`` of the
    keys and every result equals the expected map after every write.  Then
    the measurements.  Returns the launches of the path."""
    import torch
    from repro_torch.configs import PAPER_HASHMEM
    from repro_torch.core.hashing import as_u32
    from repro_torch.core.layout import pack_fprints
    probe_pages_perf = k["probe_perf"]
    keys, vals, held_k, held_v = (data[n] for n in
                                  ("keys", "vals", "held_k", "held_v"))
    probes, pidx, qd, qbits = (data[n] for n in
                               ("probes", "pidx", "qd", "qbits"))
    cfg = dataclasses.replace(PAPER_HASHMEM, displacement=True,
                              fingerprint_bits=12, stash_slots=256)
    fb = cfg.fingerprint_bits

    def invariant(hm, what):
        check(torch.equal(hm.store.fprints, pack_fprints(hm.key_pages, fb)),
              f"displaced {what}: fprints differ from pack_fprints(keys)")
        st = hashmap.stats(hm)
        check(st["stash_live"] == st["stash_fill"] == 0, f"displaced {what}: "
              f"stash {st['stash_live']} live, fill {st['stash_fill']}")
        return st

    def expect(hm, q, want_v, want_f, what):
        v, f = hashmap.probe(hm, q)
        f = f.cpu().numpy()
        check(np.array_equal(f, want_f), f"displaced {what}: "
              f"{int((f != want_f).sum())} found flags wrong")
        check(np.array_equal(v.cpu().numpy().astype(np.uint32)[f],
                             want_v[f]), f"displaced {what}: values wrong")

    torch.cuda.reset_peak_memory_stats()
    reset_launches(k)
    hd, build_s = host_s(lambda: hashmap.build(cfg, keys, vals))
    peaks = {"build": torch.cuda.max_memory_allocated() / 2**30}
    st = invariant(hd, "build")
    check(st["live_entries"] == N_BUILD, "displaced build dropped entries")
    check(int(hd.free_top) == cfg.num_buckets,
          "displaced build allocated overflow pages")
    print(f"d_build: {N_BUILD} pairs through the displaced replay in "
          f"{build_s:.3f} s; fprints {tuple(hd.store.fprints.shape)} = "
          f"{hd.store.fprints.numel() * 4 / 1e9:.3f} GB equal "
          f"pack_fprints(keys); stash {tuple(hd.store.stash.shape)} = "
          f"{hd.store.stash.numel() * 4} B, empty; no overflow page")
    expect(hd, probes, vals[pidx], np.ones(probes.size, bool), "probe")
    expect(hd, held_k, held_v, np.zeros(held_k.size, bool), "held probe")

    # a burst into one bucket: round 1 fills its direct page, round 2
    # places the rest at H2, the stash takes nothing
    taken = as_u32(np.concatenate([keys, held_k]), "cuda")
    burst = hot_bucket_keys(hashmap, cfg, N_BURST, taken)
    del taken
    burst_v = burst * np.uint32(5) + np.uint32(3)
    head = int(hd.bucket_head[HOT_BUCKET])
    fill0 = int(hd.page_fill[head])
    fills0 = hd.page_fill.clone()
    hd2, ok = hashmap.insert(hd, burst, burst_v)
    check(bool(ok.all()), "burst inserts refused")
    st = invariant(hd2, "burst insert")
    round1 = int(hd2.page_fill[head]) - fill0
    grew = int((hd2.page_fill != fills0).sum()) - 1
    round2 = N_BURST - round1
    check(round1 == cfg.slots_per_page - fill0 and round2 > 0,
          f"burst: round 1 placed {round1} of {cfg.slots_per_page - fill0}")
    expect(hd2, burst, burst_v, np.ones(N_BURST, bool), "burst probe")
    print(f"d_burst: {N_BURST} new keys of H1 bucket {HOT_BUCKET} (direct "
          f"page at {fill0} of {cfg.slots_per_page} slots): round 1 placed "
          f"{round1} on the direct page, round 2 placed {round2} at H2 "
          f"({grew} other pages grew, {int(hd2.free_top) - cfg.num_buckets} "
          f"overflow pages), the stash {st['stash_live']}; all found")
    del fills0

    hd2, ok = hashmap.insert(hd2, held_k, held_v)
    check(bool(ok.all()), f"{int((~ok).sum())} inserts refused")
    invariant(hd2, "insert")
    expect(hd2, held_k, held_v, np.ones(held_k.size, bool), "insert")
    dk = np.concatenate([keys[:N_DELETE], keys[:1000]])   # duplicate queries
    hd2, found = hashmap.delete(hd2, dk)
    check(bool(found.all()), f"{int((~found).sum())} deletes not found")
    st = invariant(hd2, "delete")
    check(st["tombstones"] == N_DELETE, "one tombstone per deleted key")

    alive = pidx >= N_DELETE

    def reprobe(hm, what):
        expect(hm, probes, vals[pidx], alive, what)
        expect(hm, held_k, held_v, np.ones(held_k.size, bool), what)
        expect(hm, burst, burst_v, np.ones(N_BURST, bool), what)
        expect(hm, keys[:N_DELETE], vals[:N_DELETE],
               np.zeros(N_DELETE, bool), what)

    reprobe(hd2, "after insert+delete")
    live = N_BUILD + N_BURST + N_HELD - N_DELETE
    peaks["probe, burst, insert, delete"] = \
        torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    hd3, compact_s = host_s(lambda: hashmap.compact(hd2))
    peaks["compact"] = torch.cuda.max_memory_allocated() / 2**30
    st = invariant(hd3, "compact")
    check(st["tombstones"] == 0 and st["live_entries"] == live,
          "compact: tombstones left or live count changed")
    reprobe(hd3, "after compact")
    path = read_launches(k)
    print(f"d_mutate: inserted {N_HELD} (all ok), deleted {N_DELETE} with "
          f"{dk.size - N_DELETE} duplicate queries (all found), compacted in "
          f"{compact_s:.3f} s; fprints equal pack_fprints(keys) and the stash "
          f"empty after every write; probes of built, held-back, burst and "
          f"deleted keys exact before and after compact; live {live}; "
          f"launches on the displaced path: {path}; peak device memory "
          + ", ".join(f"{n} {gib:.2f} GiB" for n, gib in peaks.items()))
    del hd2, hd3, found, ok

    # -- measurements on the built table --------------------------------------
    rows_act = {}
    for label, q in (("hits", qd), ("misses", as_u32(held_k, "cuda"))):
        for fp in (True, False):
            rows_act[label, fp] = float(
                hashmap.rows_activated_per_probe(hd, q, fp))
    p_miss = 1 - np.exp(-N_BUILD / cfg.num_buckets / 2**fb)
    check(abs(rows_act["hits", True] - 1) < 1e-4
          and abs(rows_act["hits", False] - 1) < 1e-4,
          f"hits read {rows_act} rows, want 1.0")
    check(1.99 < rows_act["misses", False] <= 2.0
          and abs(rows_act["misses", True] - 2 * p_miss) < 0.05,
          f"misses read {rows_act}, want 2.0 off and {2 * p_miss:.4f} on")
    print("rows_activated_per_probe: "
          + "; ".join(f"{lab} fingerprints {'on' if fp else 'off'} {r:.6f}"
                      for (lab, fp), r in rows_act.items())
          + f" (misses expected {2 * p_miss:.4f} on, 2.0 off)")

    b = hashmap.hash_to_bucket(qd, cfg.num_buckets, cfg.hash_fn, cfg.salt)
    sched = hashmap.resolve_pages_displaced(hd, qd, b)
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fpages = hashmap._fp_filter(hd.store, qd, sched)
    sync()
    fp_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    pool = hd.store.pool
    out = probe_pages_perf(pool, qbits, fpages)
    plain = ref.probe_pages_ref(pool, qbits, fpages)
    mis, _ = mismatch(out, plain)
    check(mis == 0, f"probe_perf != plain on {mis} displaced paper probes")
    io_bytes = qbits.numel() * 4 + fpages.numel() * 4 + out.numel() * 4
    nbytes, ops, note = row_bound(fpages, out, cfg.slots_per_page, io_bytes)
    bound_ms, bound_by = bound_of(nbytes, ops)
    steps = {
        "schedule": cuda_ms(lambda: hashmap.resolve_pages_displaced(hd, qd, b),
                            TIMED_RUNS),
        "fp_filter": cuda_ms(lambda: hashmap._fp_filter(hd.store, qd, sched),
                             TIMED_RUNS),
        "kernel": cuda_ms(lambda: probe_pages_perf(pool, qbits, fpages),
                          TIMED_RUNS),
        "stash": cuda_ms(lambda: hashmap.stash_probe(hd.store, qd),
                         TIMED_RUNS),
    }
    e2e = cuda_ms(lambda: hashmap.probe(hd, qd), TIMED_RUNS)
    print(f"d_timing: hashmap.probe end to end {e2e:.4f} ms = "
          f"{probes.size / e2e / 1e3:.1f} Mprobes/s (median of {TIMED_RUNS} "
          f"after warm-up); steps alone: "
          + ", ".join(f"{n} {ms:.4f} ms" for n, ms in steps.items())
          + f"; fingerprint pre-pass peak {fp_peak:.3f} GiB over its input; "
          f"build {build_s:.3f} s, compact {compact_s:.3f} s; card: {smi}")
    print(f"d_timing: probe_perf on the filtered (Q, {fpages.shape[1]}) "
          f"schedule {steps['kernel']:.4f} ms (equals plain, mismatches 0; "
          f"needs {note}; {nbytes / 1e9:.3f} GB); bound {bound_ms:.4f} ms "
          f"({bound_by}); {bound_ms / steps['kernel'] * 100:.1f}% of bound; "
          f"{int((fpages >= 0).sum())} pages survive the pre-pass of "
          f"{int((sched >= 0).sum())} in the schedule")
    busy, wall, spans = profile_probe(lambda: hashmap.probe(hd, qd),
                                      "hashmap.probe on the displaced table")
    rest = busy - sum(ms for ms in spans.values() if ms is not None)

    def share(ms):
        if ms is None:
            return "not in the trace"
        return f"{ms:.4f} ms ({ms / busy * 100:.1f}%)" if busy else \
            f"{ms:.4f} ms"

    print("d_profile: device time by range "
          + ", ".join(f"{n[6:]} {share(ms)}" for n, ms in spans.items())
          + f", the rest {share(rest)}; busy "
          f"{busy:.4f} of wall {wall:.4f} ms ({busy / wall * 100:.1f}%)")
    return path


# ---------------------------------------------------------------------------
# Serving: small engines on the card against the CPU, and the paper-scale
# request stream
# ---------------------------------------------------------------------------

SERVE_WORKLOADS = "ABCDEF"       # one tenant per YCSB core workload
SERVE_RECORDS = 16_000_000       # per tenant: 96M preloaded pairs in all
SERVE_REQUESTS = 2048            # per tenant, 4 ops each: 49,152 ops
SERVE_SLOTS = 4096
SERVE_BASELINE_REQUESTS = 64     # per tenant, through coalesce=False
SERVE_PROFILE = (4, 12)          # the profiled ticks [start, stop)
SERVE_SPANS = "tick,gather,probe,delete,insert,writeback"
POOL_COPY_MS = 0.1               # a 1.342 GB pool copy takes ~0.8 ms
CLOCK_KEYS = ("wall_seconds", "ops_per_sec", "request_latency_ms",
              "queue_ms", "service_ms", "tick_ms")


def serving_engine(serving, cfg, workloads, record_count, per_tenant, dev,
                   **kw):
    """An engine on ``dev`` with one tenant (a LoadGen of seed i) per
    workload letter, loaded through ``engine.preload``, and its requests.
    Returns (engine, requests, load seconds, {tenant id: preload values})."""
    reg = serving.TenantRegistry()
    gens = [serving.LoadGen(serving.WorkloadSpec(
        wl, record_count=record_count, ops_per_request=4),
        reg.register(f"tenant{i}-{wl}"), seed=i)
        for i, wl in enumerate(workloads)]
    eng = serving.ServingEngine(cfg, tenants=reg, record_schedule=True,
                                device=dev, **kw)
    vals = {}
    t0 = time.perf_counter()
    for g in gens:
        keys, v = g.preload_kv()
        eng.preload(keys, v, tenant=g.tenant)
        vals[g.tenant.tid] = v
    if eng.device.type == "cuda":
        sync()
    load_s = time.perf_counter() - t0
    return eng, [r for g in gens for r in g.requests(per_tenant)], load_s, \
        vals


def deterministic(eng, snap):
    """The engine's snapshot and stats without their clock fields."""
    snap = {k: v for k, v in snap.items() if k not in CLOCK_KEYS}
    snap["phase_ms"] = {k: v["count"] for k, v in snap["phase_ms"].items()}
    st = eng.stats()
    st["tenants"] = {n: {k: v for k, v in t.items()
                         if k not in ("queue_secs", "service_secs")}
                     for n, t in st["tenants"].items()}
    return snap, st


def engine_outcome(hashmap, eng, reqs, snap):
    return ([r.results for r in reqs], eng.schedule,
            deterministic(eng, snap),
            [hashmap.to_numpy(hm) for hm in eng.shards])


def check_small_engines_vs_cpu(serving, hashmap, HashMemConfig, k):
    """The same short LoadGen stream (YCSB A, B, E, F) through an engine on
    the card and one on the CPU, on three shards at pipeline depth 2, for
    each backend, and once on a tiny ``perf`` table that grows at drain
    time: equal results, schedules, deterministic metrics and table leaves.
    Returns the kernels' launches on the card's engines."""
    base = HashMemConfig(num_buckets=64, slots_per_page=64, overflow_pages=64,
                         max_chain=8)
    cases = [(b, dataclasses.replace(base, backend=b), "ABEF", 256)
             for b in ("ref", "perf", "area", "bitserial")]
    cases.append(("perf_grows", HashMemConfig(
        num_buckets=2, slots_per_page=8, overflow_pages=2, max_chain=2),
        "A", 64))
    reset_launches(k)
    for name, cfg, wls, records in cases:
        out = {}
        for dev in ("cuda", "cpu"):
            eng, reqs, _, _ = serving_engine(
                serving, cfg, wls, records, 16, dev, num_shards=3,
                max_slots=16, pipeline_depth=2)
            loaded = eng.grow_events
            eng.submit_all(reqs)
            out[dev] = engine_outcome(hashmap, eng, reqs, eng.run())
        (res, sched, det, leaves), cpu = out["cuda"], out["cpu"]
        check(res == cpu[0], f"small engine {name}: results differ")
        check(sched == cpu[1], f"small engine {name}: schedules differ")
        check(det == cpu[2], f"small engine {name}: metrics differ")
        check(len(leaves) == len(cpu[3]) and all(
            a.keys() == b.keys() and all(np.array_equal(a[n], b[n])
                                         for n in a)
            for a, b in zip(leaves, cpu[3])),
            f"small engine {name}: table leaves differ")
        if name == "perf_grows":
            check(loaded == 0 and eng.grow_events > 0,
                  f"small engine {name}: no drain-time grow")
        print(f"small_engine {name}: {len(reqs)} requests, {eng.ticks} "
              f"ticks, batch calls {eng.batch_calls}, grows "
              f"{eng.grow_events}; card equals CPU (results, schedule, "
              f"metrics, leaves of 3 shards)")
    launches = read_launches(k)
    for kname in KERNELS:
        check(launches[kname] > 0, f"the small engines never launched "
              f"{kname}")
    print(f"small_engines: launches on the card {launches}")
    return launches


def drive_stream(eng, kernel):
    """Tick ``eng`` until idle, then ``run()`` for its snapshot.  Records per
    tick the calls, ``kernel``'s launches and the synchronises the card saw
    (``torch.cuda.set_sync_debug_mode``), and the synchronises inside the
    issue of each tick's phases.  Returns (snapshot, wall seconds ended by
    a synchronise, per-tick records, issue synchronises per tick)."""
    import warnings

    import torch
    per_tick, issue = [], []
    orig = eng._issue
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def counted_issue(*args):
            n0 = len(caught)
            rec = orig(*args)
            issue.append(len(caught) - n0)
            return rec
        eng._issue = counted_issue
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sync()
            t0 = time.perf_counter()
            while not eng.pool.idle():
                n0, l0 = len(caught), kernel.launches
                eng.tick()
                per_tick.append((dict(eng.calls_last_tick),
                                 kernel.launches - l0, len(caught) - n0))
            snap = eng.run()
            sync()
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
            del eng._issue
    return snap, wall, per_tick, issue


def dict_model_replay(schedule, space, vals):
    """Replay ``schedule`` against tests/model.py's DictModel seeded with
    the preload values of the keys the schedule touches (the only keys it
    can ask about)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from model import DictModel, replay_schedule_against_model
    model = DictModel()
    touched = np.asarray(sorted({key for e in schedule for key in e[2]}),
                         np.uint32)
    tids, raw = space.unfold(touched)
    for key, tid, r in zip(touched, tids, raw):
        if r < SERVE_RECORDS:
            model.insert([key], [vals[int(tid)][r]], [True])
    replay_schedule_against_model(schedule, model)
    return touched.size


def device_profile(prof, wall_s, top=8):
    """Device busy ms over a profiler window, the idle share of its wall
    time, the kernels by device time, and the whole-pool copies: the
    device-to-device memcpys of more than ``POOL_COPY_MS`` each (count,
    ms each)."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key[:80])
            for e in sorted(evs, key=lambda e: -e.self_device_time_total)]
    copies = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
              if e.device_type == DeviceType.CUDA and "DtoD" in e.name]
    return busy_ms, 1.0 - busy_ms / (wall_s * 1e3), rows[:top], \
        [ms for ms in copies if ms > POOL_COPY_MS]


def serving_path(serving, hashmap, k, smi):
    """Phase 8: YCSB A-F from six tenants, each preloaded with 16M pairs
    (96M in all) into one PAPER_HASHMEM ``perf`` table through
    ``engine.preload``, served through 4096 slots at pipeline depth 1 and,
    on a fresh engine, at depth 2 (equal results and schedules), every
    result checked against the DictModel replay; both runs traced, their
    traces checked by tools/trace_report.py, and profiled by
    ``torch.profiler`` over the same window of ticks; then the per-request
    baseline on a third engine.  Returns the launches of the depth-1
    run."""
    import torch
    from repro_torch.configs import PAPER_HASHMEM
    cfg = PAPER_HASHMEM
    probe_perf = k["probe_perf"]
    out_dir = ROOT / "build" / "serving"
    out_dir.mkdir(parents=True, exist_ok=True)
    t_phase = time.perf_counter()
    runs = {}
    for depth in (1, 2):
        torch.cuda.reset_peak_memory_stats()
        kw = dict(max_slots=SERVE_SLOTS, pipeline_depth=depth,
                  trace=serving.Tracer(capacity=1 << 19))
        t0 = time.perf_counter()
        eng, reqs, load_s, vals = serving_engine(
            serving, cfg, SERVE_WORKLOADS, SERVE_RECORDS, SERVE_REQUESTS,
            None, **kw)
        gen_s = time.perf_counter() - t0 - load_s
        load_peak = torch.cuda.max_memory_allocated() / 2**30
        st = hashmap.stats(eng.shards[0])
        check(st["live_entries"] == len(SERVE_WORKLOADS) * SERVE_RECORDS,
              f"preload stored {st['live_entries']} pairs")
        print(f"serve_preload depth {depth}: {st['live_entries']} pairs of "
              f"{len(SERVE_WORKLOADS)} tenants through engine.preload in "
              f"{load_s:.3f} s; load {st['load_factor']:.4f} of "
              f"{st['capacity']} slots, max chain {st['max_chain']}; pool "
              f"{eng.shards[0].store.pool.numel() * 4 / 1e9:.3f} GB; "
              f"{len(reqs)} requests drawn in {gen_s:.3f} s; peak device "
              f"memory {load_peak:.2f} GiB")
        eng.profile_ticks(*SERVE_PROFILE, str(out_dir / f"depth{depth}"))
        reset_launches(k)
        torch.cuda.reset_peak_memory_stats()
        eng.submit_all(reqs)
        snap, wall, per_tick, issue = drive_stream(eng, probe_perf)
        launches = read_launches(k)
        runs[depth] = dict(
            results=[r.results for r in reqs], schedule=eng.schedule,
            det=deterministic(eng, snap), snap=snap, wall=wall,
            per_tick=per_tick, issue=issue, launches=launches,
            stats=eng.stats(), peak=torch.cuda.max_memory_allocated() / 2**30,
            profile=device_profile(eng.profiler, eng.profile_seconds),
            profile_ms=eng.profile_seconds * 1e3)
        path = out_dir / f"trace_depth{depth}.json"
        n_ev = eng.export_trace(str(path), workloads=SERVE_WORKLOADS)
        rep = subprocess.run(
            [sys.executable, str(ROOT / "tools" / "trace_report.py"),
             str(path), "--assert-spans", SERVE_SPANS],
            capture_output=True, text=True, timeout=600)
        check(rep.returncode == 0, f"trace_report refused the depth-{depth} "
              f"trace:\n{rep.stdout[-3000:]}{rep.stderr[-2000:]}")
        print(f"serve_trace depth {depth}: {n_ev} events (dropped "
              f"{eng.tracer.dropped}) accepted by trace_report.py "
              f"--assert-spans {SERVE_SPANS}")
        for line in rep.stdout.splitlines():
            if line.strip():
                print(f"  trace_report: {line}")
        if depth == 1:
            n_touched = dict_model_replay(eng.schedule, eng.tenants.space,
                                          vals)
            print(f"serve_check: every result of {len(reqs)} requests "
                  f"({snap['total_ops']} ops over {n_touched} keys) equals "
                  f"the DictModel replay")
        del eng, reqs, vals
    one, two = runs[1], runs[2]
    check(one["results"] == two["results"],
          "pipeline depth 2 changed a result")
    check(one["schedule"] == two["schedule"],
          "pipeline depth 2 changed the schedule")
    check({**one["det"][0], "phase_ms": None}
          == {**two["det"][0], "phase_ms": None},
          "pipeline depth 2 changed a deterministic metric")

    for depth, r in runs.items():
        snap, st = r["snap"], r["stats"]
        ticks = len(r["per_tick"])
        for i, (calls, launched, _) in enumerate(r["per_tick"]):
            want = calls["probe"] + calls["delete"]
            check(launched >= want,
                  f"depth {depth} tick {i}: {launched} probe_perf launches "
                  f"for {want} probe/delete calls")
        check(r["launches"]["probe_perf"] > 0, "phase 8 launched no probe")
        syncs = [s for _, _, s in r["per_tick"]]
        if sum(syncs) == 0:
            sync_note = "not measured (the debug mode reported none)"
        else:
            check(sum(r["issue"]) == 0, f"depth {depth}: the issue path "
                  f"synchronised {sum(r['issue'])} times")
            sync_note = (f"{sum(syncs) / ticks:.3f} a tick (max "
                         f"{max(syncs)}), 0 in the issue path")
        ph = snap["phase_ms"]
        print(f"serve_depth{depth}: {snap['total_ops']} ops of "
              f"{snap['requests_completed']} requests in {r['wall']:.3f} s = "
              f"{snap['total_ops'] / r['wall']:.1f} ops/s; {ticks} ticks, "
              f"{snap['ops_per_tick']:.2f} ops/tick; request latency "
              f"p50/p99 {snap['request_latency_ticks']['p50']:.0f}/"
              f"{snap['request_latency_ticks']['p99']:.0f} ticks, "
              f"{snap['request_latency_ms']['p50']:.3f}/"
              f"{snap['request_latency_ms']['p99']:.3f} ms; stalls "
              f"{st['pipeline']['stalls']}, grows {st['grow_events']}, "
              f"compactions {st['compact_events']}; rows activated per "
              f"probe mean {snap['rows_activated']['mean']:.4f}; after the "
              f"run max chain {st['shards'][0]['max_chain']}, tombstones "
              f"{st['shards'][0]['tombstones']}; "
              f"probe_perf launches {r['launches']['probe_perf']} = "
              f"{r['launches']['probe_perf'] / ticks:.3f} a tick; host "
              f"synchronises {sync_note}; peak device memory "
              f"{r['peak']:.2f} GiB")
        print(f"serve_phases_depth{depth} (host ms mean/p50/p99 x count): "
              + "; ".join(f"{n} {v['mean']:.3f}/{v['p50']:.3f}/"
                          f"{v['p99']:.3f} x{v['count']}"
                          for n, v in sorted(ph.items())))
    pool_bytes = 2 * cfg.num_pages * cfg.slots_per_page * 8
    for depth, r in runs.items():
        busy, idle, rows, copies = r["profile"]
        check(copies, f"depth {depth}: the profile holds no pool copy")
        print(f"serve_profile depth {depth}: ticks [{SERVE_PROFILE[0]}, "
              f"{SERVE_PROFILE[1]}) (torch.profiler): wall "
              f"{r['profile_ms']:.3f} ms, device busy {busy:.3f} ms, idle "
              f"share {idle * 100:.1f}%; whole-pool copies {len(copies)} = "
              f"{sum(copies):.3f} ms, {np.mean(copies):.4f} ms each "
              f"({pool_bytes / np.mean(copies) / 1e9:.2f} TB/s of "
              f"{pool_bytes / 1e9:.3f} GB read and written; bound "
              f"{pool_bytes / HBM_RATE * 1e3:.4f} ms)")
        for ms, count, key in rows:
            print(f"  {ms:9.3f} ms x{count:<5d} {key}")

    # the per-request baseline: one hashmap call per op
    eng, reqs, _, vals = serving_engine(
        serving, cfg, SERVE_WORKLOADS, SERVE_RECORDS,
        SERVE_BASELINE_REQUESTS, None, max_slots=SERVE_SLOTS, coalesce=False)
    eng.submit_all(reqs)
    sync()
    t0 = time.perf_counter()
    snap = eng.run()
    sync()
    wall = time.perf_counter() - t0
    dict_model_replay(eng.schedule, eng.tenants.space, vals)
    base_rate = snap["total_ops"] / wall
    rate = one["snap"]["total_ops"] / one["wall"]
    print(f"serve_per_request: {snap['total_ops']} ops of {len(reqs)} "
          f"requests through coalesce=False in {wall:.3f} s = "
          f"{base_rate:.1f} ops/s, {sum(eng.batch_calls.values())} hashmap "
          f"calls, results equal the DictModel replay; coalesced depth 1 / "
          f"per-request ops/s = {rate / base_rate:.2f}; card: {smi}")
    print(f"serve_time: phase 8 took {time.perf_counter() - t_phase:.3f} s")
    del eng, reqs, vals
    return one["launches"]


# ---------------------------------------------------------------------------
# Main paths at paper scale
# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the card and has no CPU mode")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}; run it "
             "from the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import serving
    from repro_torch.configs import PAPER_HASHMEM, HashMemConfig
    from repro_torch.core import hashmap
    from repro_torch.core.hashing import as_u32
    from repro_torch.core.layout import pack_bitplanes, to_bits
    from repro_torch.data.kv_synth import kv_dataset, probe_set
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.probe_area import probe_pages_area
    from repro_torch.kernels.probe_bitserial import (load_width,
                                                     probe_pages_bitserial)
    from repro_torch.kernels.probe_perf import probe_pages_perf
    k = {"probe_perf": probe_pages_perf, "probe_area": probe_pages_area,
         "probe_bitserial": probe_pages_bitserial}

    # -- 1. device -----------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} card(s))")
    print(smi)
    if CARD not in name:
        fail(f"card {name!r} is not the {CARD} whose rates bound the kernels")

    # -- 2. build --------------------------------------------------------------
    build_kernels(build)

    # -- 3. kernels against plain; card against CPU ------------------------------
    check_kernel_cases(k, ref, pack_bitplanes, load_width)
    check_small_tables_vs_cpu(hashmap, HashMemConfig)
    check_small_engines_vs_cpu(serving, hashmap, HashMemConfig, k)

    # -- 4. the perf path at PAPER_HASHMEM --------------------------------------
    cfg = PAPER_HASHMEM
    t0 = time.perf_counter()
    keys_all, vals_all = kv_dataset(N_BUILD + N_HELD)
    t1 = time.perf_counter()
    keys, vals = keys_all[:N_BUILD], vals_all[:N_BUILD]
    held_k, held_v = keys_all[N_BUILD:], vals_all[N_BUILD:]
    probes, pidx = probe_set(keys, 0.10)
    print(f"data: {N_BUILD + N_HELD} unique pairs in {t1 - t0:.3f} s and "
          f"{probes.size} probes in {time.perf_counter() - t1:.3f} s, made on "
          f"the host (numpy {np.__version__})")

    reset_launches(k)
    torch.cuda.reset_peak_memory_stats()
    hm, build_s = host_s(lambda: hashmap.build(cfg, keys, vals))
    mcl = hashmap.max_chain_len(hm)
    st = hashmap.stats(hm)
    pool_gb = hm.store.pool.numel() * 4 / 1e9
    print(f"main_build: {N_BUILD} pairs in {build_s:.3f} s (host->card copy "
          f"included); pool {tuple(hm.store.pool.shape)} = {pool_gb:.3f} GB; "
          f"max_chain_len {mcl}; overflow pages "
          f"{int(hm.free_top) - cfg.num_buckets}; live {st['live_entries']}; "
          f"load {st['load_factor']:.4f}")
    check(st["live_entries"] == N_BUILD, "build dropped entries")
    check(mcl <= cfg.max_chain, "chain past max_chain")

    v, f = hashmap.probe(hm, probes)
    check(bool(f.all()), f"{int((~f).sum())} built keys not found")
    check(np.array_equal(v.cpu().numpy().astype(np.uint32), vals[pidx]),
          "probe values differ from the dataset's")
    _, f = hashmap.probe(hm, held_k)
    check(not bool(f.any()), f"{int(f.sum())} never-inserted keys found")
    print(f"main_probe: {probes.size} built keys all found with their values; "
          f"{held_k.size} held-back keys none found")

    hm2, ok = hashmap.insert(hm, held_k, held_v)
    check(bool(ok.all()), f"{int((~ok).sum())} inserts refused")
    hm2, found = hashmap.delete(hm2, keys[:N_DELETE])
    check(bool(found.all()), f"{int((~found).sum())} deletes not found")
    _, f = hashmap.probe(hm2, keys[:N_DELETE])
    check(not bool(f.any()), f"{int(f.sum())} deleted keys still found")
    v, f = hashmap.probe(hm2, held_k)
    check(bool(f.all()) and np.array_equal(
        v.cpu().numpy().astype(np.uint32), held_v), "inserted keys wrong")
    v, f = hashmap.probe(hm2, probes)
    alive = pidx >= N_DELETE
    check(np.array_equal(f.cpu().numpy(), alive), "re-probe found flags wrong")
    check(np.array_equal(v.cpu().numpy().astype(np.uint32)[alive],
                         vals[pidx][alive]), "re-probe values wrong")
    perf_path = read_launches(k)
    st2 = hashmap.stats(hm2)
    print(f"main_mutate: inserted {held_k.size} (all ok), deleted {N_DELETE} "
          f"(all found); re-probe: deleted gone, inserted and untouched keys "
          f"return their values; live {st2['live_entries']}, tombstones "
          f"{st2['tombstones']}; launches on the perf path: {perf_path}")
    check(perf_path["probe_perf"] > 0, "the perf path never launched probe_perf")
    check(st2["live_entries"] == N_BUILD + N_HELD - N_DELETE, "live count")
    del hm2, v, f, found, ok

    qd = as_u32(probes, "cuda")
    qbits = to_bits(qd)
    pages = hashmap.resolve_pages(hm, qd)
    pool = hm.store.pool
    out = probe_pages_perf(pool, qbits, pages)
    plain = ref.probe_pages_ref(pool, qbits, pages)
    perf_mis, _ = mismatch(out, plain)
    check(perf_mis == 0, f"probe_perf != plain on {perf_mis} paper probes")
    io_bytes = qbits.numel() * 4 + pages.numel() * 4 + out.numel() * 4
    nbytes, ops, note = row_bound(pages, out, cfg.slots_per_page, io_bytes)
    perf_bound, perf_by = bound_of(nbytes, ops)
    kernel_ms = cuda_ms(lambda: probe_pages_perf(pool, qbits, pages),
                        TIMED_RUNS)
    perf_plain = cuda_ms(lambda: ref.probe_pages_ref(pool, qbits, pages), 3)
    e2e_ms = cuda_ms(lambda: hashmap.probe(hm, qd), TIMED_RUNS)
    print(f"timing: probe_perf {kernel_ms:.4f} ms for {probes.size} probes "
          f"(kernel equals plain, mismatches 0; needs {note}; "
          f"{nbytes / 1e9:.3f} GB in all, {nbytes / kernel_ms / 1e9:.2f} "
          f"TB/s); bound {perf_bound:.4f} ms ({perf_by}, "
          f"{HBM_RATE / 1e12:.2f} TB/s); {perf_bound / kernel_ms * 100:.1f}% "
          f"of bound; plain {perf_plain:.4f} ms")
    print(f"timing: hashmap.probe end to end (hash + chain walk + kernel) "
          f"{e2e_ms:.4f} ms = {probes.size / e2e_ms / 1e3:.1f} Mprobes/s; "
          f"build {build_s:.3f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; median of "
          f"{TIMED_RUNS} runs after warm-up; card: {smi}")
    profile_probe(lambda: hashmap.probe(hm, qd))
    del hm, pool, pages, out, plain

    # -- 5. the bit-serial path at PAPER_HASHMEM ---------------------------------
    bcfg = dataclasses.replace(PAPER_HASHMEM, backend="bitserial")
    three = ("bitserial", "area", "perf")
    torch.cuda.reset_peak_memory_stats()
    reset_launches(k)
    hb, bs_build_s = host_s(lambda: hashmap.build(bcfg, keys, vals))
    check(torch.equal(hb.planes, pack_bitplanes(hb.key_pages, 32)),
          "built planes differ from pack_bitplanes(pool)")
    st = hashmap.stats(hb)
    check(st["live_entries"] == N_BUILD, "bit-serial build dropped entries")
    planes_gb = hb.planes.numel() * 4 / 1e9
    print(f"bs_build: {N_BUILD} pairs in {bs_build_s:.3f} s; pool "
          f"{hb.store.pool.numel() * 4 / 1e9:.3f} GB + planes "
          f"{tuple(hb.planes.shape)} = {planes_gb:.3f} GB; planes equal "
          f"pack_bitplanes(pool)")

    lanes = {}
    for backend in three:
        v, f = hashmap.probe(hb, probes, backend=backend)
        check(bool(f.all()), f"{backend}: {int((~f).sum())} built keys lost")
        check(np.array_equal(v.cpu().numpy().astype(np.uint32), vals[pidx]),
              f"{backend}: probe values differ from the dataset's")
        lanes[backend] = v
        _, f = hashmap.probe(hb, held_k, backend=backend)
        check(not bool(f.any()), f"{backend}: {int(f.sum())} held keys found")
    check(torch.equal(lanes["bitserial"], lanes["area"])
          and torch.equal(lanes["area"], lanes["perf"]),
          "backends disagree on the paper probes")
    print(f"bs_probe: {probes.size} built keys found with their values "
          f"through {'/'.join(three)} (equal results); {held_k.size} held-back "
          f"keys found by none")

    hb2, ok = hashmap.insert(hb, held_k, held_v)
    check(bool(ok.all()), f"bit-serial: {int((~ok).sum())} inserts refused")
    hb2, found = hashmap.delete(hb2, keys[:N_DELETE])
    check(bool(found.all()), f"bit-serial: {int((~found).sum())} deletes lost")
    check(torch.equal(hb2.planes, pack_bitplanes(hb2.key_pages, 32)),
          "planes out of step with the keys after insert and delete")

    def reprobe(table, what):
        for backend in three:
            v, f = hashmap.probe(table, probes, backend=backend)
            check(np.array_equal(f.cpu().numpy(), alive),
                  f"{what} {backend}: found flags wrong")
            check(np.array_equal(v.cpu().numpy().astype(np.uint32)[alive],
                                 vals[pidx][alive]),
                  f"{what} {backend}: values wrong")
            v, f = hashmap.probe(table, held_k, backend=backend)
            check(bool(f.all()) and np.array_equal(
                v.cpu().numpy().astype(np.uint32), held_v),
                f"{what} {backend}: inserted keys wrong")
            _, f = hashmap.probe(table, keys[:N_DELETE], backend=backend)
            check(not bool(f.any()), f"{what} {backend}: deleted keys found")

    reprobe(hb2, "after insert+delete")
    st2 = hashmap.stats(hb2)
    print(f"bs_mutate: inserted {held_k.size} (all ok), deleted {N_DELETE} "
          f"(all found); planes equal pack_bitplanes(pool); re-probe through "
          f"{'/'.join(three)} exact; tombstones {st2['tombstones']}")
    hb3, compact_s = host_s(lambda: hashmap.compact(hb2))
    st3 = hashmap.stats(hb3)
    check(st3["tombstones"] == 0, "compact left tombstones")
    check(st3["live_entries"] == N_BUILD, "compact changed the live count")
    check(torch.equal(hb3.planes, pack_bitplanes(hb3.key_pages, 32)),
          "planes not re-packed by compact")
    reprobe(hb3, "after compact")
    bs_path = read_launches(k)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"bs_compact: {compact_s:.3f} s; tombstones 0, live "
          f"{st3['live_entries']}, planes re-packed, re-probe exact; "
          f"launches on the bit-serial path: {bs_path}; peak device memory "
          f"{peak:.2f} GiB")
    for kname in KERNELS:
        check(bs_path[kname] > 0, f"the bit-serial path never launched {kname}")
    del hb2, hb3, lanes, v, f, ok, found

    # -- 6. the three kernels at the bit-serial path's shapes ---------------------
    pool, planes = hb.store.pool, hb.planes
    pages = hashmap.resolve_pages(hb, qd)
    S, W = bcfg.slots_per_page, planes.shape[2]
    calls = {
        "probe_perf": lambda: probe_pages_perf(pool, qbits, pages),
        "probe_area": lambda: probe_pages_area(pool, qbits, pages),
        "probe_bitserial": lambda: probe_pages_bitserial(planes, pool, qbits,
                                                         pages, 32),
    }
    plains = {
        "probe_perf": lambda: ref.probe_pages_ref(pool, qbits, pages),
        "probe_bitserial": lambda: ref.probe_bitplanes_ref(planes, pool,
                                                           qbits, pages, 32),
    }
    plains["probe_area"] = plains["probe_perf"]
    rows, outs = {}, {}
    for kname in KERNELS:
        out, plain = calls[kname](), plains[kname]()
        mis, err = mismatch(out, plain)
        check(mis == 0, f"{kname} != plain on {mis} paper probes")
        outs[kname] = out
        if kname == "probe_bitserial":
            nbytes, ops, note = plane_bound(pages, out, 32, W, io_bytes)
            # the same walk if every plane of the hit row is read whole
            hit, walked_rows = walked(pages, out)
            whole_rows = (walked_rows + int(hit.sum())) * 32 * W * 4 \
                + int(hit.sum()) * SECTOR + io_bytes
        else:
            nbytes, ops, note = row_bound(pages, out, S, io_bytes)
        bound_ms, bound_by = bound_of(nbytes, ops)
        rows[kname] = dict(mismatches=mis, max_abs_err=err, bound_ms=bound_ms,
                           bound_by=bound_by, nbytes=nbytes, note=note)
    check(all(torch.equal(outs[n], outs["probe_perf"]) for n in KERNELS),
          "the three kernels' lanes differ on the paper probes")
    del outs, out, plain
    turns = [("probe_perf", cuda_ms(calls["probe_perf"], TIMED_RUNS)),
             ("probe_area", cuda_ms(calls["probe_area"], TIMED_RUNS)),
             ("probe_area", cuda_ms(calls["probe_area"], TIMED_RUNS)),
             ("probe_perf", cuda_ms(calls["probe_perf"], TIMED_RUNS))]
    print("timing turns (perf, area, area, perf): "
          + ", ".join(f"{n} {ms:.4f} ms" for n, ms in turns))
    for kname in ("probe_perf", "probe_area"):
        rows[kname]["ms"] = float(np.mean([ms for n, ms in turns
                                           if n == kname]))
    rows["probe_bitserial"]["ms"] = cuda_ms(calls["probe_bitserial"],
                                            TIMED_RUNS)
    plain_rows = cuda_ms(plains["probe_perf"], 3)
    rows["probe_perf"]["plain_ms"] = rows["probe_area"]["plain_ms"] = plain_rows
    rows["probe_bitserial"]["plain_ms"] = cuda_ms(plains["probe_bitserial"], 3)
    for kname in KERNELS:
        r = rows[kname]
        print(f"timing: {kname} {r['ms']:.4f} ms for {probes.size} probes "
              f"(kernel equals plain, mismatches 0; needs {r['note']}; "
              f"{r['nbytes'] / 1e9:.3f} GB in all, "
              f"{r['nbytes'] / r['ms'] / 1e9:.2f} TB/s); bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{HBM_RATE / 1e12:.2f} TB/s); "
              f"{r['bound_ms'] / r['ms'] * 100:.1f}% of bound; plain "
              f"{r['plain_ms']:.4f} ms; launches on the bit-serial path "
              f"{bs_path[kname]}")
    print(f"timing: probe_bitserial if each plane of the hit row is read "
          f"whole: {whole_rows / 1e9:.3f} GB, "
          f"{whole_rows / rows['probe_bitserial']['ms'] / 1e9:.2f} TB/s")
    print(f"timing: area/perf kernel time ratio on this card "
          f"{rows['probe_area']['ms'] / rows['probe_perf']['ms']:.4f}; "
          f"card: {smi}")
    for backend in three:
        e2e = cuda_ms(lambda: hashmap.probe(hb, qd, backend=backend),
                      TIMED_RUNS)
        print(f"timing: hashmap.probe[{backend}] on the bit-serial table end "
              f"to end {e2e:.4f} ms = {probes.size / e2e / 1e3:.1f} Mprobes/s")
    profile_probe(lambda: hashmap.probe(hb, qd, backend="bitserial"),
                  "hashmap.probe[bitserial]")
    print(f"bs_cost: pool {hb.store.pool.numel() * 4 / 1e9:.3f} GB + planes "
          f"{planes_gb:.3f} GB; build {bs_build_s:.3f} s; compact "
          f"{compact_s:.3f} s; peak device memory {peak:.2f} GiB")
    del hb, pool, planes, pages, calls, plains

    # -- 7. the displaced path at PAPER_HASHMEM ---------------------------------
    data = dict(keys=keys, vals=vals, held_k=held_k, held_v=held_v,
                probes=probes, pidx=pidx, qd=qd, qbits=qbits)
    d_path = displaced_path(hashmap, k, ref, data, smi)
    del data, qd, qbits

    # -- 8. serving at paper scale ----------------------------------------------
    s_path = serving_path(serving, hashmap, k, smi)

    replaces = {"probe_perf": "src/repro/kernels/probe_perf.py:34",
                "probe_area": "src/repro/kernels/probe_area.py:32",
                "probe_bitserial": "src/repro/kernels/probe_bitserial.py:36"}
    check(d_path["probe_perf"] > 0,
          "the displaced path never launched probe_perf")
    check(s_path["probe_perf"] > 0,
          "the serving path never launched probe_perf")
    launches = {"probe_perf": perf_path["probe_perf"],
                "probe_area": bs_path["probe_area"],
                "probe_bitserial": bs_path["probe_bitserial"]}
    print(json.dumps({"kernels": [{
        "name": kname, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{kname}.cu",
        "replaces": replaces[kname], "launches": launches[kname],
        "max_abs_err": rows[kname]["max_abs_err"],
        "mismatches": rows[kname]["mismatches"],
        "ms": rows[kname]["ms"], "kernel_ms": rows[kname]["ms"],
        "plain_ms": rows[kname]["plain_ms"],
        "bound_ms": rows[kname]["bound_ms"],
        "bound_by": rows[kname]["bound_by"], "library_ms": None}
        for kname in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
