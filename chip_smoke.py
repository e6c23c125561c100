#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port of HashMem on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, ``nvcc``
and CUDA PyTorch.  It imports only ``torch``, ``numpy`` and the port
(``src/repro_torch``), and:

  1. prints the card (``torch`` and ``nvidia-smi``);
  2. builds every kernel from ``src/repro_torch/kernels/csrc`` into
     ``build/repro_torch``;
  3. holds the CUDA ``probe_perf`` kernel against its plain PyTorch version,
     bit for bit, on small and paper-shaped cases, and a small table built
     and mutated on the card against the same table on the CPU;
  4. drives the main path at PAPER_HASHMEM with the paper's workload: build
     100M pairs, probe 10% of them, probe 1M held-back keys, insert those,
     delete 1M built keys, probe again, checking every found flag and value;
  5. times the kernel at the main path's shapes against its bound, the plain
     version and the end-to-end probe rate, and prints the ``kernels`` line;
  6. prints the device line last.

Any failed check raises and the script exits non-zero.  Without a card, or
without the rest of the repo beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_BUILD = 100_000_000            # PAPER_WORKLOAD["num_pairs"]
N_HELD = 1_000_000               # generated beyond the build, inserted later
N_DELETE = 1_000_000
TIMED_RUNS = 7

# The card the port targets, the H100 SXM (NVIDIA data sheet): its memory
# rate in bytes/s, and its 67 TFLOP/s non-tensor float32 rate, which bounds
# the probe's 32-bit compares.  Memory moves in 32-byte sectors.
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


# ---------------------------------------------------------------------------
# Synthetic probe cases (numpy, seeded)
# ---------------------------------------------------------------------------

def make_case(rng, P, S, Q, C, holes=0.0, fill=0.7, tombstones=0.05):
    """A pool with unique keys, tombstones and empty slots, and a schedule
    whose first half holds each query's page (hits) and whose second half
    is random pages (mostly misses); ``holes`` blanks that share of steps,
    never a hit's own page."""
    kp = np.full((P, S), 0xFFFFFFFF, np.uint32)
    vp = np.zeros((P, S), np.uint32)
    n = int(P * S * fill)
    pos = rng.choice(P * S, size=n, replace=False)
    kp.reshape(-1)[pos] = rng.choice(0xFFFFFFF0, size=n, replace=False)
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
                              rng.choice(0xFFFFFFF0, Q - h).astype(np.uint32)])
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
    kp3 = np.full((2, 512), 0xFFFFFFFF, np.uint32)
    vp3 = np.arange(1024, dtype=np.uint32).reshape(2, 512)
    kp3[0, [450, 300, 130, 200]] = 9; kp3[1, 3] = 9; kp3[1, [500, 129]] = 11
    yield "first_match_across_chunks", (
        kp3, vp3, np.array([9, 9, 11], np.uint32),
        np.array([[0, 1], [1, 0], [0, 1]], np.int32))
    yield "paper_shape_S512_C8", make_case(rng, 8192, 512, 1 << 18, 8,
                                           holes=0.6)


def check_kernel_cases(probe_pages_perf, probe_pages_ref):
    import torch
    for name, case in kernel_cases():
        args = to_card(*case)
        got = probe_pages_perf(*args)
        sync()
        want = probe_pages_ref(*args)
        bad = int((got != want).any(dim=1).sum())
        check(bad == 0, f"kernel != plain on {name}: {bad} rows differ")
        print(f"kernel_check {name}: Q={case[2].size} equal "
              f"(found {int(got[:, 1].sum())})")


def check_small_table_vs_cpu(hashmap, HashMemConfig):
    """Build, insert and delete on the card and on the CPU: equal leaves."""
    import torch
    cfg = HashMemConfig(num_buckets=64, slots_per_page=128, overflow_pages=16,
                        max_chain=3)
    rng = np.random.default_rng(1)
    keys = rng.choice(0xFFFFFFF0, 14_000, replace=False).astype(np.uint32)
    keys[:2000] = keys[2000:4000]                         # duplicates
    vals = rng.integers(0, 2**32, keys.size, dtype=np.uint64).astype(np.uint32)
    tabs = {}
    for dev in ("cuda", "cpu"):
        hm = hashmap.build(cfg, keys[:9000], vals[:9000], device=dev)
        hm, ok = hashmap.insert(hm, keys[9000:], vals[9000:],
                                valid=np.arange(5000) % 7 != 0)
        hm, found = hashmap.delete(hm, keys[::5])
        v, f = hashmap.probe(hm, keys)
        tabs[dev] = (hashmap.to_numpy(hm), ok.cpu(), found.cpu(), v.cpu(),
                     f.cpu())
    gpu, cpu = tabs["cuda"], tabs["cpu"]
    for name in hashmap.LEAVES:
        check(np.array_equal(gpu[0][name], cpu[0][name]),
              f"small table: {name} differs between card and CPU")
    for a, b, what in zip(gpu[1:], cpu[1:], ("ok", "found", "values",
                                             "probe found")):
        check(torch.equal(a, b), f"small table: {what} differs")
    check(not bool(gpu[1].all()), "small table: no insert was refused")
    print("small_table: build/insert/delete/probe on the card equal the CPU "
          f"(refused {int((~gpu[1]).sum())}, deleted {int(gpu[2].sum())})")


def profile_probe(probe, top: int = 8):
    """Device time by kernel over one traced end-to-end probe call
    (torch.profiler), and the device's busy share of that call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        probe()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in evs)
    print(f"profile: traced hashmap.probe wall {wall_us / 1e3:.4f} ms, device "
          f"busy {busy_us / 1e3:.4f} ms ({busy_us / wall_us * 100:.1f}%), "
          f"{sum(e.count for e in evs)} device ops")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.4f} ms x{e.count:<3d} "
              f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# Main path at paper scale
# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the card and has no CPU mode")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}; run it "
             "from the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import PAPER_HASHMEM, HashMemConfig
    from repro_torch.core import hashmap
    from repro_torch.core.hashing import as_u32
    from repro_torch.core.layout import to_bits
    from repro_torch.data.kv_synth import kv_dataset, probe_set
    from repro_torch.kernels import build
    from repro_torch.kernels.probe_perf import probe_pages_perf
    from repro_torch.kernels.ref import probe_pages_ref

    # -- 1. device -----------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} card(s))")
    print(smi)
    if CARD not in name:
        fail(f"card {name!r} is not the {CARD} whose rates bound the kernel")

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    build.load("probe_perf")
    print(f"build: probe_perf.cu built in {time.perf_counter() - t0:.3f} s")
    for line in build.build_logs.get("probe_perf", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # -- 3. kernel against plain; card against CPU ------------------------------
    check_kernel_cases(probe_pages_perf, probe_pages_ref)
    check_small_table_vs_cpu(hashmap, HashMemConfig)

    # -- 4. main path at PAPER_HASHMEM -------------------------------------------
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

    probe_pages_perf.launches = 0
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    hm = hashmap.build(cfg, keys, vals)
    sync()
    build_s = time.perf_counter() - t0
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
    sync()
    launches = probe_pages_perf.launches
    st2 = hashmap.stats(hm2)
    print(f"main_mutate: inserted {held_k.size} (all ok), deleted {N_DELETE} "
          f"(all found); re-probe: deleted gone, inserted and untouched keys "
          f"return their values; live {st2['live_entries']}, tombstones "
          f"{st2['tombstones']}; probe_perf launches on the main path: "
          f"{launches}")
    check(launches > 0, "the main path never launched probe_perf")
    check(st2["live_entries"] == N_BUILD + N_HELD - N_DELETE, "live count")
    del hm2, v, f, found, ok

    # -- 5. the kernel at the main path's shapes ---------------------------------
    qd = as_u32(probes, "cuda")
    qbits = to_bits(qd)
    pages = hashmap.resolve_pages(hm, qd)
    pool = hm.store.pool
    out = probe_pages_perf(pool, qbits, pages)
    sync()
    plain = probe_pages_ref(pool, qbits, pages)
    sync()
    diff = (out.to(torch.int64) & 0xFFFFFFFF) - (plain.to(torch.int64)
                                                  & 0xFFFFFFFF)
    mismatches = int((diff != 0).any(dim=1).sum())
    max_abs_err = int(diff.abs().max())
    check(mismatches == 0, f"kernel != plain on {mismatches} paper probes")
    print(f"main_kernel_check: {probes.size} paper-scale probes, kernel equals "
          f"plain (mismatches 0)")

    # what the work needs: every slot of each row walked before the first
    # hit (all valid rows for a miss), the hit row's slots up to the hit slot
    # in whole sectors, the queries, the schedule and the output lanes
    C, S = pages.shape[1], cfg.slots_per_page
    found = out[:, 1] != 0
    hit_col = (pages == out[:, 2:3]) & (pages >= 0) & found[:, None]
    first = torch.where(found, hit_col.to(torch.uint8).argmax(1), C)
    before = torch.arange(C, device="cuda")[None, :] < first[:, None]
    rows = int(((pages >= 0) & before).sum())
    hit_slots = out[found, 3].to(torch.int64) + 1
    hit_bytes = int(((hit_slots * 8 + SECTOR - 1) // SECTOR * SECTOR).sum())
    nbytes = (rows * S * 8 + hit_bytes + qbits.numel() * 4 + pages.numel() * 4
              + out.numel() * 4)
    ops = rows * S + int(hit_slots.sum())
    bytes_s, ops_s = nbytes / HBM_RATE, ops / ALU32_RATE
    bound_ms = max(bytes_s, ops_s) * 1e3
    bound_by = "bytes" if bytes_s >= ops_s else "operations"

    kernel_ms = cuda_ms(lambda: probe_pages_perf(pool, qbits, pages),
                        TIMED_RUNS)
    plain_ms = cuda_ms(lambda: probe_pages_ref(pool, qbits, pages), 3)
    e2e_ms = cuda_ms(lambda: hashmap.probe(hm, qd), TIMED_RUNS)
    print(f"timing: probe_perf {kernel_ms:.4f} ms for {probes.size} probes "
          f"(needs {rows} whole rows + {hit_bytes / 1e9:.3f} GB of hit rows "
          f"up to the hit slot, mean slot "
          f"{float(hit_slots.double().mean()):.1f}; {nbytes / 1e9:.3f} GB in "
          f"all, {nbytes / kernel_ms / 1e9:.2f} TB/s); bound {bound_ms:.4f} "
          f"ms ({bound_by}, "
          f"{HBM_RATE / 1e12:.2f} TB/s); "
          f"{bound_ms / kernel_ms * 100:.1f}% of bound; "
          f"plain {plain_ms:.4f} ms")
    print(f"timing: hashmap.probe end to end (hash + chain walk + kernel) "
          f"{e2e_ms:.4f} ms = {probes.size / e2e_ms / 1e3:.1f} Mprobes/s; "
          f"build {build_s:.3f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; median of "
          f"{TIMED_RUNS} runs after warm-up; card: {smi}")
    profile_probe(lambda: hashmap.probe(hm, qd))

    print(json.dumps({"kernels": [{
        "name": "probe_perf", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/probe_perf.cu",
        "replaces": "src/repro/kernels/probe_perf.py:34",
        "launches": launches, "max_abs_err": max_abs_err,
        "mismatches": mismatches, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
