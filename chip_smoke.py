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
     against the CPU: equal results, schedules, metrics and tables; and
     mesh engines (2 and 4 shards stacked on the card) on ``perf``, ``area``
     and ``bitserial``, fused and unfused, at depth 1 and 2, a displaced
     one, one that grows at drain, one that splits and doubles, and the
     routed ``probe_sharded``/``delete_sharded``/``insert_mesh`` calls with
     every key routed to one shard, on the card against the CPU (results,
     schedules, metrics, stacked leaves), each probe phase and each
     delete's find one kernel launch for all shards;
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
     ``engine.preload``, 1024 requests of 4 ops per tenant through 4096
     slots at pipeline depth 1 and, on a fresh engine, depth 2 (equal
     results and schedules), every result checked against the DictModel
     replay (``tests/model.py``), the trace checked by
     ``tools/trace_report.py``, ``probe_perf`` launched on every tick with a
     probe or delete phase and no synchronise in the issue path; reports
     ops/s, ticks, latency in ticks and ms, per-phase host time, device
     busy and idle share over a ``torch.profiler`` window, stalls, rows
     activated and peak memory; then the per-request baseline
     (``coalesce=False``) on 64 requests per tenant;
  9. drives the mesh path at paper scale: PAPER_HASHMEM cut four ways
     (2^16 buckets x 512 slots, 2^14 overflow pages a shard), 4 shards
     stacked on the card.  Loads the 100M pairs of phase 4 through
     ``rlu.insert_sharded``, probes the 10M probes through
     ``rlu.probe_sharded`` (one ``probe_perf`` launch), checking every
     result, times it and splits its device time by range; then serves the
     phase 8 stream through the mesh engine three ways (fused tick at depth
     1 and 2, unfused at depth 1), every result against the DictModel
     replay and phase 8's, with ops/s, latency, host time a span, device
     idle share, pool copies a write phase, launches a tick, synchronises
     in the issue path and the routing capacities;
 10. serves LM decode over the HashMem page table (``launch/serve.py``
     ``serve``): the four dense archs at ``smoke_config`` in float32 on the
     card against the CPU (32 teacher-forced ``decode_step`` logits and the
     KV pools; a small ``serve()`` on a ``perf`` page table: its allocation
     and free trace, steps, events and leaves); Qwen3-8B at its published
     widths and depth (random init from a seed, drawn on the card): decode
     against ``forward`` at every position of 2 x 64 tokens in float32 with
     TF32 off, the block table probed through ``probe_perf``; then the
     served run at the config's dtypes (batch 16, horizon 4096, 32 requests
     of 8 + 16 tokens), once checked (every admission's probed table against
     the allocator, ``probe_perf`` against plain on the table's keys), once
     timed (tokens/s, step ms against its byte bound, page-table host ms,
     ``probe_perf`` launches a step, peak memory) and once profiled (device
     idle share), all under ``torch.no_grad()``, beside the dry-run's
     record of the same cell (``launch/dryrun.py`` on fake tensors:
     argument bytes, estimated peak, FLOPs); for phase 15 it keeps the
     float32 logits of 8 teacher-forced steps and a one-wave serve's
     tokens and top logits a step under ``build/decode_ranks``;
 11. trains and checkpoints (``launch/train.py`` ``train``,
     ``checkpoint/checkpointer.py``): (a) llama3-8b, qwen3-8b and
     h2o-danube-1.8b at ``smoke_config`` in float32 with TF32 off, 4 train
     steps on the card against the CPU from the same parameters and batches
     (losses, grad norms, parameters); (b) the restart of
     ``tests/test_train_integration.py`` on the card: a failure injected at
     step 10 with a checkpoint every 4 steps gives losses, parameters and
     moments bit-equal to an uninterrupted run's; (c) the phase 4 ``perf``
     table (100M pairs) saved by the ``Checkpointer`` and restored to the
     card, its leaves equal and the 10M paper probes through ``probe_perf``
     equal before and after (save and restore seconds and GB/s); (d)
     h2o-danube-1.8b at its published widths, 4 of 24 layers (random init
     on the card, params float32, activations bfloat16, AdamW float32,
     remat) for 6 steps at batch 4 x 4096 with a checkpoint at step 4, and
     a second run resumed from it whose steps 4-5 and final checkpoint
     equal the first run's bit for bit: losses, ms a step, tokens/s, FLOP share of the bf16
     peak, peak memory, checkpoint seconds, and the device idle share over
     a profiled step, beside the dry-run's record of the step;
 12. runs the moe and hybrid families: (a) ``moe.apply`` of olmoe-1b-7b,
     jamba-v0.1-52b and llama4-maverick-400b-a17b at ``smoke_config``
     (learned and hash routing, capacity_factor 0.25 with drops) and jamba's
     mamba ``apply``/``decode_step`` on the card against the CPU (outputs,
     routing indices, keep masks, ``moe_dropped``), 4 train steps of olmoe
     and jamba smoke on the card against the CPU, and an olmoe smoke
     restart on the card, bit-equal to an uninterrupted run; (b)
     jamba-v0.1-52b at its published widths, 8 of 32 layers (one unit),
     float32, decode against ``forward`` at every position of 2 x 64
     tokens, then served through ``serve()`` at batch 16; (c)
     olmoe-1b-7b at its published widths and depth served at batch 16,
     horizon 4096 (checked, timed and profiled as in phase 10, with
     ``moe_dropped`` over the run); (d) olmoe-1b-7b at its published widths
     and 4 of 16 layers training 8 steps at batch 4 x 4096 (ms a step,
     tokens/s, FLOP share with the experts counted at capacity, the aux
     terms by step, a device-time split and the idle share of a profiled
     step);
 13. runs the ssm, encdec and vlm families: (a) at ``smoke_config``, on the
     card against the CPU in float32, xlstm's ``apply_mlstm`` at chunks
     4/16/64 and with ``mlstm_scan_groups=2`` and ``apply_slstm`` (outputs
     and gradients), ``decode_mlstm``/``decode_slstm`` step by step with
     their states, whisper's ``encode``, ``cross_kv`` and library-level
     decode, internvl2's forward; 4 train steps of each of the three; a
     small ``serve()`` of xlstm and of internvl2 (trace, steps, leaves);
     (b) xlstm-1.3b at its published widths and depth: every layer's decode
     against its forward on the same inputs within 5e-4, the whole model's
     decode against forward (a drift float32 grows with depth, reported),
     served at batch 16, horizon 4096 (checked, timed against a bound of
     the weights and the mLSTM states, profiled), and at 8 of its 48
     layers trained at batch 4 x 512 through ``launch.train.train`` with
     the sLSTM's host time
     metered and one profiled step at 4 x 16 (the sLSTM's device time by
     range); (c) whisper-tiny at its published widths: decode against
     ``decode_train`` over 1500 stub frames, then training at batch 16 x
     (4096 frames, 512 decoder tokens) with ``final_norm/bias`` and its
     moments held at zero; (d) internvl2-2b at its published widths and
     depth, 4 train steps at batch 4 x (256 patch embeddings + 3840
     tokens); prints the ``kernels`` line (``probe_perf``'s launches
     count the perf path's, the timed serves' of phases 10, 12 and 13 and
     the checkpointed table's probes);
 14. serves the sharded table from 4 rank processes, one shard each, over
     ``torch.distributed`` (``launch/mesh.py`` ``spawn_ranks``; NCCL with a
     card a rank, else gloo with every rank on the one card): (a) phase 3's
     mesh engines (2 and 4 ranks) and routed one-shard calls, equal to
     phase 3's CPU runs, rank r's leaves to shard r; (b) each rank loads
     its pairs of phase 4's 100M into its shard of PAPER_HASHMEM cut four
     ways (every leaf equal to phase 9's shard r), probes its block of the
     10M probes through ``rlu.probe_sharded`` (one ``probe_perf`` launch a
     rank, timed), then serves phase 8's stream through the rank engine
     (fused tick, depth 1), equal to phase 8 and the DictModel, reporting
     ops/s and the host ms in ``rlu.exchange`` a tick; the ``kernels``
     line adds every rank's launches of phase 14;
 15. decodes over ("data", "model") meshes of 4 rank processes
     (``launch/mesh.py`` ``make_model_mesh``; gloo with every rank on the
     one card, as phase 14): (a) the four dense archs at ``smoke_config``
     widths, 2 layers, in float32 on (1, 4) and (2, 2), and qwen3 with 2
     KV heads (``wk``/``wv`` replicated) on (1, 4), against one card from
     the same draw: every rank's shard equals the slice of the one-card
     draw (sha256), 8 teacher-forced steps' logits and the KV pools within
     5e-4 (keys on the same pages), the tokens of a two-wave serve equal to
     one card's with the mesh's geometry, every rank's page table equal;
     (b) Qwen3-8B at its published widths on (1, 4), each rank drawing its
     shard with ``init_params_sharded``: the float32 logits of 8
     teacher-forced steps within 5e-4 of phase 10's, then 16 requests
     served at batch 16, horizon 4096 (ms a step, tokens/s, collectives a
     step, their bytes and host ms by rank, ``probe_perf`` launches by
     rank, peak a rank), the tokens against phase 10's one-card run of the
     same settings (where they differ, the one-card margin at the first
     divergence must be within the bfloat16 rounding bound ``TopLogits``
     states), every rank's collectives equal, call for call and byte for
     byte by kind, to the steps times the dry-run's ``RecordingMesh``
     trace of one serve step of the cell; (c) with four cards, (b) again
     over NCCL, a card a rank; the ``kernels`` line adds every rank's
     launches;
 16. trains over ("data", "model") meshes of 4 rank processes (gloo with
     every rank on the one card): (a) qwen3-8b at ``smoke_config`` widths,
     2 layers, float32, on (2, 2) with ``seq_shard`` (2 steps), with 2 KV
     heads on (1, 4) and int8 compression, olmoe-1b-7b with
     ``moe_impl="gspmd"`` and with ``"ep"`` at capacity_factor = E (no
     drops) on (2, 2), and internvl2-2b on (2, 2), each rank drawing its
     blocks (``init_train_state``), against the port's one-card step from
     the same draw: loss, grad norm and aux terms within 1e-5 relative,
     ``moe_dropped`` equal, every gradient block within 1e-5 of its leaf's
     largest, the stepped parameters; the first case's step-1 state saved
     by the ranks' ``Checkpointer``, read back on one card (the gathered
     blocks, bit for bit) and on (1, 4) (each rank's block), and the step
     resumed from it bit-equal to the uninterrupted one; (b) OLMoE-1B-7B at
     its published widths, 4 of 16 layers, with expert parallelism on
     (2, 2), 3 steps at batch 4 x 4096 through ``launch.train.train``: ms
     a step, tokens/s, FLOP share, collectives a step by kind, the MoE
     terms by step, peak a rank, a finite and falling loss; (c) with four
     cards, (b) at all 16 layers over NCCL, a card a rank.  It launches
     no probe kernel;
 17. decodes the moe, hybrid and vlm families over ("data", "model")
     meshes of 4 rank processes (gloo with every rank on the one card) and
     trains the hybrid family there: (a) olmoe-1b-7b (2 layers) on (2, 2),
     jamba-v0.1-52b's 4-layer smoke unit on (1, 4) and (2, 2) and
     internvl2-2b (2 layers) on (1, 4) at ``smoke_config`` widths in
     float32, 8 teacher-forced steps against one card from the same draw
     (logits within 1e-5, greedy tokens equal, the MoE steps' largest
     all-gather below a MoE layer's expert blocks: the experts stay
     where they lie), jamba's unit served on (2, 2) as one card serves it,
     and one jamba ``moe_impl="ep"`` training step on (2, 2) with
     ``seq_shard`` held as phase 16 holds its cases; (b) jamba-v0.1-52b at
     its published widths and phase 12's 8 layers on (1, 4), the ranks
     drawing their blocks one after another: 16 float32 teacher-forced
     steps within 1e-5 of the largest of phase 12's one-card logits, then
     phase 12's bf16 serve (ms a step, tokens/s, share of the byte bound,
     collectives a step by kind, the largest all-gather, peak a rank,
     ``probe_perf`` launches by rank); (c) with four cards, jamba at all
     32 layers over NCCL, a card a rank, its decode against the forward
     over the ranks, then served; the ``kernels`` line adds every rank's
     launches;
 18. decodes and trains the ssm and encdec families over ("data",
     "model") meshes of 4 rank processes (gloo with every rank on the one
     card): (a) xlstm-1.3b (2 layers: an sLSTM and an mLSTM, head-parallel)
     on (1, 4) and (2, 2), whisper-tiny on (2, 2) and with 6 heads on
     (1, 4) (its attention heads replicated over "model") at
     ``smoke_config`` widths in float32, 8 teacher-forced steps against one
     card from the same draw (logits within 1e-5, greedy tokens equal),
     xlstm served on (1, 4) as one card serves it, one training step each
     of xlstm on (2, 2) and 6-head whisper on (1, 4) with ``seq_shard``
     held as phase 16 holds its cases (xlstm's gradients within 1e-4 of
     their leaf's largest) and whisper's ``final_norm/bias`` at zero; (b)
     xlstm-1.3b at its published widths and depth on (1, 4), one head a
     rank: each layer's float32 decode fed phase 13(b)'s one-card input of
     that layer at each of 16 steps within 1e-5 of the norm of its own
     output (or 4 x the one-card sensitivity there, where a one-ulp move
     of the input moves one card's output further), the end-to-end drift
     of 8 steps printed, then phase 15's bf16 serve (ms a step, tokens/s,
     share of the byte bound, collectives a step by kind, peak a rank,
     ``probe_perf`` launches by rank); (c) whisper-tiny at its published
     widths on (1, 4) and (2, 2): the cross K/V blocks and 8 float32
     teacher-forced steps over 1500 stub frames against one card, and one
     float32 training step on (2, 2) at phase 13(c)'s shape (loss and grad
     norm within 1e-5 relative, ``final_norm/bias`` zero); (d)
     xlstm-1.3b's 8-layer cut trained one float32 step at 4 x 256 on (2, 2)
     with ``seq_shard`` (loss within 1e-5 relative of one card's; every
     leaf's gradient block against one card's: the step run in float64
     within 1e-4 of the leaf's largest, the float32 step within the larger
     of 1e-4 and 4 times the most a one-ulp move of the parameters moves
     that leaf of one card's gradient; ms, the collectives by kind and
     pass, the same at 4 x 64; the sLSTM's host share); the ``kernels``
     line adds every rank's launches;
 19. prints the device line last.

Any failed check raises and the script exits non-zero.  Without a card, or
without the rest of the repo beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    # the card's rates and the bounds of a step, kept with the dry-run
    from repro_torch.launch.dryrun import (BF16_RATE, HBM_RATE,
                                           decode_bound, train_flops)
except ModuleNotFoundError as e:
    sys.exit(f"chip_smoke: {e}: src/repro_torch not found beside "
             f"{Path(__file__).name}; run it from the root of a checkout")
N_BUILD = 100_000_000            # PAPER_WORKLOAD["num_pairs"]
N_HELD = 1_000_000               # generated beyond the build, inserted later
N_DELETE = 1_000_000
TIMED_RUNS = 7
KERNELS = ("probe_perf", "probe_area", "probe_bitserial")

# The card the port targets, the H100 SXM (NVIDIA data sheet): its 67
# TFLOP/s non-tensor float32 rate, which bounds the probes' 32-bit
# compares (its memory and bf16 rates are ``dryrun.HBM_RATE`` and
# ``BF16_RATE``).  Memory moves in 32-byte sectors.
CARD = "H100 80GB HBM3"
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
MESH_SPANS = ("rlu.route", "probe.schedule", "probe.kernel",
              "rlu.gather_back")


def profile_probe(probe, label: str = "hashmap.probe", top: int = 8,
                  spans=SPANS):
    """Device time by kernel over one traced end-to-end probe call
    (torch.profiler), the device's busy share of that call's wall time, and
    the device time of the kernels that ran inside each of the
    ``record_function`` ranges ``spans`` (default ``SPANS``, those of
    ``hashmap.probe_with_buckets``), read from the ranges' windows on the
    device timeline.  The ranges' own
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
    return busy_us / 1e3, wall_us / 1e3, kernels_in_ranges(prof, spans)


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
SERVE_REQUESTS = 1024            # per tenant, 4 ops each: 24,576 ops
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
    (``torch.cuda.set_sync_debug_mode``), and, inside the issue of each
    tick's phases, the synchronises, ``kernel``'s launches and the phases
    issued.  Returns (snapshot, wall seconds ended by a synchronise,
    per-tick records, per-issue (synchronises, launches, phase kinds))."""
    import warnings

    import torch
    per_tick, issue = [], []
    orig = eng._issue
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def counted_issue(*args):
            n0, l0 = len(caught), kernel.launches
            rec = orig(*args)
            issue.append((len(caught) - n0, kernel.launches - l0,
                          [ph.kind for ph in rec.phases]))
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
            n_issue = sum(i[0] for i in r["issue"])
            check(n_issue == 0, f"depth {depth}: the issue path "
                  f"synchronised {n_issue} times")
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
    return one["launches"], one["results"]


# ---------------------------------------------------------------------------
# The mesh backend: small mesh engines on the card against the CPU, and the
# paper-scale mesh path
# ---------------------------------------------------------------------------

MESH_SHARDS = 4                  # phase 9: PAPER_HASHMEM cut four ways:
MESH_BUCKETS = 1 << 16           # 2^18 / 4 buckets and 2^16 / 4 overflow
MESH_OVERFLOW = 1 << 14          # pages a shard, the same stacked pool
MESH_SERVE_SPANS = {True: "tick,gather,route,fused_tick,writeback",
                    False: "tick,gather,probe,delete,insert,writeback"}


def all_launches(k):
    return sum(w.launches for w in k.values())


def issue_launches_wanted(eng, kinds) -> int:
    """Kernel launches one tick's issue must make: one a probe phase and one
    a delete's find, for all shards at once.  A fused tick always routes
    all three phases (an empty one as a batch of pads, as JAX's does), so
    it makes both."""
    if eng.fused_tick:
        return 2
    return sum(kd in ("probe", "delete") for kd in kinds)


def count_issue_launches(eng, k):
    """Wrap ``eng._issue``: a list that gets, per tick, the phases issued
    and the kernel launches (all kernels) inside the issue."""
    per = []
    orig = eng._issue

    def issue(*args):
        l0 = all_launches(k)
        rec = orig(*args)
        per.append(([ph.kind for ph in rec.phases], all_launches(k) - l0))
        return rec
    eng._issue = issue
    return per


def mesh_insert_heavy(serving, cfg, mesh, dev, **kw):
    """An engine on ``mesh`` driven by ``tests/model.py``'s insert-heavy
    streams (growth or extendible splits); returns (engine, requests)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from model import make_insert_heavy_schedule
    streams = make_insert_heavy_schedule(
        9, n_requests=48, ops_per_request=3, keyspace=96,
        zipf_theta=0.6 if cfg.resize == "extendible" else 0.0)
    eng = serving.ServingEngine(cfg, mesh=mesh, max_slots=8,
                                record_schedule=True, device=dev, **kw)
    return eng, [serving.Request(ops=list(ops)) for ops in streams]


def small_mesh_cases(HashMemConfig) -> list:
    """Phase 3's mesh engine cases, (name, cfg, shards, engine kwargs,
    driven by insert-heavy streams): perf/area/bitserial on 2 and 4 shards,
    fused and unfused, at depth 1 and 2; a displaced table; a tiny table
    that grows and an extendible one that splits and doubles."""
    base = HashMemConfig(num_buckets=64, slots_per_page=64, overflow_pages=64,
                         max_chain=8)
    cases = []
    for backend in ("perf", "area", "bitserial"):
        for D in (2, 4):
            for fused in (True, False):
                for depth in (1, 2):
                    cases.append((
                        f"{backend}_D{D}_{'fused' if fused else 'unfused'}"
                        f"_d{depth}", dataclasses.replace(base,
                                                          backend=backend),
                        D, dict(fused_tick=None if fused else False,
                                pipeline_depth=depth), False))
    cases.append(("displaced_D2", HashMemConfig(
        num_buckets=16, slots_per_page=32, overflow_pages=32, max_chain=4,
        displacement=True, fingerprint_bits=8, stash_slots=32), 2,
        dict(pipeline_depth=2), False))
    cases.append(("grows_D2", HashMemConfig(
        num_buckets=4, slots_per_page=4, overflow_pages=8, max_chain=2,
        max_load_factor=0.95), 2, dict(pipeline_depth=2), True))
    cases.append(("extendible_D2", HashMemConfig(
        num_buckets=4, slots_per_page=4, overflow_pages=60, max_chain=2,
        resize="extendible", max_load_factor=1.0), 2,
        dict(pipeline_depth=2), True))
    return cases


def small_mesh_engine(serving, case, mesh, dev):
    """The engine of one ``small_mesh_cases`` case on ``mesh``, and its
    requests."""
    name, cfg, D, kw, heavy = case
    if heavy:
        return mesh_insert_heavy(serving, cfg, mesh, dev, **kw)
    eng, reqs, _, _ = serving_engine(serving, cfg, "ABEF", 256, 8, dev,
                                     max_slots=16, mesh=mesh, **kw)
    return eng, reqs


def check_small_mesh_vs_cpu(serving, hashmap, HashMemConfig, k):
    """Mesh engines with 2 and 4 shards stacked on the card against the
    same engines on the CPU: equal results, schedules, deterministic metrics
    and stacked leaves, for each kernel backend, fused and unfused, at
    pipeline depth 1 and 2; a displaced table; a tiny table that grows at
    drain; an extendible one that splits and doubles.  On the card each
    probe phase and each delete's find is one kernel launch for all shards
    (counted inside the issue of every tick).  Then the routed calls with
    every key routed to one shard.  Returns the launches and the CPU
    outcomes (by case, and the routed calls'), which phase 14 holds the
    ranks to."""
    from repro_torch.launch.mesh import make_serving_mesh
    reset_launches(k)
    phases = {"probe": [], "delete": []}
    cpu_out = {}
    for case in small_mesh_cases(HashMemConfig):
        name, cfg, D = case[:3]
        out = {}
        for dev in ("cuda", "cpu"):
            eng, reqs = small_mesh_engine(
                serving, case, make_serving_mesh(D, device=dev), dev)
            per = count_issue_launches(eng, k) if dev == "cuda" else None
            eng.submit_all(reqs)
            out[dev] = engine_outcome(hashmap, eng, reqs, eng.run())
            if per is not None:
                for kinds, launched in per:
                    want = issue_launches_wanted(eng, kinds)
                    check(launched == want, f"mesh engine {name}: {launched} "
                          f"launches for the phases {kinds}")
                    for kd in kinds:
                        if kd in phases:
                            phases[kd].append(1)
        (res, sched, det, leaves), cpu = out["cuda"], out["cpu"]
        cpu_out[name] = cpu
        check(res == cpu[0], f"mesh engine {name}: results differ")
        check(sched == cpu[1], f"mesh engine {name}: schedules differ")
        check(det == cpu[2], f"mesh engine {name}: metrics differ")
        check(all(np.array_equal(a[n], b[n]) for a, b in zip(leaves, cpu[3])
                  for n in a) and len(leaves) == len(cpu[3]) == D,
              f"mesh engine {name}: stacked leaves differ")
        check_heavy(eng, name)
        st = eng.stats()
        print(f"small_mesh {name}: {len(reqs)} requests, {eng.ticks} ticks, "
              f"batch calls {eng.batch_calls}, grows {eng.grow_events}, "
              f"splits {eng.split_events}, route caps "
              f"{st['route_cap_totals']}; card equals CPU (results, "
              f"schedule, metrics, stacked leaves of {D} shards)")
    launches = read_launches(k)
    print(f"small_mesh: {len(phases['probe'])} probe phases and "
          f"{len(phases['delete'])} delete phases on the card, each ONE "
          f"kernel launch for all shards; launches {launches}")
    return launches, cpu_out, routed_one_shard(hashmap, HashMemConfig, k)


def check_heavy(eng, name):
    """The growth and split cases must grow, and split and double."""
    if name == "grows_D2":
        check(eng.grow_events > 0, f"mesh engine {name}: no grow")
    if name == "extendible_D2":
        check(eng.split_events > 0 and eng.directory_doublings > 0
              and eng.grow_events == 0, f"mesh engine {name}: "
              f"{eng.split_events} splits, {eng.directory_doublings} "
              f"doublings, {eng.grow_events} grows")


ONE_SHARD = 4                    # shards of the routed one-shard calls


def one_shard_inputs(rlu, HashMemConfig):
    """(cfg, router, keys, new keys, probes): every key owned by shard 0
    of ``ONE_SHARD``."""
    cfg = HashMemConfig(num_buckets=64, slots_per_page=64, overflow_pages=64,
                        max_chain=8)
    sb = "highbits"
    cand = np.arange(1, 400_000, dtype=np.uint32)
    hot = cand[rlu.owner_of_np(cand, cfg, ONE_SHARD, sb) == 0][:3072]
    keys, new = hot[:2048], hot[2048:]
    return cfg, sb, keys, new, np.concatenate([keys[:1024], new[:1024]])


def one_shard_calls(hashmap, rlu, mesh, hs, k, block=lambda x: x):
    """``insert_sharded``, then ``probe_sharded``, ``delete_sharded`` and
    ``insert_mesh`` at ``routing_cap`` on ``mesh`` (``block`` takes what
    this process passes of a batch).  Returns (outputs, leaves, caps,
    launches of the probe and of the delete)."""
    from repro_torch.configs import HashMemConfig
    cfg, sb, keys, new, q = one_shard_inputs(rlu, HashMemConfig)
    D = ONE_SHARD
    hs, ok, cfg2 = rlu.insert_sharded(hs, keys, keys ^ 5, cfg, D,
                                      shard_by=sb, mesh=mesh)
    caps = [rlu.routing_cap(x, cfg2, D, sb) for x in (q, keys[:512], new)]
    l0 = read_launches(k)
    v, f = rlu.probe_sharded(mesh, hs, block(q), cfg2, cap=caps[0],
                             shard_by=sb)
    l1 = read_launches(k)
    hs2, df = rlu.delete_sharded(mesh, hs, block(keys[:512]), cfg2,
                                 cap=caps[1], shard_by=sb)
    l2 = read_launches(k)
    hs3, iok = rlu.insert_mesh(mesh, hs2, block(new), block(new ^ 9), cfg2,
                               cap=caps[2], shard_by=sb)
    return ([ok.cpu(), v.cpu(), f.cpu(), df.cpu(), iok.cpu()],
            hashmap.to_numpy(hs3), caps,
            [{n: b[n] - a[n] for n in a} for a, b in ((l0, l1), (l1, l2))])


def routed_one_shard(hashmap, HashMemConfig, k):
    """probe_sharded, delete_sharded and insert_mesh at ``routing_cap``
    with every key owned by shard 0 of 4, card against CPU; one launch a
    probe and one a delete's find.  Returns the CPU run."""
    import torch
    from repro_torch.core import rlu
    from repro_torch.launch.mesh import make_serving_mesh
    D = ONE_SHARD
    cfg, sb, keys, new, q = one_shard_inputs(rlu, HashMemConfig)
    runs = {}
    for dev in ("cuda", "cpu"):
        hs = hashmap.stack([hashmap.create(cfg, device=dev)
                            for _ in range(D)])
        runs[dev] = one_shard_calls(hashmap, rlu,
                                    make_serving_mesh(D, device=dev), hs, k)
    (outs, leaves, caps, launched), cpu = runs["cuda"], runs["cpu"]
    check(all(torch.equal(a, b) for a, b in zip(outs, cpu[0])),
          "routed one-shard calls: card and CPU outputs differ")
    check(all(np.array_equal(leaves[n], cpu[1][n]) for n in leaves),
          "routed one-shard calls: card and CPU leaves differ")
    check(caps == [len(q) // D, 128, 256],
          f"routing_cap with every key on shard 0: {caps}")
    ok, v, f, df, iok = outs
    check(bool(ok.all()) and bool(f[:1024].all()) and not bool(f[1024:].any())
          and bool(df.all()) and bool(iok.all()),
          "routed one-shard calls: wrong results")
    check(launched[0]["probe_perf"] == 1 and launched[1]["probe_perf"] == 1,
          f"routed one-shard calls: launches {launched}")
    print(f"routed_one_shard: every key on shard 0 of {D}: caps {caps} (= "
          f"Q_local); probe_sharded, delete_sharded, insert_mesh on the card "
          f"equal the CPU; launches: probe {launched[0]}, delete "
          f"{launched[1]}")
    return cpu


def mesh_path(serving, hashmap, k, data, smi, host_rate, host_results):
    """Phase 9: the paper's 100M pairs in PAPER_HASHMEM cut four ways, 4
    shards stacked on the card (``highbits``); the sharded probe of the 10M
    paper probes, then the phase 8 stream through the mesh engine, fused at
    depth 1 and 2 and unfused at depth 1.  Returns the launches of the
    sharded probe and of the fused depth-1 run, and the sha256 of every
    leaf of every shard after the load."""
    import torch
    from repro_torch.configs import PAPER_HASHMEM
    from repro_torch.core import rlu
    from repro_torch.core.hashing import as_u32
    from repro_torch.launch.mesh import make_serving_mesh
    probe_perf = k["probe_perf"]
    D, sb = MESH_SHARDS, "highbits"
    cfg = dataclasses.replace(PAPER_HASHMEM, num_buckets=MESH_BUCKETS,
                              overflow_pages=MESH_OVERFLOW)
    mesh = make_serving_mesh(D)
    keys, vals, held_k = data["keys"], data["vals"], data["held_k"]
    probes, pidx = data["probes"], data["pidx"]
    t_phase = time.perf_counter()

    # -- 1. the sharded probe ----------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    hs = hashmap.stack([hashmap.create(cfg) for _ in range(D)])
    (hs, ok, cfg2), load_s = host_s(lambda: rlu.insert_sharded(
        hs, keys, vals, cfg, D, shard_by=sb))
    check(bool(ok.all()), f"insert_sharded refused {int((~ok).sum())} pairs")
    check(cfg2 == cfg, "insert_sharded grew the shards")
    st = [hashmap.stats(s) for s in hashmap.unstack(hs)]
    check(sum(s["live_entries"] for s in st) == N_BUILD,
          "the shards hold the wrong number of pairs")
    print(f"mesh_load: {N_BUILD} pairs into {D} stacked shards through "
          f"rlu.insert_sharded in {load_s:.3f} s; stacked pool "
          f"{tuple(hs.store.pool.shape)} = "
          f"{hs.store.pool.numel() * 4 / 1e9:.3f} GB; live a shard "
          f"{[s['live_entries'] for s in st]}; max chain "
          f"{max(s['max_chain'] for s in st)}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    digests = leaf_digests(hashmap, hs)
    qd = as_u32(probes, "cuda")
    cap = rlu.routing_cap(probes, cfg, D, sb)
    reset_launches(k)
    v, f = rlu.probe_sharded(mesh, hs, qd, cfg, cap=cap, shard_by=sb)
    probe_launches = read_launches(k)
    check(bool(f.all()), f"{int((~f).sum())} built keys not found")
    check(np.array_equal(v.cpu().numpy().astype(np.uint32), vals[pidx]),
          "sharded probe values differ from the dataset's")
    check(probe_launches["probe_perf"] == 1,
          f"the sharded probe launched {probe_launches}")
    _, f = rlu.probe_sharded(mesh, hs, held_k, cfg, shard_by=sb)
    check(not bool(f.any()), f"{int(f.sum())} never-inserted keys found")
    ms = cuda_ms(lambda: rlu.probe_sharded(mesh, hs, qd, cfg, cap=cap,
                                           shard_by=sb), TIMED_RUNS)
    print(f"mesh_probe: {probes.size} probes through rlu.probe_sharded at cap "
          f"{cap} (Q_local {probes.size // D}): all found with their values, "
          f"{held_k.size} held-back keys none; launches {probe_launches}; "
          f"{ms:.4f} ms = {probes.size / ms / 1e3:.1f} Mprobes/s (median of "
          f"{TIMED_RUNS} after warm-up) against phase 4's hashmap.probe "
          f"{host_rate:.1f} Mprobes/s; card: {smi}")
    busy, wall, spans = profile_probe(
        lambda: rlu.probe_sharded(mesh, hs, qd, cfg, cap=cap, shard_by=sb),
        "rlu.probe_sharded", spans=MESH_SPANS)
    rest = busy - sum(x for x in spans.values() if x is not None)
    print("mesh_profile: device time by range "
          + ", ".join(f"{n} {x:.4f} ms ({x / busy * 100:.1f}%)"
                      if x is not None else f"{n} not in the trace"
                      for n, x in spans.items())
          + f", the rest {rest:.4f} ms; busy {busy:.4f} of wall "
          f"{wall:.4f} ms")
    del hs, qd, v, f, ok

    # -- 2. the phase 8 stream through the mesh engine ----------------------
    out_dir = ROOT / "build" / "serving"
    pool_bytes = 2 * D * cfg.num_pages * cfg.slots_per_page * 8
    runs = {}
    for name, fused, depth in (("fused_d1", None, 1), ("fused_d2", None, 2),
                               ("unfused_d1", False, 1)):
        eng, reqs, load_s, svals = serving_engine(
            serving, cfg, SERVE_WORKLOADS, SERVE_RECORDS, SERVE_REQUESTS, None,
            mesh=mesh, max_slots=SERVE_SLOTS, pipeline_depth=depth,
            fused_tick=fused, trace=serving.Tracer(capacity=1 << 19))
        check(sum(hashmap.stats(s)["live_entries"] for s in eng.shards)
              == len(SERVE_WORKLOADS) * SERVE_RECORDS, "mesh preload")
        eng.profile_ticks(*SERVE_PROFILE, str(out_dir / f"mesh_{name}"))
        reset_launches(k)
        torch.cuda.reset_peak_memory_stats()
        eng.submit_all(reqs)
        snap, wall, per_tick, issue = drive_stream(eng, probe_perf)
        launches = read_launches(k)
        results = [r.results for r in reqs]
        check(results == host_results, f"mesh {name}: a result differs from "
              f"phase 8's host engine")
        if name == "fused_d1":
            dict_model_replay(eng.schedule, eng.tenants.space, svals)
        path = out_dir / f"trace_mesh_{name}.json"
        eng.export_trace(str(path), workloads=SERVE_WORKLOADS)
        rep = subprocess.run(
            [sys.executable, str(ROOT / "tools" / "trace_report.py"),
             str(path), "--assert-spans", MESH_SERVE_SPANS[fused is None]],
            capture_output=True, text=True, timeout=600)
        check(rep.returncode == 0, f"trace_report refused the mesh {name} "
              f"trace:\n{rep.stdout[-3000:]}{rep.stderr[-2000:]}")
        for n_sync, launched, kinds in issue:
            want = issue_launches_wanted(eng, kinds)
            check(launched == want, f"mesh {name}: {launched} probe_perf "
                  f"launches in an issue of {kinds}, want {want}")
        runs[name] = dict(
            results=results, schedule=eng.schedule, snap=snap, wall=wall,
            per_tick=per_tick, issue=issue, launches=launches, load_s=load_s,
            stats=eng.stats(), peak=torch.cuda.max_memory_allocated() / 2**30,
            profile=device_profile(eng.profiler, eng.profile_seconds),
            profile_ms=eng.profile_seconds * 1e3)
        del eng, reqs, svals
    first = runs["fused_d1"]
    for name, r in runs.items():
        check(r["results"] == first["results"]
              and r["schedule"] == first["schedule"],
              f"mesh {name}: results or schedule differ from fused_d1")
    for name, r in runs.items():
        snap, st = r["snap"], r["stats"]
        ticks = len(r["per_tick"])
        syncs = [s for _, _, s in r["per_tick"]]
        n_issue = sum(i[0] for i in r["issue"])
        if sum(syncs) == 0:
            sync_note = "not measured (the debug mode reported none)"
        else:
            check(n_issue == 0, f"mesh {name}: the issue path synchronised "
                  f"{n_issue} times")
            sync_note = (f"{sum(syncs) / ticks:.3f} a tick, 0 in the issue "
                         f"path")
        ph = snap["phase_ms"]
        print(f"mesh_serve_{name}: {snap['total_ops']} ops of "
              f"{snap['requests_completed']} requests in {r['wall']:.3f} s = "
              f"{snap['total_ops'] / r['wall']:.1f} ops/s (phase 8 host "
              f"engine: see serve_depth1); preload {r['load_s']:.3f} s; "
              f"{ticks} ticks; latency p50/p99 "
              f"{snap['request_latency_ticks']['p50']:.0f}/"
              f"{snap['request_latency_ticks']['p99']:.0f} ticks, "
              f"{snap['request_latency_ms']['p50']:.3f}/"
              f"{snap['request_latency_ms']['p99']:.3f} ms; stalls "
              f"{st['pipeline']['stalls']}; batch calls {st['batch_calls']}; "
              f"probe_perf launches {r['launches']['probe_perf']} = "
              f"{r['launches']['probe_perf'] / ticks:.3f} a tick (in every "
              f"issue one a probe phase and one a delete's find); "
              f"synchronises "
              f"{sync_note}; route_cap_totals {st['route_cap_totals']}; peak "
              f"device memory {r['peak']:.2f} GiB")
        print(f"mesh_phases_{name} (host ms mean/p50/p99 x count): "
              + "; ".join(f"{n} {x['mean']:.3f}/{x['p50']:.3f}/"
                          f"{x['p99']:.3f} x{x['count']}"
                          for n, x in sorted(ph.items())))
        busy, idle, rows, copies = r["profile"]
        lo, hi = SERVE_PROFILE
        writes = sum(kd in ("delete", "insert") for _, _, kinds in
                     r["issue"][lo:hi] for kd in kinds)
        check(copies, f"mesh {name}: the profile holds no pool copy")
        print(f"mesh_profile_{name}: ticks [{lo}, {hi}): wall "
              f"{r['profile_ms']:.3f} ms, device busy {busy:.3f} ms, idle "
              f"share {idle * 100:.1f}%; {len(copies)} stacked-pool copies "
              f"for {writes} write phases = "
              f"{len(copies) / max(writes, 1):.3f} a write phase, "
              f"{np.mean(copies):.4f} ms each ("
              f"{pool_bytes / np.mean(copies) / 1e9:.2f} TB/s of "
              f"{pool_bytes / 1e9:.3f} GB read and written; bound "
              f"{pool_bytes / HBM_RATE * 1e3:.4f} ms)")
        for ms_, count, key in rows:
            print(f"  {ms_:9.3f} ms x{count:<5d} {key}")
    print(f"mesh_time: phase 9 took {time.perf_counter() - t_phase:.3f} s; "
          f"card: {smi}")
    return probe_launches, first["launches"], digests


def leaf_digests(hashmap, hm) -> dict:
    """{leaf: [sha256 of shard d's bytes, ...]} of a stacked table (a
    rank's stack of one gives one)."""
    import hashlib
    return {n: [hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()
                for x in a] for n, a in hashmap.to_numpy(hm).items()}


# ---------------------------------------------------------------------------
# Main paths at paper scale
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Decode serving over the HashMem page table
# ---------------------------------------------------------------------------

DECODE_ARCHS = ("llama3-8b", "qwen3-8b", "phi4-mini-3.8b", "h2o-danube-1.8b")
DECODE_SMALL = (2, 32, 8)        # sequences, teacher-forced steps, page tokens
# float32 on both sides, summation order apart: JAX's own tolerance for
# decode against forward (tests/test_paged_kv.py)
DECODE_TOL = 5e-4
DECODE_SMALL_SERVE = dict(batch=4, requests=9, max_new=9, horizon=12,
                          page_tokens=2, prompt_len=2, backend="perf")
DECODE_ARCH = "qwen3-8b"         # published widths and depth, random init
DECODE_TF = (2, 64, 16)          # teacher-forced: sequences, tokens, page
# SHAPES["decode_32k"] (batch 128, horizon 32768) cut to one card: batch
# 16, horizon 4096 (KV 19.3 GB in float32 beside 32.8 GB of weights)
# two waves (pages recycle); the profiled serve 5 steps (with 15, phase 10
# took 101 s, ≈ 50 s of it after the timed serve: the trace is read
# slowly); 16 new tokens a request, 32 until PR 25 (the script took 883.6 s
# with phase 18 on a slow host, PR 25 chip run 5)
DECODE_SERVE = dict(batch=16, horizon=4096, page_tokens=32, requests=32,
                    prompt_len=8, max_new=16, backend="perf")
DECODE_CHECKED = DECODE_SERVE
DECODE_PROFILE = dict(DECODE_SERVE, requests=16, prompt_len=4, max_new=2)
# phase 15 against phase 10: the float32 teacher-forced logits of the first
# 8 steps of DECODE_TF (16 until PR 25, cut for time), and a one-wave serve
# whose top logits are kept
DECODE_RANK_DATA = ROOT / "build" / "decode_ranks"
DECODE_RANK_TF = 8
# the serve cut from 16 new tokens a request to 8 for time (the script
# took 727.2 s in PR 24 and phase 18 adds ≈ 75; PR 25)
DECODE_RANK_SERVE = dict(DECODE_SERVE, requests=16, max_new=8)
TOP_LOGITS = 8
BF16_U = 2.0 ** -8               # bfloat16 unit roundoff: 8 significant bits


def teacher_forced(model, params, cfg, tokens, bt, ctx, enc_frames=None):
    """Decode logits (S, B, V) for ``tokens`` (B, S), one step a token,
    through ``model.decode_step`` on fresh float32 pools (an encdec model's
    cross K/V from ``enc_frames``)."""
    import torch
    B, S = tokens.shape
    dev = params.embed.device
    states = model.init_decode_states(params, cfg, B, ctx,
                                      kv_dtype=torch.float32,
                                      enc_frames=enc_frames)
    tok = torch.from_numpy(tokens).to(dev)
    bt = torch.as_tensor(bt, device=dev)
    out = []
    for i in range(S):
        lg, states = model.decode_step(
            params, cfg, states, tok[:, i:i + 1],
            torch.full((B,), i, dtype=torch.int32, device=dev), bt, ctx)
        out.append(lg[:, 0])
    return torch.stack(out), states


def decode_ctx(model, configs, cfg, B, S, pt):
    scfg = configs.ServeConfig(model=cfg, shape=configs.ShapeConfig(
        "t", S, B, "decode"), kv_page_tokens=pt)
    return model.make_decode_ctx(cfg, scfg, B)


def traced_managers(paged_kv):
    """Patch ``PageTableManager.alloc_seqs``/``free_seqs`` to log each call
    (and the pages an allocation returned).  Returns (log, undo)."""
    cls = paged_kv.PageTableManager
    alloc, free = cls.alloc_seqs, cls.free_seqs
    log = []

    def alloc_seqs(self, reqs):
        out = alloc(self, reqs)
        log.append(("alloc", list(reqs),
                    {s: np.asarray(v).tolist() for s, v in out.items()}))
        return out

    def free_seqs(self, seq_ids):
        log.append(("free", list(seq_ids)))
        return free(self, seq_ids)

    cls.alloc_seqs, cls.free_seqs = alloc_seqs, free_seqs

    def undo():
        cls.alloc_seqs, cls.free_seqs = alloc, free
    return log, undo


def check_small_decode_vs_cpu(k):
    """(a) The four dense archs at ``smoke_config`` in float32, the same
    parameters on the card and the CPU: ``decode_step`` logits over 32
    teacher-forced steps and the KV pools; then a small ``serve()`` (perf
    page table) on both: the allocation and free trace, the steps, grow
    and compact events and the page-table leaves.  Returns the card's
    ``probe_perf`` launches in the serves."""
    from repro_torch import configs
    from repro_torch.models import model
    B, S, pt = DECODE_SMALL
    rng = np.random.default_rng(0)
    for arch in DECODE_ARCHS:
        cfg = configs.smoke_config(arch).replace(dtype="float32")
        tree = model.params_to_numpy(model.init_params(cfg, 0, "cpu"))
        tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        ctx = decode_ctx(model, configs, cfg, B, S, pt)
        bt = np.arange(B * ctx.n_pages, dtype=np.int32).reshape(B, -1)
        got = {}
        for dev in ("cuda", "cpu"):
            params = model.params_from_numpy(cfg, tree, dev)
            lg, states = teacher_forced(model, params, cfg, tokens, bt, ctx)
            got[dev] = (lg.cpu(), [s["k_pool"].cpu() for s in states])
        err = float((got["cuda"][0] - got["cpu"][0]).abs().max())
        kv_err = max(float((a - b).abs().max())
                     for a, b in zip(got["cuda"][1], got["cpu"][1]))
        check(err <= DECODE_TOL and kv_err <= DECODE_TOL,
              f"small decode {arch}: card vs CPU logits {err}, KV {kv_err}")
        print(f"small_decode {arch}: {S} steps x {B} sequences, card vs CPU "
              f"max |logit diff| {err:.3e}, max |KV diff| {kv_err:.3e} "
              f"(tolerance {DECODE_TOL})")

    return small_serve_vs_cpu(
        k, configs.smoke_config("llama3-8b").replace(dtype="float32"))


def small_serve_vs_cpu(k, cfg):
    """A small ``serve()`` of ``cfg`` (perf page table) on the card and on
    the CPU from the card's parameters: the allocation and free trace, the
    steps, grow and compact events and the page-table leaves must be
    equal.  Returns the card's ``probe_perf`` launches."""
    from repro_torch.core import hashmap, paged_kv
    from repro_torch.launch import serve
    from repro_torch.models import model
    card = model.init_params(cfg, 0, "cuda")
    tree = model.params_to_numpy(card)
    init = model.init_params
    out = {}
    reset_launches(k)
    for dev in ("cuda", "cpu"):
        log, undo = traced_managers(paged_kv)
        if dev == "cpu":   # the card's parameters, not the CPU generator's
            model.init_params = lambda c, seed, d: model.params_from_numpy(
                c, tree, d)
        try:
            done, mgr, steps = serve.serve(cfg, seed=0, verbose=False,
                                           device=dev, **DECODE_SMALL_SERVE)
        finally:
            undo()
            model.init_params = init
        out[dev] = (log, steps, mgr.grow_events, mgr.compact_events,
                    hashmap.to_numpy(mgr.hm), [r["out"] for r in done])
    launches = read_launches(k)["probe_perf"]
    (log, steps, grows, compacts, leaves, outs), cpu = out["cuda"], out["cpu"]
    check(log == cpu[0], "small serve: allocation/free traces differ")
    check((steps, grows, compacts) == cpu[1:4],
          "small serve: steps or grow/compact events differ")
    check(leaves.keys() == cpu[4].keys() and all(
        np.array_equal(leaves[n], cpu[4][n]) for n in leaves),
        "small serve: page-table leaves differ")
    check(launches > 0, "the small serve never launched probe_perf")
    same = sum(a == b for x, y in zip(outs, cpu[5]) for a, b in zip(x, y))
    print(f"small_serve {cfg.name} smoke: {len(outs)} requests in {steps} "
          f"steps, {sum(op == 'alloc' for op, *_ in log)} allocs and "
          f"{sum(op == 'free' for op, *_ in log)} frees; card equals CPU "
          f"(trace, steps, grows {grows}, compactions {compacts}, leaves); "
          f"tokens equal {same}/{sum(map(len, outs))}; probe_perf launches "
          f"{launches}")
    return launches


def check_decode_matches_forward(smi):
    """(b) Qwen3-8B at its published widths and depth, float32, TF32 off:
    two sequences of 64 tokens teacher-forced through ``decode_step`` on a
    block table probed from a ``perf`` PageTableManager, every position's
    logits against ``forward`` + ``logits_fn``.  Returns the parameters."""
    import torch
    from repro_torch import configs
    from repro_torch.core.paged_kv import PageTableManager
    from repro_torch.models import model
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are on: float32 decode would not be float32")
    cfg = configs.get_config(DECODE_ARCH).replace(dtype="float32")
    B, S, pt = DECODE_TF
    torch.cuda.reset_peak_memory_stats()
    params, init_s = host_s(lambda: model.init_params(cfg, 0, "cuda"))
    n_params = sum(p.numel() for p in params.parameters())
    ctx = decode_ctx(model, configs, cfg, B, S, pt)
    mgr = PageTableManager(ctx.pool_pages, backend="perf", device="cuda")
    phys = mgr.alloc_seqs([(s, ctx.n_pages, 0) for s in range(B)])
    bt = mgr.block_table(list(range(B)), ctx.n_pages)
    check(all(np.array_equal(bt[s], phys[s]) for s in range(B)),
          "the probed block table differs from the allocation")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    (dec, _), dec_s = host_s(lambda: teacher_forced(model, params, cfg,
                                                    tokens, bt, ctx))
    x, _ = model.forward(params, cfg, {"tokens": torch.from_numpy(
        tokens).cuda()})
    full = model.logits_fn(params, cfg, x).transpose(0, 1)
    err = (dec - full).abs()
    ok = torch.isclose(dec, full, rtol=DECODE_TOL, atol=DECODE_TOL)
    check(bool(torch.isfinite(dec).all()), "decode logits not finite")
    check(bool(ok.all()), f"decode != forward at {int((~ok).sum())} logits, "
          f"max |diff| {float(err.max())}")
    DECODE_RANK_DATA.mkdir(parents=True, exist_ok=True)
    np.save(DECODE_RANK_DATA / "tf_logits.npy",
            dec[:DECODE_RANK_TF].cpu().numpy())
    print(f"decode_vs_forward {DECODE_ARCH}: {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
          f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
          f"(padded {cfg.padded_vocab}); {n_params} float32 params "
          f"({n_params * 4 / 1e9:.3f} GB) drawn on the card in {init_s:.3f} "
          f"s; {B} x {S} tokens teacher-forced in {dec_s:.3f} s; every "
          f"position's logits within {DECODE_TOL} of forward: max |diff| "
          f"{float(err.max()):.3e}, largest |logit| "
          f"{float(full.abs().max()):.3f}; TF32 off; "
          f"block table probed through probe_perf; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card: {smi}")
    del params, dec, full, x
    torch.cuda.empty_cache()


class DecodeTimer:
    """Host clocks around the serving loop's model step (ended by a
    synchronise) and the page table's ``alloc_seqs``, ``free_seqs`` and
    ``tick``, installed by patching ``steps.build_serve_step`` and the
    manager's methods for the length of a ``with`` block.  With ``check``
    every step's logits must be finite and every admission's probed block
    table must equal its allocation, and ``probe_perf`` must equal its
    plain version on every live key of the table."""

    def __init__(self, k=None, ref=None, check_tables=False):
        self.k, self.ref, self.check_tables = k, ref, check_tables
        self.step_ms, self.table_ms, self.t_first = [], 0.0, None
        self.admissions = self.keys_checked = 0

    def __enter__(self):
        import torch
        from repro_torch.core.paged_kv import PageTableManager
        from repro_torch.distributed import steps
        self._build = steps.build_serve_step
        cls = PageTableManager
        self._orig = {n: getattr(cls, n) for n in ("alloc_seqs",
                                                   "free_seqs", "tick")}
        timer = self

        def build_serve_step(*a, **kw):
            step, ctx = timer._build(*a, **kw)

            def timed(params, states, tokens, pos, bt, **kw):
                t0 = time.perf_counter()
                timer.t_first = timer.t_first or t0
                out = step(params, states, tokens, pos, bt, **kw)
                if timer.check_tables:
                    check(bool(torch.isfinite(out[1]).all()),
                          "decode logits not finite")
                sync()
                timer.step_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            return timed, ctx

        def timed_method(name):
            orig = self._orig[name]

            def method(mgr, *a):
                t0 = time.perf_counter()
                out = orig(mgr, *a)
                timer.table_ms += (time.perf_counter() - t0) * 1e3
                if name == "alloc_seqs" and timer.check_tables and a[0]:
                    timer.check_admission(mgr, a[0], out)
                return out
            return method

        steps.build_serve_step = build_serve_step
        for n in self._orig:
            setattr(cls, n, timed_method(n))
        return self

    def __exit__(self, *exc):
        from repro_torch.core.paged_kv import PageTableManager
        from repro_torch.distributed import steps
        steps.build_serve_step = self._build
        for n, f in self._orig.items():
            setattr(PageTableManager, n, f)

    def check_admission(self, mgr, reqs, phys):
        """The probed table against the allocator, and ``probe_perf``
        against its plain version on every live key of the table."""
        from repro_torch.core import hashmap
        from repro_torch.core.hashing import as_u32
        from repro_torch.core.layout import to_bits
        n = max(nb for _, nb, _ in reqs)
        ids = [s for s, _, _ in reqs]
        bt = mgr.block_table(ids, n)
        check(all(np.array_equal(bt[i][:len(phys[s])], phys[s])
                  for i, s in enumerate(ids)),
              "a probed block table differs from its allocation")
        keys = np.asarray([mgr._key(s, j) for s, own in mgr.owned.items()
                           for j in range(len(own))], np.uint32)
        q = as_u32(keys, mgr.hm.device)
        pages = hashmap.resolve_pages(mgr.hm, q)
        pool = mgr.hm.store.pool
        out = self.k["probe_perf"](pool, to_bits(q), pages)
        plain = self.ref.probe_pages_ref(pool, to_bits(q), pages)
        mis, _ = mismatch(out, plain)
        check(mis == 0, f"probe_perf != plain on {mis} page-table keys")
        want = np.concatenate([np.asarray(mgr.owned[s]) for s in mgr.owned])
        check(np.array_equal(out[:, 0].cpu().numpy(), want.astype(np.int32))
              and bool((out[:, 1] != 0).all()),
              "probe_perf does not resolve every live page")
        self.admissions += 1
        self.keys_checked += keys.size


def served_run(serve, k, ref=None, check_tables=False, profile=False,
               cfg=None, **kw):
    """One ``serve()`` of ``cfg`` (None: Qwen3-8B at its published widths)
    under a ``DecodeTimer``; with ``profile`` inside a ``torch.profiler``
    window.  Returns (done, mgr, steps, timer, probe_perf launches, wall s
    of the loop, peak GiB, profiler or None)."""
    import torch
    from repro_torch import configs
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    cfg = cfg or configs.get_config(DECODE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(k)
    prof = torch_profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) \
        if profile else None
    with DecodeTimer(k, ref, check_tables) as timer:
        if prof is not None:
            prof.__enter__()
        try:
            done, mgr, steps = serve.serve(cfg, seed=0, verbose=False,
                                           device="cuda", **kw)
            sync()
            wall = time.perf_counter() - timer.t_first
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
    launches = read_launches(k)["probe_perf"]
    return (done, mgr, steps, timer, launches, wall,
            torch.cuda.max_memory_allocated() / 2**30, prof)


def check_served(cfg, done, mgr, kw, what):
    check(len(done) == kw["requests"], f"{what}: {len(done)} requests done")
    check(all(len(r["out"]) == kw["max_new"] for r in done),
          f"{what}: a request ended short of max_new")
    check(all(0 <= t < cfg.padded_vocab for r in done for t in r["out"]),
          f"{what}: a token past the padded vocabulary")
    check(mgr.live_pages() == 0, f"{what}: live pages after the drain")
    check(all(len(a) == mgr.pps for a in mgr.free),
          f"{what}: an arena is not full after the drain")


def dryrun_line(label, traced, peak_gib, step_ms, smi):
    """Print the dry-run's record of a phase's own cut cell (one device,
    traced on fake tensors: ``dryrun.trace_decode``/``trace_train``)
    beside what the card measured: its peak memory and its median step."""
    from repro_torch.launch import dryrun
    rec = dryrun.analyze(traced, {})
    gib = {k: rec[f"{k}_bytes"] / 2**30
           for k in ("params", "opt", "state", "batch")}
    est = rec["peak_memory_in_bytes"] / 2**30
    print(f"{label}: the dry-run's record of this cell (one device, fake "
          f"tensors, traced in {rec['trace_s']:.1f} s): arguments "
          f"{rec['argument_size_in_bytes'] / 2**30:.3f} GiB (parameters "
          f"{gib['params']:.3f}, optimizer {gib['opt']:.3f}, states "
          f"{gib['state']:.3f}, batch {gib['batch']:.6f}), estimated peak "
          f"{est:.3f} GiB against the measured {peak_gib:.3f} GiB "
          f"({est / peak_gib * 100:.1f}%); {rec['flops_per_device']:.4e} "
          f"FLOPs a step (matmuls), "
          f"{rec['flops_per_device'] / (step_ms / 1e3) / 1e12:.1f} TFLOP/s "
          f"at the measured median step of {step_ms:.3f} ms; "
          f"{rec['bytes_per_device'] / 1e9:.3f} GB of eager op traffic; "
          f"card: {smi}")


class TopLogits:
    """Patch ``model.logits_fn`` for the length of a ``with`` block to keep,
    every call, each row's ``TOP_LOGITS`` largest logits (values, indices)
    and, for each of those tokens v, S_v = sum_i |h_i W_v,i|, h the final
    hidden state as ``logits_fn`` rounds it: a bfloat16 rounding of h
    (relative error up to ``BF16_U`` an element) moves logit v by at most
    ``BF16_U * S_v``."""

    def __enter__(self):
        import torch
        from repro_torch.models import model
        from repro_torch.models.layers import rms_norm
        self._orig = orig = model.logits_fn
        self.steps = []

        def logits_fn(params, cfg, x):
            lg = orig(params, cfg, x)
            h = rms_norm(x[:, -1], params.final_norm.scale, cfg.norm_eps)
            top = lg[:, -1].topk(TOP_LOGITS, dim=-1)
            w = model._head(params, cfg)[top.indices].float().abs()
            s_v = (h.float().abs()[:, None, :] * w).sum(-1)
            self.steps.append(torch.stack(
                [top.values, top.indices.float(), s_v]).cpu())
            return lg
        model.logits_fn = logits_fn
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model
        model.logits_fn = self._orig


def rank_reference_serve(serve, k, cfg):
    """The one-card serve that phase 15 holds the ranks' tokens against:
    ``DECODE_RANK_SERVE`` (one wave: request b in slot b, its output i from
    step prompt_len - 1 + i), each step's top logits kept
    (``TopLogits``), saved under ``build/``."""
    kw = DECODE_RANK_SERVE
    check(kw["requests"] == kw["batch"], "the reference serve is one wave")
    with TopLogits() as top:
        done, mgr, steps, timer, _, wall, _, _ = served_run(serve, k, **kw)
    check_served(cfg, done, mgr, kw, "reference serve")
    outs = np.asarray([r["out"] for r in sorted(done,
                                                key=lambda r: r["id"])])
    np.savez(DECODE_RANK_DATA / "serve_ref.npz", outs=outs,
             top=np.stack([t.numpy() for t in top.steps]),
             step_ms=np.asarray(timer.step_ms))
    print(f"decode_rank_reference: {kw['requests']} requests of prompt "
          f"{kw['prompt_len']} + {kw['max_new']} new in {steps} steps on one "
          f"card, median {float(np.median(timer.step_ms)):.3f} ms a step; "
          f"the top {TOP_LOGITS} logits of every step kept for phase 15")


def decode_path(k, ref, smi):
    """Phase 10: LM decode serving over the HashMem page table."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import dryrun, serve
    t0 = time.perf_counter()
    small_launches = check_small_decode_vs_cpu(k)
    t1 = time.perf_counter()
    check_decode_matches_forward(smi)
    t2 = time.perf_counter()
    cfg = configs.get_config(DECODE_ARCH)

    done, mgr, steps, timer, _, _, _, _ = served_run(
        serve, k, ref, check_tables=True, **DECODE_CHECKED)
    check_served(cfg, done, mgr, DECODE_CHECKED, "checked serve")
    checked_out = {r["id"]: r["out"] for r in done}
    print(f"decode_checked: {len(done)} requests, {steps} steps, every "
          f"step's logits finite; at {timer.admissions} admissions the "
          f"probed block tables equal the allocator's and probe_perf equals "
          f"plain bit for bit on {timer.keys_checked} page-table keys; "
          f"(a) {t1 - t0:.3f} s, (b) {t2 - t1:.3f} s, checked serve "
          f"{time.perf_counter() - t2:.3f} s")

    done, mgr, steps, timer, launches, wall, peak, _ = served_run(
        serve, k, **DECODE_SERVE)
    check_served(cfg, done, mgr, DECODE_SERVE, "timed serve")
    check(all(r["out"] == checked_out[r["id"]] for r in done
              if r["id"] in checked_out),
          "the timed serve's tokens differ from the checked one's")
    check(launches > 0, "the decode path never launched probe_perf")
    gen = sum(len(r["out"]) for r in done)
    st = [s for s in timer.step_ms]
    B, pt = DECODE_SERVE["batch"], DECODE_SERVE["page_tokens"]
    n_pages = DECODE_SERVE["horizon"] // pt
    bound_ms, w_bytes, kv_bytes, _ = decode_bound(cfg, DECODE_SERVE)
    med = float(np.median(st))
    print(f"decode_serve {DECODE_ARCH} (params float32, activations bfloat16,"
          f" KV float32): batch {B}, horizon {DECODE_SERVE['horizon']}, "
          f"page_tokens {pt} ({n_pages} pages a sequence, pool {B * n_pages} "
          f"pages, KV {kv_bytes / 1e9:.3f} GB), {len(done)} requests of "
          f"prompt {DECODE_SERVE['prompt_len']} + {DECODE_SERVE['max_new']} "
          f"new, backend perf; {steps} decode steps, {gen} tokens in "
          f"{wall:.3f} s = {gen / wall:.1f} generated tokens/s; step ms "
          f"median {med:.3f} (min {min(st):.3f}, max {max(st):.3f}) against "
          f"a bound of {bound_ms:.3f} ms (weights {w_bytes / 1e9:.3f} GB + "
          f"KV {kv_bytes / 1e9:.3f} GB at {HBM_RATE / 1e12:.2f} TB/s; "
          f"{bound_ms / med * 100:.1f}% of bound); page-table host ms a step "
          f"{timer.table_ms / steps:.4f} (alloc_seqs + free_seqs + tick, "
          f"{timer.table_ms:.3f} ms in all); probe_perf launches {launches} "
          f"= {launches / steps:.4f} a step; grows {mgr.grow_events}, "
          f"compactions {mgr.compact_events}; peak {peak:.2f} GiB; "
          f"card: {smi}")
    dryrun_line("decode_dryrun", dryrun.trace_decode(
        cfg, configs.ServeConfig(model=cfg, shape=configs.ShapeConfig(
            "serve", DECODE_SERVE["horizon"], B, "decode"),
            kv_page_tokens=pt), None, kv_dtype=torch.float32), peak, med,
        smi)

    rank_reference_serve(serve, k, cfg)

    done, mgr, psteps, _, _, pwall, _, prof = served_run(
        serve, k, profile=True, **DECODE_PROFILE)
    check_served(cfg, done, mgr, DECODE_PROFILE, "profiled serve")
    busy, idle, rows, _ = device_profile(prof, pwall)
    check(busy > 0, "the profiled serve shows no device time")
    print(f"decode_profile: {psteps} steps under torch.profiler, wall "
          f"{pwall * 1e3:.3f} ms, device busy {busy:.3f} ms, idle "
          f"{idle * 100:.1f}%; top kernels:")
    for ms, n, name in rows:
        print(f"  {ms:10.3f} ms x{n:<6d} {name}")
    del prof
    print(f"decode_path: {time.perf_counter() - t0:.3f} s; card: {smi}")
    return launches, small_launches, dict(steps=steps, median_ms=med,
                                          bound_ms=bound_ms)


# ---------------------------------------------------------------------------
# Training and checkpoint
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ("llama3-8b", "qwen3-8b", "h2o-danube-1.8b")
TRAIN_SMALL = (4, 64, 4)         # batch, sequence, steps (smoke, float32)
TRAIN_WINDOW = 12                # h2o's smoke window, which 64 tokens pass
TRAIN_OC = dict(lr=1e-3, warmup_steps=2, total_steps=16)
# card vs CPU, both float32 with TF32 off, summation order apart: losses and
# grad norms within 1e-5 relative; parameters within 1e-3 (one AdamW step
# at the peak rate moves an element by at most lr) and at most 1e-4 of them
# beyond 1e-5 (AdamW's normalisation magnifies gradient noise on elements
# whose gradient is near eps; the port against JAX on the CPU: 3-5 of 788k
# elements beyond 1e-5 after 4 steps, none beyond 1e-4)
TRAIN_TOL = dict(loss=1e-5, params=1e-3, params_fine=1e-5, share=1e-4)
TRAIN_RESTART = dict(arch="qwen3-8b", seq=64, batch=4, steps=16, every=4,
                     inject=10)
TRAIN_ARCH = "h2o-danube-1.8b"   # published widths, random init
# SHAPES["train_4k"] (seq 4096, batch 256) cut to batch 4 for one card, and
# to 4 of 24 layers and 6 steps: at 24 layers and 8 steps (a 22.0 GB state
# written three times) (d) took 193 s of the script's 1200, at 8 layers
# 69.8 s of a 941.7 s script on a slow host (PR 24), past its 800
TRAIN_FULL = dict(seq=4096, batch=4, depth=4, steps=6, ckpt_at=4,
                  profile_steps=1)
CKPT_ROOT = ROOT / "build" / "chip_smoke_ckpt"


def small_train_run(cfg, tree, dev):
    """4 train steps of ``cfg`` from the parameter tree ``tree`` on
    ``dev``: (losses, grad norms, final parameter tree)."""
    import torch
    from repro_torch.configs import OptimConfig, ShapeConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import steps
    from repro_torch.models import model
    from repro_torch.optim import init_opt_state
    B, S, n = TRAIN_SMALL
    oc = OptimConfig(**TRAIN_OC)
    params = model.params_from_numpy(cfg, tree, dev)
    opt = init_opt_state(params, oc)
    step = steps.build_train_step(cfg, oc)
    data = SyntheticLMData(cfg, ShapeConfig("t", S, B, "train"))
    losses, norms = [], []
    for s in range(n):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(s).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return losses, norms, model.params_to_numpy(params)


def check_small_train_vs_cpu(smi, archs=TRAIN_ARCHS, tols=None):
    """(a) ``archs`` at ``smoke_config`` in float32, TF32 off: the same
    parameters (drawn on the CPU, carried by ``params_to_numpy``) and the
    same batches, 4 train steps on the card and on the CPU.  ``tols`` maps
    an arch to its tolerances (default ``TRAIN_TOL``); with ``tight_steps``
    the losses after that many steps are held to ``loss_late`` and the grad
    norms to ``norm_late``."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.models.layers import flatten_tree
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are on: float32 training would not be float32")
    for arch in archs:
        cfg = configs.smoke_config(arch).replace(dtype="float32")
        if cfg.sliding_window:
            cfg = cfg.replace(sliding_window=TRAIN_WINDOW)
        tree = model.params_to_numpy(model.init_params(cfg, 0, "cpu"))
        tol = (tols or {}).get(arch, TRAIN_TOL)
        (cl, cn, cp), (hl, hn, hp) = (small_train_run(cfg, tree, d)
                                      for d in ("cuda", "cpu"))
        rl = [abs(a - b) / abs(b) for a, b in zip(cl, hl)]
        rn = [abs(a - b) / abs(b) for a, b in zip(cn, hn)]
        n = tol.get("tight_steps", len(rl))
        loss_err = max(rl[:n] + rn[:n])
        late_err, norm_err = max(rl[n:], default=0.0), max(rn[n:], default=0.0)
        cp, hp = flatten_tree(cp), flatten_tree(hp)
        d = np.concatenate([np.abs(cp[k] - hp[k]).ravel() for k in hp])
        beyond = int((d > tol["params_fine"]).sum())
        check(all(np.isfinite(cl)), f"small train {arch}: a loss not finite")
        check(loss_err <= tol["loss"] and
              late_err <= tol.get("loss_late", tol["loss"]) and
              norm_err <= tol.get("norm_late", tol["loss"]),
              f"small train {arch}: card vs CPU losses {rl}, grad norms {rn}")
        check(d.max() <= tol["params"]
              and beyond <= tol["share"] * d.size,
              f"small train {arch}: card vs CPU params max {d.max()}, "
              f"{beyond} of {d.size} beyond {tol['params_fine']}")
        late = (f", steps {n}-{len(rl) - 1}: losses {late_err:.3e} "
                f"(tolerance {tol['loss_late']}), grad norms {norm_err:.3e} "
                f"(tolerance {tol['norm_late']})") if n < len(rl) else ""
        print(f"small_train {arch}: {TRAIN_SMALL[2]} steps of {TRAIN_SMALL[0]}"
              f" x {TRAIN_SMALL[1]} tokens, float32, TF32 off; card losses "
              f"{[round(v, 6) for v in cl]}; card vs CPU: max relative "
              f"loss/grad-norm diff {loss_err:.3e} (tolerance "
              f"{tol['loss']}){late}, params max |diff| {d.max():.3e} "
              f"(tolerance {tol['params']}), {beyond} of {d.size} "
              f"beyond {tol['params_fine']}; card: {smi}")


def check_restart_on_card(smi, r=TRAIN_RESTART):
    """(b) ``tests/test_train_integration.py``'s restart on the card: an
    uninterrupted run and one with a failure injected at step 10 (a
    checkpoint every 4 steps) give bit-equal losses, parameters and
    moments."""
    import shutil
    import torch
    from repro_torch import configs
    from repro_torch.launch.train import train
    cfg = configs.smoke_config(r["arch"])
    shape = configs.ShapeConfig("t", r["seq"], r["batch"], "train")
    oc = configs.OptimConfig(**TRAIN_OC)
    runs = {}
    t0 = time.perf_counter()
    for name, inject in (("plain", None), ("failed", [r["inject"]])):
        d = CKPT_ROOT / f"restart_{name}"
        shutil.rmtree(d, ignore_errors=True)
        runs[name] = train(cfg, shape, oc, num_steps=r["steps"],
                           ckpt_dir=str(d), ckpt_every=r["every"],
                           inject=inject, verbose=False, device="cuda")
    (p0, o0, l0, _, _), (p1, o1, l1, _, pol) = runs["plain"], runs["failed"]
    check(pol.restarts == 1, "the injected failure did not restart")
    check(l0 == l1, "the restarted run's losses differ from the plain run's")
    check(all(torch.equal(a, b) for a, b in zip(p0.parameters(),
                                                p1.parameters())),
          "the restarted run's parameters differ")
    check(all(torch.equal(o0[m][n], o1[m][n]) for m in ("m", "v")
              for n in o0[m]), "the restarted run's moments differ")
    print(f"restart {r['arch']} smoke ({cfg.dtype} activations): "
          f"{r['steps']} steps, failure injected at step {r['inject']}, "
          f"checkpoint every {r['every']}: losses, parameters and moments "
          f"bit-equal to the uninterrupted run's (losses "
          f"{[round(l0[s], 5) for s in (0, 8, 15)]} at steps 0/8/15); "
          f"{time.perf_counter() - t0:.3f} s; card: {smi}")


def table_leaves(hashmap, hm):
    return {n: (hm.bucket_head if n == "bucket_head" else
                getattr(hm.store, n))
            for n in hashmap.leaf_names(hm.config)}


def checkpoint_paper_table(hashmap, cfg, keys, vals, probes, pidx, k, smi):
    """(c) The phase 4 ``perf`` table at PAPER_HASHMEM (100M pairs) through
    the port's ``Checkpointer``: saved, restored to the card, leaves equal,
    and the 10M paper probes through ``probe_perf`` equal before and after.
    Returns the ``probe_perf`` launches of the two probes."""
    import shutil
    import torch
    from repro_torch.checkpoint import Checkpointer
    hm = hashmap.build(cfg, keys, vals)
    reset_launches(k)
    v0, f0 = hashmap.probe(hm, probes)
    d = CKPT_ROOT / "table"
    shutil.rmtree(d, ignore_errors=True)
    ck = Checkpointer(str(d), async_save=False)
    _, save_s = host_s(lambda: ck.save(1, hm))
    target = hashmap.create(cfg)
    got, restore_s = host_s(lambda: ck.restore(1, target, device="cuda"))
    del target
    have, want = table_leaves(hashmap, got), table_leaves(hashmap, hm)
    check(have.keys() == want.keys() and all(
        torch.equal(have[n], want[n]) for n in want),
        "the restored table's leaves differ from the saved table's")
    v1, f1 = hashmap.probe(got, probes)
    launches = read_launches(k)["probe_perf"]
    check(torch.equal(v0, v1) and torch.equal(f0, f1),
          "probes of the restored table differ from those before the save")
    check(bool(f1.all()) and np.array_equal(
        v1.cpu().numpy().astype(np.uint32), vals[pidx]),
        "the restored table lost built keys")
    check(launches >= 2, "the table's probes did not launch probe_perf")
    nbytes = sum(t.numel() * t.element_size() for t in want.values())
    files = sum(f.stat().st_size for f in (d / "step_00000001").iterdir())
    print(f"ckpt_table: PAPER_HASHMEM perf table ({N_BUILD} pairs, "
          f"{nbytes / 1e9:.3f} GB of leaves, {files / 1e9:.3f} GB of files) "
          f"saved in {save_s:.3f} s ({nbytes / save_s / 1e9:.2f} GB/s: copy "
          f"to host, .npy, sha256, fsync, rename) and restored to the card in "
          f"{restore_s:.3f} s ({nbytes / restore_s / 1e9:.2f} GB/s: read, "
          f"sha256, copy to the card); leaves equal; {probes.size} paper "
          f"probes through probe_perf equal before and after, every built "
          f"key found with its value; probe_perf launches {launches}; "
          f"card: {smi}")
    del hm, got, v0, f0, v1, f1
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


class CkptTimer:
    """Host clocks around ``Checkpointer.save`` (for an asynchronous save,
    the snapshot to host memory), ``_write`` (files, sha256, fsync, rename:
    the writer thread's work) and ``restore``, installed by patching the
    class for the length of a ``with`` block."""

    NAMES = ("save", "_write", "restore")

    def __enter__(self):
        from repro_torch.checkpoint import Checkpointer
        self._orig = {n: getattr(Checkpointer, n) for n in self.NAMES}
        self.seconds = {n: [] for n in self.NAMES}
        for n, f in self._orig.items():
            setattr(Checkpointer, n, self._timed(n, f))
        return self

    def _timed(self, name, f):
        def method(ck, *a, **kw):
            t0 = time.perf_counter()
            out = f(ck, *a, **kw)
            self.seconds[name].append(time.perf_counter() - t0)
            return out
        return method

    def __exit__(self, *exc):
        from repro_torch.checkpoint import Checkpointer
        for n, f in self._orig.items():
            setattr(Checkpointer, n, f)


def kernel_groups(prof) -> dict:
    """Device ms of a profile's kernels in three groups: float32 matmuls
    (FFMA GEMMs and GEMVs: no tensor cores without TF32), the other
    matmuls (tensor-core GEMMs, bfloat16 here), and the rest (elementwise
    ops, reductions, copies, gathers)."""
    from torch.autograd import DeviceType
    out = {"float32 matmul": 0.0, "bf16 matmul": 0.0, "elementwise/other": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        if any(t in e.key for t in ("f32f32", "sgemm", "gemmSN", "Gemv")):
            group = "float32 matmul"
        elif "gemm" in e.key or "nvjet" in e.key:
            group = "bf16 matmul"
        else:
            group = "elementwise/other"
        out[group] += e.self_device_time_total / 1e3
    return out


def train_full_width(smi):
    """(d) h2o-danube-1.8b at its published widths, ``TRAIN_FULL``'s depth
    (random init from seed 0 on the card; params float32, activations
    bfloat16, AdamW states float32, remat on) trains ``TRAIN_FULL``'s steps
    at batch 4 x 4096 through ``launch.train.train`` with a checkpoint at
    ``ckpt_at``; a second ``train`` resumes from it and its last steps and
    its final state must equal the first run's bit for bit; then one
    profiled step."""
    import json
    import os
    import shutil
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from repro_torch import configs
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import steps
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import train
    f = TRAIN_FULL
    cfg = configs.get_config(TRAIN_ARCH).replace(num_layers=f["depth"])
    B, S = f["batch"], f["seq"]
    shape = configs.ShapeConfig("train_4k_cut", S, B, "train")
    # the CLI's schedule for an 8-step run (warmup steps // 5 + 1)
    oc = configs.OptimConfig(lr=3e-4, warmup_steps=f["steps"] // 5 + 1,
                             total_steps=f["steps"])
    mm, attn, n_params, _ = train_flops(cfg, B, S)
    state_gb = n_params * 12 / 1e9
    a, b = CKPT_ROOT / "full_a", CKPT_ROOT / "full_b"
    for d in (a, b):
        shutil.rmtree(d, ignore_errors=True)
    CKPT_ROOT.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(CKPT_ROOT).free
    mem = {ln.split(":")[0]: int(ln.split()[1]) * 1024 for ln in
           Path("/proc/meminfo").read_text().splitlines()}
    print(f"train_full: {TRAIN_ARCH} {cfg.num_layers} of "
          f"{configs.get_config(TRAIN_ARCH).num_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded "
          f"{cfg.padded_vocab}), window {cfg.sliding_window}; {n_params} "
          f"params, {state_gb:.3f} GB of params and moments a checkpoint; "
          f"free disk {free / 1e9:.1f} GB, host memory available "
          f"{mem.get('MemAvailable', 0) / 1e9:.1f} GB")
    check(free > 2.2 * state_gb * 1e9, "too little disk for two checkpoints")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with CkptTimer() as ta:
        pa, oa, la, mon, _ = train(cfg, shape, oc, num_steps=f["steps"],
                                   ckpt_dir=str(a), ckpt_every=f["ckpt_at"],
                                   log_every=1, device="cuda")
    run_a = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [la[s] for s in range(f["steps"])]
    check(all(np.isfinite(losses)), f"a full-width loss is not finite: "
          f"{losses}")
    check(losses[-1] < losses[0], f"the full-width loss did not fall: "
          f"{losses}")
    final = f"step_{f['steps']:08d}"
    want = json.loads((a / final / "manifest.json").read_text())
    shutil.rmtree(a / final)
    b.mkdir(parents=True)
    os.rename(a / f"step_{f['ckpt_at']:08d}", b / f"step_{f['ckpt_at']:08d}")
    del pa, oa
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    with CkptTimer() as tb:
        pb, ob, lb, _, _ = train(cfg, shape, oc, num_steps=f["steps"],
                                 ckpt_dir=str(b), ckpt_every=f["ckpt_at"],
                                 log_every=1, device="cuda")
    run_b = time.perf_counter() - t1
    got = json.loads((b / final / "manifest.json").read_text())
    check(sorted(lb) == list(range(f["ckpt_at"], f["steps"])),
          f"the resumed run ran steps {sorted(lb)}")
    check(all(lb[s] == la[s] for s in lb),
          "the resumed steps' losses differ from the uninterrupted run's")
    check(got == want, "the resumed run's final checkpoint (params, moments, "
          "step) differs from the uninterrupted run's")

    step_fn = steps.build_train_step(cfg, oc)
    data = SyntheticLMData(cfg, shape)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                data.batch_at(f["steps"] + i).items()}
               for i in range(f["profile_steps"])]
    sync()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        for batch in batches:
            pb, ob, _ = step_fn(pb, ob, batch)
        sync()
        pwall = time.perf_counter() - tp
    busy, idle, rows, _ = device_profile(prof, pwall, top=12)
    groups = kernel_groups(prof)
    check(busy > 0, "the profiled train step shows no device time")
    del pb, ob, prof, batches
    torch.cuda.empty_cache()
    shutil.rmtree(a, ignore_errors=True)
    shutil.rmtree(b, ignore_errors=True)

    step_ms = [t * 1e3 for t in mon.times]
    med = float(np.median(step_ms))
    tokens = B * S
    flops = mm + attn
    share = flops / (med / 1e3) / BF16_RATE
    snap = ta.seconds["save"][0]          # the async step-6 save: snapshot
    writes = ta.seconds["_write"] + tb.seconds["_write"]
    restore = tb.seconds["restore"][0]
    print(f"train_full: batch {B} x seq {S} ({tokens} tokens a step; "
          f"SHAPES['train_4k'] is batch 256), params float32, activations "
          f"{cfg.dtype}, AdamW float32, remat {cfg.remat}; losses "
          f"{[round(v, 4) for v in losses]}; step ms "
          f"{[round(v, 1) for v in step_ms]}; median {med:.1f} ms = "
          f"{tokens / med * 1e3:.1f} tokens/s; {flops / 1e12:.2f} TFLOP a "
          f"step ({mm / 1e12:.2f} matmul + {attn / 1e12:.2f} causal "
          f"attention) = {flops / (med / 1e3) / 1e12:.1f} TFLOP/s, "
          f"{share * 100:.2f}% of the {BF16_RATE / 1e12:.0f} TFLOP/s bf16 "
          f"dense peak; peak memory {peak:.2f} GiB; run {run_a:.1f} s; "
          f"card: {smi}")
    dryrun_line("train_dryrun", dryrun.trace_train(cfg, oc, shape), peak,
                med, smi)
    print(f"train_ckpt: {state_gb:.3f} GB a checkpoint; snapshot to host "
          f"{snap:.3f} s ({state_gb / snap:.2f} GB/s); writes (.npy, sha256, "
          f"fsync, rename; {len(writes)} of them) "
          f"{', '.join(f'{w:.3f}' for w in writes)} s "
          f"({state_gb / max(writes):.2f}-{state_gb / min(writes):.2f} GB/s); "
          f"restore (read, sha256, to the card) {restore:.3f} s "
          f"({state_gb / restore:.2f} GB/s); resumed run {run_b:.1f} s: steps "
          f"{f['ckpt_at']}-{f['steps'] - 1} losses and the final checkpoint's "
          f"{len(got['arrays'])} sha256 equal the uninterrupted run's; card: "
          f"{smi}")
    print(f"train_profile: {f['profile_steps']} step(s) under torch.profiler, "
          f"wall {pwall * 1e3:.1f} ms, device busy {busy:.1f} ms, idle "
          f"{idle * 100:.1f}%; by group: " + ", ".join(
              f"{g} {ms:.1f} ms ({ms / busy * 100:.1f}%)"
              for g, ms in groups.items()) + f"; card: {smi}; top kernels:")
    for ms, n, name in rows:
        print(f"  {ms:10.3f} ms x{n:<6d} {name}")
    return dict(median_ms=med, share=share, peak=peak, idle=idle)


def training_path(hashmap, cfg, keys, vals, probes, pidx, k, smi):
    """Phase 11: training and the checkpoint."""
    import shutil
    t0 = time.perf_counter()
    try:
        check_small_train_vs_cpu(smi)
        t1 = time.perf_counter()
        check_restart_on_card(smi)
        t2 = time.perf_counter()
        launches = checkpoint_paper_table(hashmap, cfg, keys, vals, probes,
                                          pidx, k, smi)
        t3 = time.perf_counter()
        full = train_full_width(smi)
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    print(f"training_path: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
          f"{t3 - t2:.1f} s, (d) {time.perf_counter() - t3:.1f} s; card: {smi}")
    return launches, full


# ---------------------------------------------------------------------------
# The moe and hybrid families
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("olmoe-1b-7b", "jamba-v0.1-52b", "llama4-maverick-400b-a17b")
FAMILY_TRAIN_ARCHS = ("olmoe-1b-7b", "jamba-v0.1-52b")
FAMILY_SMALL = (2, 64)           # sequences, tokens of the module checks
# card vs CPU, float32 with TF32 off, summation order apart: the port
# against JAX on the CPU gives <= 1.4e-6 (MoE) and <= 6.8e-8 (mamba), so
# 1e-5 absolute on outputs, 1e-5 relative on the aux terms; routing
# indices, keep masks and moe_dropped exact
FAMILY_TOL = 1e-5
MOE_MODES = (("learned", "learned", {}), ("hash", "hash", {}),
             ("drop", "learned", dict(capacity_factor=0.25)))
FAMILY_RESTART = dict(TRAIN_RESTART, arch="olmoe-1b-7b")
HYBRID_ARCH = "jamba-v0.1-52b"   # published widths, random init
HYBRID_DEPTH = 8                 # of 32: one unit, 13.3B params, 53.2 GB
HYBRID_TF = (2, 64, 16)          # teacher-forced: sequences, tokens, page
HYBRID_SERVE = dict(batch=16, horizon=4096, page_tokens=32, requests=32,
                    prompt_len=8, max_new=16, backend="perf")
MOE_ARCH = "olmoe-1b-7b"         # published widths and depth, random init
# SHAPES["decode_32k"] (batch 128, horizon 32768) cut to one card as phase
# 10 cuts it: batch 16, horizon 4096 (KV 17.2 GB beside 27.7 GB of
# weights); 16 new tokens a request as phase 10 (32 until PR 25)
MOE_SERVE = dict(batch=16, horizon=4096, page_tokens=32, requests=32,
                 prompt_len=8, max_new=16, backend="perf")
MOE_CHECKED = MOE_SERVE
MOE_PROFILE = dict(MOE_SERVE, requests=16, prompt_len=4, max_new=2)
# SHAPES["train_4k"] cut to batch 4 and 4 of 16 layers (4 layers peaked at
# 47.56 GiB, and each 2 more add 13.4 GB, so 8 would pass 72 GiB; 16 would
# need 111 GB; 6 layers took 33.6 s of a 941.7 s script, PR 24)
MOE_TRAIN = dict(depth=4, seq=4096, batch=4, steps=8)


def check_family_modules_vs_cpu(smi):
    """(a) ``moe.apply`` (learned, hash, and capacity_factor 0.25 with
    drops) of the three MoE archs and jamba's ``mamba.apply`` and
    ``decode_step`` at ``smoke_config`` in float32 on the card against the
    CPU, the same parameters and inputs."""
    import torch
    from repro_torch import configs
    from repro_torch.models import mamba, moe
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are on: float32 would not be float32")
    B, S = FAMILY_SMALL
    rng = np.random.default_rng(2)
    for arch in FAMILY_ARCHS:
        base = configs.smoke_config(arch).replace(dtype="float32")
        cpu = moe.init(base, torch.Generator().manual_seed(0), device="cpu")
        card = moe.MoE(base, device="cuda")
        card.load_state_dict(cpu.state_dict())
        x = torch.from_numpy(rng.standard_normal(
            (B, S, base.d_model)).astype(np.float32))
        for mode, rm, kw in MOE_MODES:
            cfg = base.replace(**kw)
            C = moe._capacity(cfg, B * S)
            out = {}
            for dev, m in (("cuda", card), ("cpu", cpu)):
                xd = x.to(dev)
                y, aux = moe.apply(m, cfg, xd, router_mode=rm)
                idx = moe.route(m, cfg, xd.reshape(B * S, -1), rm)[3]
                keep = moe.dispatch(cfg, idx, C)[2]
                out[dev] = (y.cpu(), {k: float(v) for k, v in aux.items()},
                            idx.cpu(), keep.cpu())
            (y, aux, idx, keep), (hy, haux, hidx, hkeep) = out["cuda"], \
                out["cpu"]
            err = float((y - hy).abs().max())
            aux_err = max(abs(aux[k] - haux[k]) / abs(haux[k])
                          for k in ("moe_aux", "moe_z"))
            check(torch.equal(idx, hidx) and torch.equal(keep, hkeep),
                  f"moe {arch} {mode}: routing or keep masks differ")
            check(aux["moe_dropped"] == haux["moe_dropped"],
                  f"moe {arch} {mode}: moe_dropped differs")
            check(err <= FAMILY_TOL and aux_err <= FAMILY_TOL,
                  f"moe {arch} {mode}: card vs CPU y {err}, aux {aux_err}")
            print(f"family_moe {arch} {mode}: {B * S} tokens, {cfg.num_experts}"
                  f" experts top-{cfg.top_k}, capacity {C}; card vs CPU max "
                  f"|y diff| {err:.3e}, aux/z relative {aux_err:.3e} "
                  f"(tolerance {FAMILY_TOL}); routing indices, keep masks "
                  f"and moe_dropped ({aux['moe_dropped']:.6f}) equal")
    cfg = configs.smoke_config(HYBRID_ARCH).replace(dtype="float32")
    cpu = mamba.init(cfg, torch.Generator().manual_seed(0), "cpu")
    card = mamba.Mamba(cfg, "cuda")
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy((rng.standard_normal((B, S, cfg.d_model)) * 0.5)
                         .astype(np.float32))
    out = {}
    for dev, m in (("cuda", card), ("cpu", cpu)):
        y = mamba.apply(m, cfg, x.to(dev)).cpu()
        st = mamba.init_state(cfg, B, device=dev)
        ys = []
        for i in range(S):
            yi, st = mamba.decode_step(m, cfg, st, x[:, i:i + 1].to(dev))
            ys.append(yi.cpu())
        out[dev] = (y, torch.cat(ys, 1), st["ssm"].cpu())
    errs = [float((a - b).abs().max()) for a, b in zip(out["cuda"],
                                                       out["cpu"])]
    check(max(errs) <= FAMILY_TOL,
          f"mamba: card vs CPU apply/decode/state {errs}")
    print(f"family_mamba {HYBRID_ARCH} smoke: chunked apply (chunk "
          f"{cfg.mamba_chunk}) and {S} decode steps x {B}, card vs CPU max "
          f"|diff| apply {errs[0]:.3e}, decode {errs[1]:.3e}, SSM state "
          f"{errs[2]:.3e} (tolerance {FAMILY_TOL}); card: {smi}")


def check_hybrid_decode_matches_forward(smi):
    """(b) jamba-v0.1-52b at its published widths, 8 of 32 layers (one
    unit: 7 mamba + 1 attention; MoE on 1, 3, 5, 7), float32, TF32 off,
    capacity_factor raised to E so neither side drops a token: two
    sequences of 64 tokens teacher-forced through ``decode_step`` on a block
    table probed from a ``perf`` PageTableManager, every position's logits
    against ``forward`` + ``logits_fn``."""
    import torch
    from repro_torch import configs
    from repro_torch.core.paged_kv import PageTableManager
    from repro_torch.models import model, transformer
    cfg = configs.get_config(HYBRID_ARCH)
    cfg = cfg.replace(num_layers=HYBRID_DEPTH, dtype="float32",
                      capacity_factor=float(cfg.num_experts))
    B, S, pt = HYBRID_TF
    torch.cuda.reset_peak_memory_stats()
    params, init_s = host_s(lambda: model.init_params(cfg, 0, "cuda"))
    n_params = sum(p.numel() for p in params.parameters())
    ctx = decode_ctx(model, configs, cfg, B, S, pt)
    mgr = PageTableManager(ctx.pool_pages, backend="perf", device="cuda")
    mgr.alloc_seqs([(s, ctx.n_pages, 0) for s in range(B)])
    bt = mgr.block_table(list(range(B)), ctx.n_pages)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    (dec, states), dec_s = host_s(lambda: teacher_forced(
        model, params, cfg, tokens, bt, ctx))
    (x, aux), fwd_s = host_s(lambda: model.forward(
        params, cfg, {"tokens": torch.from_numpy(tokens).cuda()}))
    full = model.logits_fn(params, cfg, x).transpose(0, 1)
    err = (dec - full).abs()
    ok = torch.isclose(dec, full, rtol=DECODE_TOL, atol=DECODE_TOL)
    kinds = [transformer.layer_kind(cfg, i) for i in range(cfg.num_layers)]
    moe_layers = [i for i in range(cfg.num_layers) if cfg.is_moe_layer(i)]
    # phase 17(b) holds the ranks' first steps against these, from the host
    FAMILY_RANK_DATA.mkdir(parents=True, exist_ok=True)
    np.save(FAMILY_RANK_DATA / "tf_logits.npy",
            dec[:FAMILY_RANK_TF].cpu().numpy())
    check(float(aux["moe_dropped"]) == 0.0, "forward dropped tokens")
    check(bool(torch.isfinite(dec).all()), "decode logits not finite")
    check(bool(ok.all()), f"hybrid decode != forward at {int((~ok).sum())} "
          f"logits, max |diff| {float(err.max())}")
    print(f"hybrid_decode_vs_forward {HYBRID_ARCH}: {cfg.num_layers} of 32 "
          f"layers ({kinds.count('mamba')} mamba + {kinds.count('attn')} "
          f"attention; MoE on layers {moe_layers}), "
          f"d_model {cfg.d_model}, d_inner {cfg.d_inner}, N "
          f"{cfg.ssm_state_dim}, {cfg.num_experts} experts top-{cfg.top_k} of "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {n_params} float32 "
          f"params ({n_params * 4 / 1e9:.3f} GB) drawn on the card in "
          f"{init_s:.3f} s; {B} x {S} tokens teacher-forced in {dec_s:.3f} s "
          f"(the recurrence), forward (the chunked scan, chunk "
          f"{cfg.mamba_chunk}) {fwd_s:.3f} s; every position's logits within "
          f"{DECODE_TOL} of forward: max |diff| {float(err.max()):.3e}, "
          f"largest |logit| {float(full.abs().max()):.3f}; TF32 off; "
          f"capacity_factor {cfg.capacity_factor} (no drops); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card: {smi}")
    del params, dec, full, x, states
    torch.cuda.empty_cache()


class DropMeter:
    """``moe.apply`` wrapped for the length of a ``with`` block: each call's
    ``moe_dropped`` kept on the card (no synchronise), read at the end."""

    def __enter__(self):
        from repro_torch.models import moe
        self._apply, self.dropped = moe.apply, []
        meter = self

        def apply(*a, **kw):
            y, aux = meter._apply(*a, **kw)
            meter.dropped.append(aux["moe_dropped"].detach())
            return y, aux
        moe.apply = apply
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.apply = self._apply

    def mean(self, cfg, steps: int) -> float:
        """The mean over the run's MoE layer-steps; fails unless every MoE
        layer of every decode step went through ``moe.apply``."""
        import torch
        from repro_torch.models import transformer
        n_moe = sum(transformer.ffn_kind(cfg, i) == "moe"
                    for i in range(cfg.num_layers))
        check(n_moe > 0 and len(self.dropped) == steps * n_moe,
              f"moe.apply ran {len(self.dropped)} times over {steps} steps "
              f"of {n_moe} MoE layers")
        return float(torch.stack(self.dropped).mean())


class StepMetrics:
    """``steps.build_train_step`` wrapped for the length of a ``with``
    block: the step functions it builds keep each step's metrics ``keys``
    on the card (no synchronise), read at the end."""

    def __init__(self, keys):
        self.keys, self.metrics = keys, []

    def __enter__(self):
        from repro_torch.distributed import steps
        self._build = steps.build_train_step
        meter = self

        def build(*a, **kw):
            fn = meter._build(*a, **kw)

            def step(*sa, **skw):
                out = fn(*sa, **skw)
                meter.metrics.append({k: out[2][k].detach()
                                      for k in meter.keys})
                return out
            return step
        steps.build_train_step = build
        return self

    def __exit__(self, *exc):
        from repro_torch.distributed import steps
        steps.build_train_step = self._build

    def read(self, losses: dict) -> dict:
        """{key: [value a step]}; fails unless it saw every step whose loss
        ``train`` returned, with the same loss."""
        rec = {k: [float(m[k]) for m in self.metrics] for k in self.keys}
        check(rec["loss"] == [losses[s] for s in sorted(losses)],
              f"the recorded losses {rec['loss']} are not train's "
              f"{losses}")
        return rec


def family_serve_line(name, cfg, kw, done, steps, timer, launches, wall,
                      peak, dropped, smi):
    """Print one served run's numbers; return (median ms, bound ms)."""
    gen = sum(len(r["out"]) for r in done)
    from repro_torch.models import transformer
    bound_ms, w_bytes, kv_bytes, ssm_bytes = decode_bound(cfg, kw)
    st = timer.step_ms
    med = float(np.median(st))
    kinds = [transformer.layer_kind(cfg, i) for i in range(cfg.num_layers)]
    print(f"{name} {cfg.name} ({cfg.num_layers} layers, params float32, "
          f"activations {cfg.dtype}, KV float32; decode states: "
          f"{kinds.count('attn')} attention layers' paged KV pools, "
          f"{kinds.count('mamba')} mamba layers' conv (B, "
          f"{cfg.ssm_conv_width - 1}, d_inner) and float32 SSM (B, d_inner, "
          f"{cfg.ssm_state_dim}) states, carried over when a slot is "
          f"reused): batch {kw['batch']}, "
          f"horizon {kw['horizon']}, page_tokens {kw['page_tokens']}, "
          f"{len(done)} requests of prompt {kw['prompt_len']} + "
          f"{kw['max_new']} new, backend perf; {steps} decode steps, {gen} "
          f"tokens in {wall:.3f} s = {gen / wall:.1f} generated tokens/s; "
          f"step ms median {med:.3f} (min {min(st):.3f}, max {max(st):.3f}) "
          f"against a bound of {bound_ms:.3f} ms (weights "
          f"{w_bytes / 1e9:.3f} GB + KV {kv_bytes / 1e9:.3f} GB + SSM states "
          f"{ssm_bytes / 1e9:.3f} GB at {HBM_RATE / 1e12:.2f} TB/s; "
          f"{bound_ms / med * 100:.1f}% of bound); page-table host ms a step "
          f"{timer.table_ms / steps:.4f}; probe_perf launches {launches} = "
          f"{launches / steps:.4f} a step; moe_dropped mean over the run's "
          f"MoE layer-steps {dropped:.6f}; peak {peak:.2f} GiB; card: {smi}")
    return med, bound_ms


def family_serving(k, ref, smi):
    """(b) jamba at 8 layers and (c) olmoe-1b-7b at its published widths
    and depth served through ``launch/serve.serve``.  Returns the timed
    runs' probe_perf launches."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve
    cfg = configs.get_config(HYBRID_ARCH).replace(num_layers=HYBRID_DEPTH)
    with DropMeter() as dm:
        done, mgr, steps, timer, h_launches, wall, peak, _ = served_run(
            serve, k, cfg=cfg, **HYBRID_SERVE)
    check_served(cfg, done, mgr, HYBRID_SERVE, "hybrid serve")
    check(h_launches > 0, "the hybrid serve never launched probe_perf")
    family_serve_line("hybrid_serve", cfg, HYBRID_SERVE, done, steps, timer,
                      h_launches, wall, peak, dm.mean(cfg, steps), smi)
    torch.cuda.empty_cache()

    cfg = configs.get_config(MOE_ARCH)
    done, mgr, steps, timer, _, _, _, _ = served_run(
        serve, k, ref, check_tables=True, cfg=cfg, **MOE_CHECKED)
    check_served(cfg, done, mgr, MOE_CHECKED, "moe checked serve")
    checked_out = {r["id"]: r["out"] for r in done}
    print(f"moe_checked: {len(done)} requests, {steps} steps, every step's "
          f"logits finite; at {timer.admissions} admissions the probed block "
          f"tables equal the allocator's and probe_perf equals plain bit for "
          f"bit on {timer.keys_checked} page-table keys")
    with DropMeter() as dm:
        done, mgr, steps, timer, m_launches, wall, peak, _ = served_run(
            serve, k, cfg=cfg, **MOE_SERVE)
    check_served(cfg, done, mgr, MOE_SERVE, "moe timed serve")
    check(all(r["out"] == checked_out[r["id"]] for r in done
              if r["id"] in checked_out),
          "the timed moe serve's tokens differ from the checked one's")
    check(m_launches > 0, "the moe serve never launched probe_perf")
    med, bound_ms = family_serve_line("moe_serve", cfg, MOE_SERVE, done,
                                      steps, timer, m_launches, wall, peak,
                                      dm.mean(cfg, steps), smi)
    done, mgr, psteps, _, _, pwall, ppeak, prof = served_run(
        serve, k, profile=True, cfg=cfg, **MOE_PROFILE)
    check_served(cfg, done, mgr, MOE_PROFILE, "moe profiled serve")
    busy, idle, rows, _ = device_profile(prof, pwall)
    check(busy > 0, "the profiled moe serve shows no device time")
    print(f"moe_profile: {psteps} steps under torch.profiler, wall "
          f"{pwall * 1e3:.3f} ms, device busy {busy:.3f} ms, idle "
          f"{idle * 100:.1f}%, peak {ppeak:.2f} GiB; top kernels:")
    for ms, n, name in rows:
        print(f"  {ms:10.3f} ms x{n:<6d} {name}")
    del prof
    torch.cuda.empty_cache()
    return h_launches + m_launches, dict(median_ms=med, bound_ms=bound_ms,
                                         idle=idle)


def moe_train_full_width(smi):
    """(d) olmoe-1b-7b at its published widths, ``MOE_TRAIN``'s depth
    (random init on the card; params float32, activations bfloat16, AdamW float32,
    remat per unit), 8 steps at batch 4 x 4096 with the CLI's schedule
    through ``launch.train.train``, each step's aux terms read from its
    step function's metrics; then the drops of one forward of the trained
    model on the run's data against uniform tokens, and one profiled
    step."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from repro_torch import configs
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import steps
    from repro_torch.launch.train import train
    from repro_torch.models import model, moe
    f = MOE_TRAIN
    cfg = configs.get_config(MOE_ARCH).replace(num_layers=f["depth"])
    B, S = f["batch"], f["seq"]
    shape = configs.ShapeConfig("train_4k_cut", S, B, "train")
    oc = configs.OptimConfig(lr=3e-4, warmup_steps=f["steps"] // 5 + 1,
                             total_steps=f["steps"])
    mm, attn, n_params, n_active = train_flops(cfg, B, S)
    keys = ("loss", "ce_loss", "moe_aux", "moe_z", "moe_dropped")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepMetrics(keys) as sm:
        params, opt, losses, mon, _ = train(
            cfg, shape, oc, num_steps=f["steps"], ckpt_dir=None,
            verbose=False, device="cuda")
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec = sm.read(losses)
    check(sorted(losses) == list(range(f["steps"])),
          f"train ran steps {sorted(losses)}")
    check(all(np.isfinite(rec["loss"])), f"a moe loss is not finite: "
          f"{rec['loss']}")
    check(rec["ce_loss"][-1] < rec["ce_loss"][0],
          f"the moe cross-entropy did not fall: {rec['ce_loss']}")

    # the drops of the trained model on the run's Zipf and grammar tokens
    # against tokens drawn uniformly from the vocabulary
    data = SyntheticLMData(cfg, shape)
    zipf = data.batch_at(f["steps"])
    rng = np.random.default_rng(f["steps"])
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    uniform = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    drops, ids = {}, {}
    with torch.no_grad():
        for name, bt in (("zipf", zipf), ("uniform", uniform)):
            _, aux = model.loss_fn(params, cfg, {
                k: torch.from_numpy(v).cuda() for k, v in bt.items()})
            drops[name] = float(aux["moe_dropped"]) / cfg.num_layers
            _, counts = np.unique(bt["tokens"], return_counts=True)
            ids[name] = (len(counts), counts.max() / bt["tokens"].size)

    step_fn = steps.build_train_step(cfg, oc)
    batch = {k: torch.from_numpy(v).cuda() for k, v in zipf.items()}
    sync()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        params, opt, _ = step_fn(params, opt, batch)
        sync()
        pwall = time.perf_counter() - tp
    busy, idle, rows, _ = device_profile(prof, pwall, top=12)
    groups = kernel_groups(prof)
    check(busy > 0, "the profiled moe train step shows no device time")
    del params, opt, prof, batch
    torch.cuda.empty_cache()
    step_ms = [t * 1e3 for t in mon.times]
    med = float(np.median(step_ms))
    flops = mm + attn
    share = flops / (med / 1e3) / BF16_RATE
    tokens = B * S
    print(f"moe_train {MOE_ARCH}: {cfg.num_layers} of 16 layers (cut for "
          f"memory), d_model "
          f"{cfg.d_model}, {cfg.num_experts} experts top-{cfg.top_k} of d_ff "
          f"{cfg.d_ff} (capacity {moe._capacity(cfg, tokens)} rows an expert "
          f"at capacity_factor {cfg.capacity_factor}), {n_params} params "
          f"({n_active} active a token), params float32, activations "
          f"{cfg.dtype}, AdamW float32, remat {cfg.remat}; through "
          f"launch.train.train; batch {B} x seq "
          f"{S} ({tokens} tokens a step); step ms "
          f"{[round(v, 1) for v in step_ms]}; median {med:.1f} ms = "
          f"{tokens / med * 1e3:.1f} tokens/s; {flops / 1e12:.2f} TFLOP a "
          f"step ({mm / 1e12:.2f} matmul, experts at capacity, + "
          f"{attn / 1e12:.2f} causal attention) = "
          f"{flops / (med / 1e3) / 1e12:.1f} TFLOP/s, {share * 100:.2f}% of "
          f"the {BF16_RATE / 1e12:.0f} TFLOP/s bf16 dense peak; peak memory "
          f"{peak:.2f} GiB; run (no checkpoint) {run_s:.1f} s; "
          f"card: {smi}")
    for k in keys:
        print(f"moe_train {k} by step: {[round(v, 6) for v in rec[k]]}")
    print("moe_train_drops: one forward of the trained model, moe_dropped "
          "a layer: " + "; ".join(
              f"{n} tokens {drops[n]:.6f} ({ids[n][0]} distinct ids, the "
              f"commonest {ids[n][1] * 100:.2f}% of the batch)"
              for n in drops) + f"; card: {smi}")
    print(f"moe_train_profile: 1 step under torch.profiler, wall "
          f"{pwall * 1e3:.1f} ms, device busy {busy:.1f} ms, idle "
          f"{idle * 100:.1f}%; by group: " + ", ".join(
              f"{g} {ms:.1f} ms ({ms / busy * 100:.1f}%)"
              for g, ms in groups.items()) + f"; card: {smi}; top kernels:")
    for ms, n, name in rows:
        print(f"  {ms:10.3f} ms x{n:<6d} {name}")
    return dict(median_ms=med, share=share, peak=peak, idle=idle,
                drops=drops)


def family_path(k, ref, smi):
    """Phase 12: the moe and hybrid families."""
    import shutil
    import torch
    t0 = time.perf_counter()
    with torch.no_grad():
        check_family_modules_vs_cpu(smi)
    check_small_train_vs_cpu(smi, FAMILY_TRAIN_ARCHS)
    try:
        check_restart_on_card(smi, FAMILY_RESTART)
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    t1 = time.perf_counter()
    with torch.no_grad():
        check_hybrid_decode_matches_forward(smi)
        t2 = time.perf_counter()
        launches, serve_stats = family_serving(k, ref, smi)
    t3 = time.perf_counter()
    train = moe_train_full_width(smi)
    print(f"family_path: (a) {t1 - t0:.1f} s, (b) decode vs forward "
          f"{t2 - t1:.1f} s, (b)+(c) serving {t3 - t2:.1f} s, (d) "
          f"{time.perf_counter() - t3:.1f} s; card: {smi}")
    return launches, serve_stats, train


# ---------------------------------------------------------------------------
# The ssm, encdec and vlm families
# ---------------------------------------------------------------------------

REST_ARCHS = ("xlstm-1.3b", "whisper-tiny", "internvl2-2b")
REST_SMALL = (2, 64)             # sequences, tokens of the module checks
REST_FRAMES = 96                 # whisper smoke frames: JAX's gcd chunk, 32
REST_DEC = (16, 8)               # whisper smoke decoder tokens, page tokens
MLSTM_CASES = (("chunk 4", 4, 0), ("chunk 16", 16, 0), ("chunk 64", 64, 0),
               ("groups 2", None, 2))
# card vs CPU, float32, TF32 off, summation order apart: the port against
# JAX on the CPU gives <= 2.4e-6 on these modules (tests/test_torch_xlstm.py,
# tests/test_torch_encdec.py); outputs and states within 1e-4 (absolute and
# relative), gradients within 1e-4 of their leaf's largest magnitude
REST_TOL = 1e-4
# xlstm's exponential gates carry float32 rounding through the stack, the
# port's and JAX's alike (tests/xlstm_drift.py --train): as
# tests/test_torch_train.py holds it against JAX, the losses after step 0
# within 5e-3 relative; its grad norm is ill-conditioned (at these steps
# and batches the port and JAX on the CPU differ by 14.1% at step 2), so
# the grad norms after step 0 within 0.5; AdamW then moves an element up
# to 2 lr a step apart: the parameters within 8e-3, any share beyond 1e-5
XLSTM_TRAIN_TOL = dict(TRAIN_TOL, tight_steps=1, loss_late=5e-3,
                       norm_late=0.5, params=8e-3, share=1.0)
XLSTM_ARCH = "xlstm-1.3b"        # published widths and depth, random init
XLSTM_TF = (2, 64, 16)           # teacher-forced: sequences, tokens, page
# SHAPES["decode_32k"] (batch 128, horizon 32768) cut to one card as phase
# 10 cuts it: batch 16, horizon 4096 (the mLSTM states 2.82 GB beside 5.97
# GB of weights; xlstm holds no KV, but the page table still maps it); 16
# new tokens a request as phase 10 (32 until PR 25)
XLSTM_SERVE = dict(batch=16, horizon=4096, page_tokens=32, requests=32,
                   prompt_len=8, max_new=16, backend="perf")
XLSTM_CHECKED = XLSTM_SERVE
XLSTM_PROFILE = dict(XLSTM_SERVE, requests=16, prompt_len=4, max_new=2)
# SHAPES["train_4k"] (batch 256) cut to batch 4 as phase 11, and to 1024
# tokens: at 4096 a step took 83 s (the sLSTM's serial loop, 69% of it),
# past the 30 s a step this phase affords; 2 steps (3 took 62 s); the
# profiled step at 16 tokens: reading the trace of a step took ~170 s at
# 256 tokens, and at 64 (b)'s training took 111.6 s with 50.6 s of steps;
# and to 16 of 48 layers (2 units, 2 sLSTM): at 48 a step took 35.5 s on a
# slow host and the script 941.7 s (PR 24); then to 8 (one unit, 1 sLSTM)
# and 512 tokens for phase 18's time (PR 25: 24.7 s of training at 8
# layers and 1024 tokens, the script 883.6 s on a slow host, chip run 5)
XLSTM_TRAIN = dict(depth=8, seq=512, batch=4, steps=2, profile_seq=16)
WHISPER_ARCH = "whisper-tiny"    # published widths and depth, random init
WHISPER_TF = (2, 64, 16, 1500)   # sequences, decoder tokens, page, frames
# SHAPES["train_4k"]: 4096 frames and 512 decoder tokens, cut from batch
# 256 to 16 (the float32 score tiles (16, 6, 4096, 1024) are 1.61 GB)
WHISPER_TRAIN = dict(seq=4096, batch=16, steps=4)
VLM_ARCH = "internvl2-2b"        # published widths and depth, random init
# SHAPES["train_4k"] cut to batch 4: 256 patch embeddings + 3840 tokens
VLM_TRAIN = dict(seq=4096, batch=4, steps=4)


def close(a, b, tol):
    """(max |a - b|, every element within tol absolute + tol relative)."""
    import torch
    return float((a - b).abs().max()), bool(torch.isclose(
        a, b, rtol=tol, atol=tol).all())


def check_rest_modules_vs_cpu(smi):
    """(a) xlstm's ``apply_mlstm`` at chunks 4/16/64 and with
    ``mlstm_scan_groups=2`` (outputs and gradients), ``apply_slstm`` (the
    same), ``decode_mlstm``/``decode_slstm`` step by step with their
    states; whisper's ``encode``, ``cross_kv`` and library-level decode
    step by step (logits and self-KV pools); internvl2's forward with its
    patch embeddings: ``smoke_config`` in float32 on the card against the
    CPU, the same parameters and inputs."""
    import torch
    from repro_torch import configs
    from repro_torch.models import encdec, model, xlstm
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are on: float32 would not be float32")
    B, S = REST_SMALL
    rng = np.random.default_rng(3)
    cfg = configs.smoke_config(XLSTM_ARCH).replace(dtype="float32")
    x = torch.from_numpy((rng.standard_normal((B, S, cfg.d_model)) * 0.5)
                         .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                         .astype(np.float32))
    blocks = {}
    for kind, init, cls in (("mlstm", xlstm.init_mlstm, xlstm.MLSTM),
                            ("slstm", xlstm.init_slstm, xlstm.SLSTM)):
        cpu = init(cfg, torch.Generator().manual_seed(0), "cpu")
        card = cls(cfg, "cuda")
        card.load_state_dict(cpu.state_dict())
        blocks[kind] = {"cpu": cpu, "cuda": card}

    def run(kind, fn, dev):
        """fn's output and the gradients of sum(fn * w) by the block's
        parameters and by x."""
        m = blocks[kind][dev]
        m.zero_grad(set_to_none=True)
        with torch.enable_grad():
            xd = x.detach().to(dev).requires_grad_(True)
            y = fn(m, xd)
            (y * w.to(dev)).sum().backward()
        g = {n: p.grad.cpu() for n, p in m.named_parameters()}
        g["x"] = xd.grad.cpu()
        return y.detach().cpu(), g

    def mlstm_fn(chunk, groups):
        c = cfg.replace(mlstm_scan_groups=groups)
        return lambda m, xd: xlstm.apply_mlstm(m, c, xd, chunk=chunk)
    cases = [(f"apply_mlstm {label}", "mlstm", mlstm_fn(c, g))
             for label, c, g in MLSTM_CASES]
    cases.append(("apply_slstm", "slstm",
                  lambda m, xd: xlstm.apply_slstm(m, cfg, xd)))
    for name, kind, fn in cases:
        (y, g), (hy, hg) = (run(kind, fn, d) for d in ("cuda", "cpu"))
        err, ok = close(y, hy, REST_TOL)
        g_err = max(float((g[n] - hg[n]).abs().max())
                    / float(hg[n].abs().max()) for n in hg)
        check(ok and g_err <= REST_TOL,
              f"xlstm {name}: card vs CPU y {err}, gradients {g_err}")
        print(f"rest_xlstm {name}: {B} x {S} tokens, card vs CPU max |y "
              f"diff| {err:.3e}, gradients (every parameter and x) within "
              f"{g_err:.3e} of their largest (tolerance {REST_TOL})")
    for kind in ("mlstm", "slstm"):
        out = {}
        for dev in ("cuda", "cpu"):
            st = getattr(xlstm, f"init_{kind}_state")(cfg, B, device=dev)
            ys, sts = [], []
            with torch.no_grad():
                for i in range(S):
                    y, st = getattr(xlstm, f"decode_{kind}")(
                        blocks[kind][dev], cfg, st, x[:, i:i + 1].to(dev))
                    ys.append(y.cpu())
                    sts.append({n: v.cpu() for n, v in st.items()})
            out[dev] = (torch.cat(ys, 1), sts)
        err, ok = close(out["cuda"][0], out["cpu"][0], REST_TOL)
        st_err, st_ok = 0.0, True
        for a, b in zip(out["cuda"][1], out["cpu"][1]):
            for n in b:
                e, o = close(a[n], b[n], REST_TOL)
                st_err, st_ok = max(st_err, e), st_ok and o
        check(ok and st_ok, f"decode_{kind}: card vs CPU y {err}, states "
              f"{st_err}")
        print(f"rest_xlstm decode_{kind}: {S} steps x {B}, card vs CPU max "
              f"|y diff| {err:.3e}, states ({', '.join(out['cpu'][1][0])}) "
              f"at every step {st_err:.3e} (tolerance {REST_TOL})")

    wcfg = configs.smoke_config(WHISPER_ARCH).replace(dtype="float32")
    tree = model.params_to_numpy(model.init_params(wcfg, 0, "cpu"))
    n_dec, pt = REST_DEC
    frames = torch.from_numpy(rng.standard_normal(
        (B, REST_FRAMES, wcfg.d_model)).astype(np.float32))
    toks = rng.integers(0, wcfg.vocab_size, (B, n_dec)).astype(np.int32)
    ctx = decode_ctx(model, configs, wcfg, B, n_dec, pt)
    bt = np.arange(B * ctx.n_pages, dtype=np.int32).reshape(B, -1)
    out = {}
    with torch.no_grad():
        for dev in ("cuda", "cpu"):
            p = model.params_from_numpy(wcfg, tree, dev)
            enc = encdec.encode(p.encoder, wcfg, frames.to(dev))
            ek, ev = encdec.cross_kv(p.decoder, wcfg, enc)
            lg, states = teacher_forced(model, p, wcfg, toks, bt, ctx,
                                        enc_frames=frames.to(dev))
            out[dev] = [enc.cpu(), ek.cpu(), ev.cpu(), lg.cpu(),
                        torch.stack([s["k_pool"] for s in states]).cpu()]
    errs = [close(a, b, REST_TOL) for a, b in zip(out["cuda"], out["cpu"])]
    check(all(ok for _, ok in errs), f"whisper smoke: card vs CPU encode, "
          f"ek, ev, decode logits, pools {[e for e, _ in errs]}")
    print(f"rest_whisper smoke: {REST_FRAMES} frames (attention chunk "
          f"{math.gcd(wcfg.attn_chunk, REST_FRAMES)}), {n_dec} decoder "
          f"steps x {B}; card vs CPU max |diff| encode {errs[0][0]:.3e}, "
          f"cross K/V {max(errs[1][0], errs[2][0]):.3e}, decode logits "
          f"{errs[3][0]:.3e}, self-KV pools {errs[4][0]:.3e} (tolerance "
          f"{REST_TOL})")

    vcfg = configs.smoke_config(VLM_ARCH).replace(dtype="float32")
    tree = model.params_to_numpy(model.init_params(vcfg, 0, "cpu"))
    P_ = vcfg.num_prefix_embeds
    batch = {"patch_embeds": torch.from_numpy(rng.standard_normal(
        (B, P_, vcfg.d_model)).astype(np.float32)),
        "tokens": torch.from_numpy(rng.integers(
            0, vcfg.vocab_size, (B, S - P_)).astype(np.int32))}
    out = {}
    with torch.no_grad():
        for dev in ("cuda", "cpu"):
            p = model.params_from_numpy(vcfg, tree, dev)
            xh, _ = model.forward(p, vcfg, {k: v.to(dev)
                                            for k, v in batch.items()})
            out[dev] = model.logits_fn(p, vcfg, xh).cpu()
    err, ok = close(out["cuda"], out["cpu"], REST_TOL)
    check(ok, f"internvl2 smoke forward: card vs CPU logits {err}")
    print(f"rest_vlm smoke: {P_} patch embeddings + {S - P_} tokens x {B}, "
          f"card vs CPU max |logit diff| {err:.3e} (tolerance {REST_TOL}); "
          f"card: {smi}")


def check_xlstm_decode_matches_forward(smi):
    """(b) xlstm-1.3b at its published widths and depth, float32, TF32
    off: two sequences of 64 tokens.  Every layer's decode (the exact
    recurrence, step by step) against its forward (the chunked mLSTM, the
    sLSTM loop) on the forward's own inputs of that layer, within
    ``DECODE_TOL`` of the layer's largest output (elementwise, an mLSTM
    layer near the top differed by 1.2e-3); then the whole model
    teacher-forced through ``decode_step`` on a block table probed from a
    ``perf`` PageTableManager against ``forward`` + ``logits_fn``, whose
    drift
    float32 rounding grows with depth in the reference too
    (``tests/xlstm_drift.py``): reported, and held finite.  The first
    ``XLSTM_RANK_TF`` steps' logits and every layer's decode input and
    output in them are kept for phase 18(b)
    (``save_xlstm_rank_reference``)."""
    import torch
    from repro_torch import configs
    from repro_torch.core.paged_kv import PageTableManager
    from repro_torch.models import model, transformer
    cfg = configs.get_config(XLSTM_ARCH).replace(dtype="float32")
    B, S, pt = XLSTM_TF
    torch.cuda.reset_peak_memory_stats()
    params, init_s = host_s(lambda: model.init_params(cfg, 0, "cuda"))
    n_params = sum(p.numel() for p in params.parameters())
    ctx = decode_ctx(model, configs, cfg, B, S, pt)
    mgr = PageTableManager(ctx.pool_pages, backend="perf", device="cuda")
    mgr.alloc_seqs([(s, ctx.n_pages, 0) for s in range(B)])
    bt = mgr.block_table(list(range(B)), ctx.n_pages)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    tok = torch.from_numpy(tokens).cuda()
    layers = [p for unit in params.units for p in unit.values()]

    def layer_inputs():
        x = model._embed(params, cfg, tok)
        positions = model._positions(x)
        xs = [x]
        for p in layers:
            x, _ = transformer._apply_layer(p, cfg, x, positions)
            xs.append(x)
        return xs
    xs, fwd_s = host_s(layer_inputs)
    btt = torch.as_tensor(bt, device="cuda")
    states = transformer.init_decode_states(cfg, B, ctx, torch.float32,
                                            device="cuda")
    errs = []
    t0 = time.perf_counter()
    for i, (p, st) in enumerate(zip(layers, states)):
        ys = []
        for t in range(S):
            y, st = transformer._apply_layer_decode(
                p, cfg, xs[i][:, t:t + 1], st, btt,
                torch.full((B,), t, dtype=torch.int32, device="cuda"), ctx)
            ys.append(y)
        # the layer's own output (the mixer's), against its largest value
        sub = xs[i + 1] - xs[i]
        err = float((torch.cat(ys, 1) - xs[i + 1]).abs().max())
        rel = err / float(sub.abs().max())
        kind = transformer.layer_kind(cfg, i)
        check(rel <= DECODE_TOL, f"xlstm layer {i} ({kind}): decode != "
              f"forward on the same inputs, max |diff| {err}, "
              f"{rel} of the layer output's largest")
        errs.append((rel, kind, err, i))
    sync()
    layer_s = time.perf_counter() - t0
    with LayerTape(cfg.num_layers, XLSTM_RANK_TF) as tape:
        (dec, _), dec_s = host_s(lambda: teacher_forced(model, params, cfg,
                                                        tokens, bt, ctx))
    resp = layer_sensitivity(layers, cfg, tape, btt, ctx)
    save_xlstm_rank_reference(tokens, dec, tape, resp)
    full = model.logits_fn(params, cfg, xs[-1]).transpose(0, 1)
    check(bool(torch.isfinite(dec).all()) and bool(torch.isfinite(full)
                                                   .all()),
          "xlstm decode or forward logits not finite")
    drift = float((dec - full).abs().max())
    worst = {k: max(e for e, kk, _, _ in errs if kk == k)
             for _, k, _, _ in errs}
    top = sorted(errs, reverse=True)[:3]
    print(f"xlstm_decode_vs_forward {XLSTM_ARCH}: {cfg.num_layers} layers "
          f"({sum(e[1] == 'slstm' for e in errs)} sLSTM + "
          f"{sum(e[1] == 'mlstm' for e in errs)} mLSTM), d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, mLSTM "
          f"chunk {cfg.mlstm_chunk}, vocab {cfg.vocab_size}; {n_params} "
          f"float32 params ({n_params * 4 / 1e9:.3f} GB) drawn on the card "
          f"in {init_s:.3f} s; {B} x {S} tokens; every layer's decode on "
          f"its forward inputs within {DECODE_TOL} of the layer output's "
          f"largest value: worst "
          + ", ".join(f"{k} {e:.3e}" for k, e in worst.items())
          + " (largest: " + ", ".join(f"layer {i} {k} {r:.3e} = {e:.3e} "
                                      f"absolute" for r, k, e, i in top)
          + f"; {layer_s:.3f} s); the whole model teacher-forced through "
          f"decode_step ({dec_s:.3f} s; forward {fwd_s:.3f} s) drifts from "
          f"forward by max |logit diff| {drift:.3e}, largest |logit| "
          f"{float(full.abs().max()):.3f}; TF32 off; block table probed "
          f"through probe_perf; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card: {smi}")
    del params, dec, full, xs, states
    torch.cuda.empty_cache()
    return dict(drift=drift, layer_err=max(e for e, _, _, _ in errs))


def xlstm_serving(k, ref, smi):
    """(b) xlstm-1.3b at its published widths and depth served through
    ``launch/serve.serve`` at batch 16: checked, timed and profiled as in
    phase 10.  Returns the timed run's probe_perf launches and its
    numbers."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve
    cfg = configs.get_config(XLSTM_ARCH)
    done, mgr, steps, timer, _, _, _, _ = served_run(
        serve, k, ref, check_tables=True, cfg=cfg, **XLSTM_CHECKED)
    check_served(cfg, done, mgr, XLSTM_CHECKED, "xlstm checked serve")
    checked_out = {r["id"]: r["out"] for r in done}
    print(f"xlstm_checked: {len(done)} requests, {steps} steps, every "
          f"step's logits finite; at {timer.admissions} admissions the "
          f"probed block tables equal the allocator's and probe_perf equals "
          f"plain bit for bit on {timer.keys_checked} page-table keys")
    done, mgr, steps, timer, launches, wall, peak, _ = served_run(
        serve, k, cfg=cfg, **XLSTM_SERVE)
    check_served(cfg, done, mgr, XLSTM_SERVE, "xlstm timed serve")
    check(all(r["out"] == checked_out[r["id"]] for r in done
              if r["id"] in checked_out),
          "the timed xlstm serve's tokens differ from the checked one's")
    check(launches > 0, "the xlstm serve never launched probe_perf")
    kw = XLSTM_SERVE
    bound_ms, w_bytes, _, st_bytes = decode_bound(cfg, kw)
    st = timer.step_ms
    med = float(np.median(st))
    gen = sum(len(r["out"]) for r in done)
    print(f"xlstm_serve {cfg.name} ({cfg.num_layers} layers, params float32, "
          f"activations {cfg.dtype}, float32 mLSTM (C, n, m) and sLSTM (c, "
          f"n, h, m) states, carried over when a slot is reused; no KV): "
          f"batch {kw['batch']}, horizon {kw['horizon']}, page_tokens "
          f"{kw['page_tokens']}, {len(done)} requests of prompt "
          f"{kw['prompt_len']} + {kw['max_new']} new, backend perf; {steps} "
          f"decode steps, {gen} tokens in {wall:.3f} s = {gen / wall:.1f} "
          f"generated tokens/s; step ms median {med:.3f} (min {min(st):.3f},"
          f" max {max(st):.3f}) against a bound of {bound_ms:.3f} ms (weights"
          f" {w_bytes / 1e9:.3f} GB + states read and written "
          f"{st_bytes / 1e9:.3f} GB at {HBM_RATE / 1e12:.2f} TB/s; "
          f"{bound_ms / med * 100:.1f}% of bound); page-table host ms a step "
          f"{timer.table_ms / steps:.4f}; probe_perf launches {launches} = "
          f"{launches / steps:.4f} a step; peak {peak:.2f} GiB; card: {smi}")
    done, mgr, psteps, _, _, pwall, ppeak, prof = served_run(
        serve, k, profile=True, cfg=cfg, **XLSTM_PROFILE)
    check_served(cfg, done, mgr, XLSTM_PROFILE, "xlstm profiled serve")
    busy, idle, rows, _ = device_profile(prof, pwall)
    check(busy > 0, "the profiled xlstm serve shows no device time")
    print(f"xlstm_profile: {psteps} steps under torch.profiler, wall "
          f"{pwall * 1e3:.3f} ms, device busy {busy:.3f} ms, idle "
          f"{idle * 100:.1f}%, peak {ppeak:.2f} GiB; top kernels:")
    for ms, n, name in rows:
        print(f"  {ms:10.3f} ms x{n:<6d} {name}")
    del prof
    torch.cuda.empty_cache()
    return launches, dict(median_ms=med, bound_ms=bound_ms, idle=idle)


class SlstmMeter:
    """``xlstm.apply_slstm`` wrapped for the length of a ``with`` block:
    the host seconds inside each call (a unit's pass and its recompute)
    and, through hooks on its output and input, in its backward pass; with
    ``ranges`` each also inside a ``record_function`` range
    (``xlstm.slstm``, ``xlstm.slstm.backward``) that a profile's device
    timeline windows."""

    NAMES = ("xlstm.slstm", "xlstm.slstm.backward")

    def __init__(self, ranges=False):
        self.ranges, self.fwd_s, self.bwd_s = ranges, [], []

    def _range(self, name):
        from torch.autograd.profiler import record_function
        rf = record_function(name)
        rf.__enter__()
        return rf

    def __enter__(self):
        from repro_torch.models import xlstm
        self._apply = xlstm.apply_slstm
        meter = self

        def apply(p, cfg, x, **kw):
            t0 = time.perf_counter()
            rf = meter._range(meter.NAMES[0]) if meter.ranges else None
            y = meter._apply(p, cfg, x, **kw)
            if rf is not None:
                rf.__exit__(None, None, None)
            meter.fwd_s.append(time.perf_counter() - t0)
            if y.requires_grad and x.requires_grad:
                meter._hook(x, y)
            return y
        xlstm.apply_slstm = apply
        return self

    def _hook(self, x, y):
        """The backward from y's gradient to x's: a unit's recompute
        registers hooks too, on tensors no gradient reaches."""
        open_ = {}

        def start(_):
            open_["t"] = time.perf_counter()
            if self.ranges:
                open_["rf"] = self._range(self.NAMES[1])

        def end(_):
            if "t" in open_:
                if "rf" in open_:
                    open_.pop("rf").__exit__(None, None, None)
                self.bwd_s.append(time.perf_counter() - open_.pop("t"))
        y.register_hook(start)
        x.register_hook(end)

    def __exit__(self, *exc):
        from repro_torch.models import xlstm
        xlstm.apply_slstm = self._apply


def kernels_in_ranges(prof, names) -> dict:
    """Device ms of the kernels that start inside the device-timeline
    windows of each ``record_function`` range in ``names`` (None where the
    trace has no such window); the ranges' own events are not kernels."""
    from torch.autograd import DeviceType

    def on_device(e, annotation):
        return e.device_type == DeviceType.CUDA and \
            bool(getattr(e, "is_user_annotation", False)) == annotation
    events = prof.events()
    ks = sorted((e.time_range.start, e.time_range.elapsed_us())
                for e in events if on_device(e, False))
    starts = [t for t, _ in ks]
    cum = np.concatenate([[0.0], np.cumsum([us for _, us in ks])])
    out = {}
    for name in names:
        windows = [e.time_range for e in events
                   if on_device(e, True) and e.name == name]
        out[name] = sum(
            cum[bisect.bisect_left(starts, w.end)]
            - cum[bisect.bisect_left(starts, w.start)]
            for w in windows) / 1e3 if windows else None
    return out


def xlstm_train_full_width(smi):
    """(b) xlstm-1.3b at its published widths, ``XLSTM_TRAIN``'s depth
    (random init on the card; params float32, activations bfloat16, AdamW
    float32, remat per unit of 8 layers) trains at batch 4 x 512 through
    ``launch.train.train``, the sLSTM's host time metered; then one step at
    batch 4 x 16 under torch.profiler: busy and idle, kernel groups, and
    the device time of the sLSTM's kernels (its forward passes and its
    backward, by range)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from repro_torch import configs
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import steps
    from repro_torch.launch.train import train
    from repro_torch.models import transformer
    f = XLSTM_TRAIN
    cfg = configs.get_config(XLSTM_ARCH).replace(num_layers=f["depth"])
    B, S = f["batch"], f["seq"]
    shape = configs.ShapeConfig("train_4k_cut", S, B, "train")
    oc = configs.OptimConfig(lr=3e-4, warmup_steps=f["steps"] // 5 + 1,
                             total_steps=f["steps"])
    mm, mix, n_params, _ = train_flops(cfg, B, S)
    n_slstm = sum(transformer.layer_kind(cfg, i) == "slstm"
                  for i in range(cfg.num_layers))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with SlstmMeter() as sm:
        params, opt, losses, mon, _ = train(
            cfg, shape, oc, num_steps=f["steps"], ckpt_dir=None,
            verbose=False, device="cuda")
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    ls = [losses[s] for s in sorted(losses)]
    check(sorted(losses) == list(range(f["steps"])),
          f"train ran steps {sorted(losses)}")
    check(all(np.isfinite(ls)), f"an xlstm loss is not finite: {ls}")
    check(ls[-1] < ls[0], f"the xlstm loss did not fall: {ls}")
    check(len(sm.fwd_s) == 2 * n_slstm * f["steps"] and
          len(sm.bwd_s) == n_slstm * f["steps"],
          f"metered {len(sm.fwd_s)} sLSTM passes and {len(sm.bwd_s)} "
          f"backwards over {f['steps']} steps of {n_slstm} sLSTM layers")
    step_ms = [t * 1e3 for t in mon.times]
    med = float(np.median(step_ms))
    slstm_s = sum(sm.fwd_s) + sum(sm.bwd_s)
    host_share = slstm_s / sum(mon.times)

    Sp = f["profile_seq"]
    pshape = configs.ShapeConfig("profile", Sp, B, "train")
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             SyntheticLMData(cfg, pshape).batch_at(0).items()}
    step_fn = steps.build_train_step(cfg, oc)
    params, opt, _ = step_fn(params, opt, batch)          # warm the shapes
    sync()
    with SlstmMeter(ranges=True) as pm, torch_profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        params, opt, _ = step_fn(params, opt, batch)
        sync()
        pwall = time.perf_counter() - tp
    busy, idle, rows, _ = device_profile(prof, pwall, top=10)
    groups = kernel_groups(prof)
    spans = kernels_in_ranges(prof, SlstmMeter.NAMES)
    check(busy > 0, "the profiled xlstm train step shows no device time")
    check(all(v is not None for v in spans.values()),
          f"the profile has no sLSTM range window: {spans}")
    del params, opt, prof, batch
    torch.cuda.empty_cache()
    slstm_ms = sum(spans.values())
    flops = mm + mix
    share = flops / (med / 1e3) / BF16_RATE
    tokens = B * S
    print(f"xlstm_train {XLSTM_ARCH}: {cfg.num_layers} of 48 layers "
          f"({n_slstm} sLSTM), {n_params} params, params float32, activations "
          f"{cfg.dtype}, AdamW float32, remat a unit of "
          f"{transformer.scan_unit_size(cfg)} layers; through "
          f"launch.train.train; batch {B} x seq {S} ({tokens} tokens a step; "
          f"SHAPES['train_4k'] is batch 256 x 4096); losses "
          f"{[round(v, 4) for v in ls]}; step ms "
          f"{[round(v, 1) for v in step_ms]}; median {med:.1f} ms = "
          f"{tokens / med * 1e3:.1f} tokens/s; {flops / 1e12:.2f} TFLOP a "
          f"step ({mm / 1e12:.2f} matmul + {mix / 1e12:.2f} mLSTM chunk and "
          f"state products) = {flops / (med / 1e3) / 1e12:.2f} TFLOP/s, "
          f"{share * 100:.2f}% of the {BF16_RATE / 1e12:.0f} TFLOP/s bf16 "
          f"dense peak; the sLSTM layers' host time (both forward passes "
          f"and the backward) {slstm_s:.1f} s of {sum(mon.times):.1f} s = "
          f"{host_share * 100:.1f}% of the steps; peak memory {peak:.2f} GiB;"
          f" run (no checkpoint) {run_s:.1f} s; card: {smi}")
    print(f"xlstm_train_profile: 1 step at batch {B} x {Sp} under "
          f"torch.profiler, wall {pwall * 1e3:.1f} ms, device busy "
          f"{busy:.1f} ms, idle {idle * 100:.1f}%; the sLSTM's kernels "
          f"{slstm_ms:.1f} ms ({slstm_ms / busy * 100:.1f}% of the busy "
          f"time: forward passes {spans[SlstmMeter.NAMES[0]]:.1f} ms, "
          f"backward {spans[SlstmMeter.NAMES[1]]:.1f} ms; host share there "
          f"{(sum(pm.fwd_s) + sum(pm.bwd_s)) / pwall * 100:.1f}%); by group: "
          + ", ".join(f"{g} {ms:.1f} ms ({ms / busy * 100:.1f}%)"
                      for g, ms in groups.items())
          + f"; card: {smi}; top kernels:")
    for ms, n, name in rows:
        print(f"  {ms:10.3f} ms x{n:<6d} {name}")
    return dict(median_ms=med, share=share, peak=peak, idle=idle,
                slstm_host=host_share, slstm_device=slstm_ms / busy)


def whisper_path(smi):
    """(c) whisper-tiny at its published widths and depth (random init on
    the card): library-level decode (``init_decode_states(...,
    enc_frames=)``, then ``decode_step``; JAX's serving loop cannot serve
    it) against ``decode_train`` at every position of 2 x 64 decoder
    tokens over 1500 stub frames, float32, TF32 off; then training at
    batch 16 x (4096 frames, 512 decoder tokens) through
    ``launch.train.train``, whose ``final_norm/bias`` (the loss reads only
    the scale) and its moments must stay exactly zero, as in JAX."""
    import torch
    from repro_torch import configs
    from repro_torch.core.paged_kv import PageTableManager
    from repro_torch.launch.train import train
    from repro_torch.models import model
    cfg = configs.get_config(WHISPER_ARCH).replace(dtype="float32")
    B, S, pt, n_frames = WHISPER_TF
    params = model.init_params(cfg, 0, "cuda")
    ctx = decode_ctx(model, configs, cfg, B, S, pt)
    mgr = PageTableManager(ctx.pool_pages, backend="perf", device="cuda")
    mgr.alloc_seqs([(s, ctx.n_pages, 0) for s in range(B)])
    bt = mgr.block_table(list(range(B)), ctx.n_pages)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = torch.from_numpy(rng.standard_normal(
        (B, n_frames, cfg.d_model)).astype(np.float32)).cuda()
    with torch.no_grad():
        (dec, _), dec_s = host_s(lambda: teacher_forced(
            model, params, cfg, tokens, bt, ctx, enc_frames=frames))
        (x, _), fwd_s = host_s(lambda: model.forward(params, cfg, {
            "frames": frames, "dec_tokens": torch.from_numpy(tokens).cuda()}))
        full = model.logits_fn(params, cfg, x).transpose(0, 1)
    err, ok = close(dec, full, DECODE_TOL)
    check(bool(torch.isfinite(dec).all()), "whisper decode logits not finite")
    check(ok, f"whisper decode != decode_train, max |diff| {err}")
    chunk = min(cfg.attn_chunk, n_frames)
    print(f"whisper_decode_vs_train {WHISPER_ARCH}: {cfg.num_encoder_layers} "
          f"+ {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; {n_frames} stub frames (attention chunk "
          f"{math.gcd(chunk, n_frames)}, JAX's gcd rule); {B} x {S} decoder "
          f"tokens through init_decode_states(enc_frames=) + decode_step "
          f"({dec_s:.3f} s) against forward's decode_train ({fwd_s:.3f} s): "
          f"every position within {DECODE_TOL}, max |diff| {err:.3e}, "
          f"largest |logit| {float(full.abs().max()):.3f}; TF32 off")
    del params, dec, full, x, frames
    torch.cuda.empty_cache()

    f = WHISPER_TRAIN
    cfg = configs.get_config(WHISPER_ARCH)
    Bt, St = f["batch"], f["seq"]
    Sd = min(512, St)
    shape = configs.ShapeConfig("train_4k_cut", St, Bt, "train")
    oc = configs.OptimConfig(lr=3e-4, warmup_steps=f["steps"] // 5 + 1,
                             total_steps=f["steps"])
    mm, attn, n_params, _ = train_flops(cfg, Bt, St)
    torch.cuda.reset_peak_memory_stats()
    params, opt, losses, mon, _ = train(
        cfg, shape, oc, num_steps=f["steps"], ckpt_dir=None, verbose=False,
        device="cuda")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ls = [losses[s] for s in sorted(losses)]
    check(all(np.isfinite(ls)) and ls[-1] < ls[0],
          f"whisper losses not finite or not falling: {ls}")
    n = "final_norm.bias"
    check(not bool(params.final_norm.bias.any()) and not bool(
        opt["m"][n].any()) and not bool(opt["v"][n].any()),
          "whisper's final_norm/bias or its moments moved from zero")
    del params, opt
    torch.cuda.empty_cache()
    step_ms = [t * 1e3 for t in mon.times]
    med = float(np.median(step_ms))
    flops = mm + attn
    print(f"whisper_train {WHISPER_ARCH}: {n_params} params, params float32, "
          f"activations {cfg.dtype}, AdamW float32, remat a layer; through "
          f"launch.train.train; batch {Bt} x ({St} frames, {Sd} decoder "
          f"tokens; SHAPES['train_4k'] is batch 256); losses "
          f"{[round(v, 4) for v in ls]}; step ms "
          f"{[round(v, 1) for v in step_ms]}; median {med:.1f} ms = "
          f"{Bt * Sd / med * 1e3:.1f} decoder tokens/s, "
          f"{Bt * St / med * 1e3:.1f} frames/s; {flops / 1e12:.2f} TFLOP a "
          f"step ({mm / 1e12:.2f} matmul + {attn / 1e12:.2f} attention: "
          f"encoder S^2, causal decoder, cross S_dec x S_enc) = "
          f"{flops / (med / 1e3) / BF16_RATE * 100:.2f}% of the bf16 peak; "
          f"final_norm/bias and its moments exactly 0 after {f['steps']} "
          f"steps; peak memory {peak:.2f} GiB; card: {smi}")
    return dict(median_ms=med, peak=peak)


def vlm_train_full_width(smi):
    """(d) internvl2-2b at its published widths and depth (random init on
    the card; params float32, activations bfloat16, AdamW float32, remat a
    layer) trains 4 steps at batch 4 x (256 patch embeddings + 3840
    tokens), labels -100 on the prefix, through ``launch.train.train``."""
    import torch
    from repro_torch import configs
    from repro_torch.launch.train import train
    f = VLM_TRAIN
    cfg = configs.get_config(VLM_ARCH)
    B, S = f["batch"], f["seq"]
    shape = configs.ShapeConfig("train_4k_cut", S, B, "train")
    oc = configs.OptimConfig(lr=3e-4, warmup_steps=f["steps"] // 5 + 1,
                             total_steps=f["steps"])
    mm, attn, n_params, _ = train_flops(cfg, B, S)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, losses, mon, _ = train(
        cfg, shape, oc, num_steps=f["steps"], ckpt_dir=None, verbose=False,
        device="cuda")
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params, opt
    torch.cuda.empty_cache()
    ls = [losses[s] for s in sorted(losses)]
    check(all(np.isfinite(ls)) and ls[-1] < ls[0],
          f"internvl2 losses not finite or not falling: {ls}")
    step_ms = [t * 1e3 for t in mon.times]
    med = float(np.median(step_ms))
    flops = mm + attn
    share = flops / (med / 1e3) / BF16_RATE
    P_ = cfg.num_prefix_embeds
    print(f"vlm_train {VLM_ARCH}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded "
          f"{cfg.padded_vocab}), {n_params} params ({n_params * 16 / 1e9:.2f}"
          f" GB of params, grads and moments), params float32, activations "
          f"{cfg.dtype}, AdamW float32, remat a layer; through "
          f"launch.train.train; batch {B} x ({P_} patch embeddings + "
          f"{S - P_} tokens; SHAPES['train_4k'] is batch 256); losses "
          f"{[round(v, 4) for v in ls]}; step ms "
          f"{[round(v, 1) for v in step_ms]}; median {med:.1f} ms = "
          f"{B * S / med * 1e3:.1f} tokens/s; {flops / 1e12:.2f} TFLOP a step "
          f"({mm / 1e12:.2f} matmul + {attn / 1e12:.2f} causal attention) = "
          f"{flops / (med / 1e3) / 1e12:.1f} TFLOP/s, {share * 100:.2f}% of "
          f"the {BF16_RATE / 1e12:.0f} TFLOP/s bf16 dense peak; peak memory "
          f"{peak:.2f} GiB; run (no checkpoint) {run_s:.1f} s; "
          f"card: {smi}")
    return dict(median_ms=med, share=share, peak=peak)


def rest_path(k, ref, smi):
    """Phase 13: the ssm, encdec and vlm families."""
    import shutil
    import torch
    from repro_torch import configs
    t0 = time.perf_counter()
    check_rest_modules_vs_cpu(smi)
    check_small_train_vs_cpu(smi, REST_ARCHS, {XLSTM_ARCH: XLSTM_TRAIN_TOL})
    with torch.no_grad():
        small = sum(small_serve_vs_cpu(
            k, configs.smoke_config(a).replace(dtype="float32"))
            for a in (XLSTM_ARCH, VLM_ARCH))
    t1 = time.perf_counter()
    with torch.no_grad():
        decode = check_xlstm_decode_matches_forward(smi)
        launches, serve_stats = xlstm_serving(k, ref, smi)
    t2 = time.perf_counter()
    try:
        train = xlstm_train_full_width(smi)
        t3 = time.perf_counter()
        whisper = whisper_path(smi)
        t4 = time.perf_counter()
        vlm = vlm_train_full_width(smi)
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    print(f"rest_path: (a) {t1 - t0:.1f} s (small serves' probe_perf "
          f"launches {small}), (b) decode and serving {t2 - t1:.1f} s, (b) "
          f"training {t3 - t2:.1f} s, (c) {t4 - t3:.1f} s, (d) "
          f"{time.perf_counter() - t4:.1f} s; card: {smi}")
    return launches, dict(decode=decode, serve=serve_stats, train=train,
                          whisper=whisper, vlm=vlm)


# ---------------------------------------------------------------------------
# The sharded table over ranks: one shard a process, over torch.distributed
# ---------------------------------------------------------------------------

RANKS = 4                        # phase 14: PAPER_HASHMEM cut four ways as in
                                 # phase 9, one shard a rank process
RANK_TIMEOUT = 600               # seconds any collective may wait, then fail
RANK_DATA = ROOT / "build" / "ranks"
RANK_DATA_NAMES = ("keys", "vals", "probes", "pidx", "held_k")


def rank_world():
    """(backend, device) of phase 14's world: NCCL with a card a rank, else
    gloo with every rank on cuda:0 (gloo stages CUDA tensors through the
    host)."""
    import torch
    if torch.cuda.device_count() >= RANKS:
        return "nccl", None
    return "gloo", "cuda:0"


def save_rank_data(data):
    """Phase 4's pairs and probes as .npy files that the rank processes map
    (written once, after phase 9)."""
    RANK_DATA.mkdir(parents=True, exist_ok=True)
    for n in RANK_DATA_NAMES:
        np.save(RANK_DATA / f"{n}.npy", data[n])


def rank_kernels():
    from repro_torch.kernels.probe_area import probe_pages_area
    from repro_torch.kernels.probe_bitserial import probe_pages_bitserial
    from repro_torch.kernels.probe_perf import probe_pages_perf
    return {"probe_perf": probe_pages_perf, "probe_area": probe_pages_area,
            "probe_bitserial": probe_pages_bitserial}


def rank_block(x, mesh):
    """The rank's source block of a whole batch."""
    n = len(x) // mesh.num_shards
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def rank_small(mesh, serving, hashmap, rlu, HashMemConfig, k):
    """(a) on one rank: phase 3's small mesh engines, the 2-shard ones on
    the first two ranks, and the routed one-shard calls.  Returns each
    engine's outcome (this rank's leaves), the issues whose launches were
    not one a probe phase and one a delete's find, the one-shard calls and
    the launches."""
    from repro_torch.launch.mesh import sub_mesh
    meshes = {2: sub_mesh(mesh, 2), RANKS: mesh}
    reset_launches(k)
    outcomes, bad = {}, []
    for case in small_mesh_cases(HashMemConfig):
        name, cfg, D = case[:3]
        m = meshes[D]
        if m is None:
            continue
        eng, reqs = small_mesh_engine(serving, case, m, m.device)
        per = count_issue_launches(eng, k)
        eng.submit_all(reqs)
        snap = eng.run()
        bad += [(name, kinds, n) for kinds, n in per
                if n != issue_launches_wanted(eng, kinds)]
        outcomes[name] = (
            [r.results for r in reqs], eng.schedule, deterministic(eng, snap),
            {n: a[0] for n, a in
             hashmap.to_numpy(eng.backend.hm_stacked).items()},
            (eng.grow_events, eng.split_events, eng.directory_doublings))
    cfg = one_shard_inputs(rlu, HashMemConfig)[0]
    one = one_shard_calls(hashmap, rlu, mesh,
                          hashmap.stack([hashmap.create(cfg,
                                                        device=mesh.device)]),
                          k, lambda x: rank_block(x, mesh))
    return dict(outcomes=outcomes, bad=bad, one_shard=one,
                launches=read_launches(k))


def rank_paper(mesh, serving, hashmap, rlu, k):
    """(b) on one rank: its shard of PAPER_HASHMEM cut four ways loaded
    from the pairs it owns among phase 4's 100M, the 10M probes through
    ``probe_sharded`` (its block), timed; then the phase 8 stream through
    the rank engine, fused at depth 1.  Returns what the parent checks and
    prints."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import PAPER_HASHMEM
    from repro_torch.core.hashing import as_u32
    D, dev, sb = mesh.num_shards, mesh.device, "highbits"
    cfg = dataclasses.replace(PAPER_HASHMEM, num_buckets=MESH_BUCKETS,
                              overflow_pages=MESH_OVERFLOW)
    data = {n: np.load(RANK_DATA / f"{n}.npy") for n in RANK_DATA_NAMES}
    out = {}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(k)
    hs = hashmap.stack([hashmap.create(cfg, device=dev)])
    dist.barrier()
    t0 = time.perf_counter()
    hs, ok, cfg2 = rlu.insert_sharded(hs, data["keys"], data["vals"], cfg, D,
                                      shard_by=sb, mesh=mesh)
    sync()
    out["load_s"] = time.perf_counter() - t0
    check(bool(ok.all()) and cfg2 == cfg,
          f"rank {mesh.rank}: insert_sharded refused {int((~ok).sum())} "
          f"pairs or grew")
    out["digests"] = leaf_digests(hashmap, hs)
    out["load_stats"] = hashmap.stats(hashmap.unstack(hs)[0])
    out["load_stats"].pop("chain_lengths")
    probes = data["probes"]
    cap = rlu.routing_cap(probes, cfg, D, sb)
    qd = as_u32(np.asarray(rank_block(probes, mesh)), dev)
    l0 = read_launches(k)
    v, f = rlu.probe_sharded(mesh, hs, qd, cfg, cap=cap, shard_by=sb)
    l1 = read_launches(k)
    want = np.asarray(data["vals"])[np.asarray(rank_block(data["pidx"],
                                                          mesh))]
    out["probe_launches"] = {n: l1[n] - l0[n] for n in l0}
    out["probe_wrong"] = int((~f).sum()) + int(
        (v.cpu().numpy().astype(np.uint32) != want).sum())
    _, f = rlu.probe_sharded(mesh, hs, np.asarray(rank_block(data["held_k"],
                                                             mesh)),
                             cfg, shard_by=sb)
    out["held_found"] = int(f.sum())
    ex0, times = dict(mesh.exchanges), []
    for _ in range(TIMED_RUNS + 1):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        rlu.probe_sharded(mesh, hs, qd, cfg, cap=cap, shard_by=sb)
        sync()
        dist.barrier()
        times.append((time.perf_counter() - t0) * 1e3)
    out["probe_ms"] = float(np.median(times[1:]))
    out["probe_exchange_ms"] = (mesh.exchanges["seconds"] - ex0["seconds"]) \
        / len(times) * 1e3
    out["cap"] = cap
    out["peak_load"] = torch.cuda.max_memory_allocated(dev) / 2**30
    del hs, qd, v, f, ok, data
    torch.cuda.empty_cache()

    # -- the phase 8 stream through the rank engine -------------------------
    eng, reqs, load_s, svals = serving_engine(
        serving, cfg, SERVE_WORKLOADS, SERVE_RECORDS, SERVE_REQUESTS, dev,
        mesh=mesh, max_slots=SERVE_SLOTS, pipeline_depth=1)
    out["preload_s"] = load_s
    out["preloaded"] = sum(st["live_entries"]
                           for st in eng.backend.shard_stats())
    per = count_issue_launches(eng, k)
    eng.submit_all(reqs)
    reset_launches(k)
    ex0 = dict(mesh.exchanges)
    dist.barrier()
    sync()
    t0 = time.perf_counter()
    snap = eng.run()
    sync()
    out["wall"] = time.perf_counter() - t0
    out["launches"] = read_launches(k)
    out["exchanges"] = {n: mesh.exchanges[n] - ex0[n] for n in ex0}
    out["bad"] = [(kinds, n) for kinds, n in per
                  if n != issue_launches_wanted(eng, kinds)]
    out["results"] = [r.results for r in reqs]
    out["ticks"] = eng.ticks
    out["snap"] = snap
    out["stats"] = eng.stats()
    out["replayed"] = dict_model_replay(eng.schedule, eng.tenants.space,
                                        svals) if mesh.rank == 0 else None
    out["peak"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def rank_main(mesh):
    """Phase 14 on one rank: (a) then (b).  Runs in a process of its own
    (``spawn_ranks``), which finds ``src`` and ``tests`` on its path."""
    from repro_torch import serving
    from repro_torch.configs import HashMemConfig
    from repro_torch.core import hashmap, rlu
    k = rank_kernels()
    t0 = time.perf_counter()
    small = rank_small(mesh, serving, hashmap, rlu, HashMemConfig, k)
    small["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paper = rank_paper(mesh, serving, hashmap, rlu, k)
    paper["seconds"] = time.perf_counter() - t0
    return dict(device=str(mesh.device), backend=mesh.backend, small=small,
                paper=paper)


def ranks_path(smi, host_results, small_cpu, one_cpu, digests):
    """Phase 14: ``RANKS`` rank processes, one shard each, over
    ``torch.distributed`` (``spawn_ranks``): (a) phase 3's small mesh
    engines and routed one-shard calls held against phase 3's CPU runs,
    (b) the phase 9 table, probes and stream held against phases 9 and 8
    and the DictModel.  Every rank's exit and result is checked.  Returns
    the ranks' launches, summed, by kernel."""
    import torch
    from repro_torch.launch.mesh import spawn_ranks
    t_phase = time.perf_counter()
    backend, device = rank_world()
    torch.cuda.empty_cache()
    outs = spawn_ranks(rank_main, RANKS, backend=backend, device=device,
                       timeout=RANK_TIMEOUT)
    spawn_s = time.perf_counter() - t_phase
    print(f"ranks: {RANKS} rank processes over {backend} on "
          f"{[o['device'] for o in outs]} ({torch.cuda.device_count()} "
          f"card(s)); all exited 0 in {spawn_s:.3f} s")

    # -- (a) small mesh engines and the routed calls -------------------------
    n_cases = 0
    for name, cpu in small_cpu.items():
        ranks = [o["small"]["outcomes"][name] for o in outs
                 if name in o["small"]["outcomes"]]
        D = len(cpu[3])
        check(len(ranks) == D, f"ranks {name}: {len(ranks)} ranks ran it")
        for r, (res, sched, det, leaves, events) in enumerate(ranks):
            check(res == cpu[0], f"ranks {name}: rank {r}'s results differ")
            check(sched == cpu[1], f"ranks {name}: rank {r}'s schedule "
                  f"differs")
            check(det == cpu[2], f"ranks {name}: rank {r}'s metrics differ")
            check(leaves.keys() == cpu[3][r].keys() and all(
                np.array_equal(leaves[n], cpu[3][r][n]) for n in leaves),
                f"ranks {name}: rank {r}'s leaves differ from shard {r}")
        grows, splits, doublings = ranks[0][4]
        if name == "grows_D2":
            check(grows > 0, f"ranks {name}: no grow")
        if name == "extendible_D2":
            check(splits > 0 and doublings > 0 and grows == 0,
                  f"ranks {name}: {splits} splits, {doublings} doublings, "
                  f"{grows} grows")
        n_cases += 1
    bad = [b for o in outs for b in o["small"]["bad"]]
    check(not bad, f"ranks: issues whose launches per rank were not one a "
          f"probe phase and one a delete's find: {bad[:4]}")
    ones = [o["small"]["one_shard"] for o in outs]
    for i, want in enumerate(one_cpu[0]):
        got = torch.cat([one[0][i] for one in ones]) if i else ones[0][0][i]
        check(torch.equal(got, want), f"ranks: routed one-shard output {i} "
              f"differs from phase 3's CPU run")
    for r, one in enumerate(ones):
        check(all(np.array_equal(one[1][n], one_cpu[1][n][r:r + 1])
                  for n in one[1]), f"ranks: one-shard leaves of rank {r}")
        check(one[2] == one_cpu[2] and one[3][0]["probe_perf"] == 1
              and one[3][1]["probe_perf"] == 1,
              f"ranks: one-shard caps {one[2]} or launches {one[3]}")
    small_l = {n: sum(o["small"]["launches"][n] for o in outs)
               for n in KERNELS}
    print(f"ranks_small: {n_cases} mesh engines (2 and {RANKS} ranks) and the "
          f"routed one-shard calls on the card equal phase 3's CPU runs "
          f"(results, schedules, metrics, rank r's leaves = shard r); every "
          f"rank's issue one launch a probe phase and one a delete's find; "
          f"launches over the ranks {small_l}; "
          f"{max(o['small']['seconds'] for o in outs):.3f} s")

    # -- (b) the paper table, its probes and the stream ---------------------
    papers = [o["paper"] for o in outs]
    for r, p in enumerate(papers):
        check(all(p["digests"][n][0] == digests[n][r] for n in digests)
              and p["digests"].keys() == digests.keys(),
              f"ranks: rank {r}'s shard differs from phase 9's leaf {r}")
        check(p["probe_wrong"] == 0, f"ranks: rank {r} got "
              f"{p['probe_wrong']} probe results wrong")
        check(p["probe_launches"]["probe_perf"] == 1,
              f"ranks: rank {r}'s sharded probe launched "
              f"{p['probe_launches']}")
        check(p["held_found"] == 0, f"ranks: rank {r} found "
              f"{p['held_found']} never-inserted keys")
    live = [p["load_stats"]["live_entries"] for p in papers]
    check(sum(live) == N_BUILD, f"ranks: the shards hold {live}")
    probe_ms = max(p["probe_ms"] for p in papers)
    n_probes = int(np.load(RANK_DATA / "probes.npy", mmap_mode="r").size)
    print(f"ranks_load: each rank kept its pairs of {N_BUILD} through "
          f"rlu.insert_sharded over the ranks in "
          f"{max(p['load_s'] for p in papers):.3f} s; live a rank {live}; "
          f"every leaf of rank r's shard equals phase 9's shard r (sha256); "
          f"peak device memory a rank "
          f"{max(p['peak_load'] for p in papers):.2f} GiB")
    print(f"ranks_probe: {n_probes} probes through rlu.probe_sharded, "
          f"{n_probes // RANKS} a rank, at cap {papers[0]['cap']}: all found "
          f"with their values (= phase 9), held-back keys none; one "
          f"probe_perf launch on each rank; {probe_ms:.4f} ms from a barrier "
          f"to the last rank's end (median of {TIMED_RUNS} after warm-up) = "
          f"{n_probes / probe_ms / 1e3:.1f} Mprobes/s; host ms in "
          f"rlu.exchange a probe "
          f"{[round(p['probe_exchange_ms'], 3) for p in papers]}; "
          f"{backend}; card: {smi}")
    for r, p in enumerate(papers):
        check(p["preloaded"] == len(SERVE_WORKLOADS) * SERVE_RECORDS,
              f"ranks: rank {r} sees {p['preloaded']} preloaded pairs")
        check(p["results"] == host_results, f"ranks: rank {r}'s results "
              f"differ from phase 8's host engine")
        check(not p["bad"], f"ranks: rank {r}'s issues launched "
              f"{p['bad'][:4]}")
        check(p["launches"]["probe_perf"] > 0, f"ranks: rank {r}'s stream "
              f"launched no probe_perf")
    p0 = papers[0]
    ticks, wall = p0["ticks"], max(p["wall"] for p in papers)
    snap, st = p0["snap"], p0["stats"]
    ex = [p["exchanges"] for p in papers]
    print(f"ranks_serve: {snap['total_ops']} ops of "
          f"{snap['requests_completed']} requests in {wall:.3f} s = "
          f"{snap['total_ops'] / wall:.1f} ops/s through the rank engine "
          f"(fused tick, depth 1); preload "
          f"{max(p['preload_s'] for p in papers):.3f} s; {ticks} ticks; "
          f"latency p50/p99 {snap['request_latency_ticks']['p50']:.0f}/"
          f"{snap['request_latency_ticks']['p99']:.0f} ticks, "
          f"{snap['request_latency_ms']['p50']:.3f}/"
          f"{snap['request_latency_ms']['p99']:.3f} ms; every rank's results "
          f"equal phase 8's; the DictModel replayed {p0['replayed']} keys; "
          f"probe_perf launches a rank "
          f"{[p['launches']['probe_perf'] for p in papers]} over {ticks} "
          f"ticks; rlu.exchange a tick: "
          f"{ex[0]['calls'] / ticks:.1f} calls, host ms "
          f"{[round(e['seconds'] / ticks * 1e3, 3) for e in ex]}, "
          f"{ex[0]['bytes'] / ticks / 1e3:.1f} kB sent by rank 0; "
          f"route_cap_totals {st['route_cap_totals']}; peak device memory a "
          f"rank {max(p['peak'] for p in papers):.2f} GiB")
    print(f"ranks_time: phase 14 took {time.perf_counter() - t_phase:.3f} s "
          f"((a) {max(o['small']['seconds'] for o in outs):.3f} s, (b) "
          f"{max(p['seconds'] for p in papers):.3f} s); card: {smi}")
    return {n: small_l[n] + sum(p["launches"][n] + p["probe_launches"][n]
                                for p in papers) for n in KERNELS}


# ---------------------------------------------------------------------------
# Decode over a (data, model) mesh of ranks
# ---------------------------------------------------------------------------

DECODE_MESHES = {"1x4": {"data": 1, "model": 4}, "2x2": {"data": 2, "model": 2}}
# (a) cut from DECODE_SMALL and DECODE_SMALL_SERVE for time (a collective
# of four ranks sharing the card over gloo takes 3-8 ms,
# tools/collective_bench.py): 8 teacher-forced steps on 2-token pages (a
# sequence's 4 pages on 4 channels), and two waves of a serve whose second
# leaves two slots idle on stale block tables
DECODE_RANK_SMALL = (2, 8, 2)
DECODE_RANK_SMALL_SERVE = dict(DECODE_SMALL_SERVE, requests=6, max_new=4,
                               horizon=8)
DECODE_RANK_MESH = "1x4"         # (b): Qwen3-8B's heads, KV heads, d_ff and
                                 # vocab split four ways


def small_rank_cases() -> list:
    """(a): [(name, arch, mesh, config overrides)]: the four dense archs at
    smoke widths (``small_config``) on both meshes, and qwen3 with 2 KV
    heads on (1, 4), whose ``wk``/``wv`` the rules replicate."""
    cases = [(f"{arch}@{m}", arch, m, {}) for arch in DECODE_ARCHS
             for m in DECODE_MESHES]
    return cases + [("qwen3-8b-kv2@1x4", "qwen3-8b", "1x4",
                     {"num_kv_heads": 2})]


def small_config(arch, over):
    """(a)'s config: the arch's smoke widths in float32, at 2 of its 4
    layers (every layer costs five collectives a step)."""
    from repro_torch import configs
    return configs.smoke_config(arch).replace(
        **{"dtype": "float32", "num_layers": 2, **over})


def digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().contiguous().cpu().numpy()
                          .tobytes()).hexdigest()


def small_rank_references() -> dict:
    """(a) on one card, for each case: the sha256 of every rank's block of
    ``init_params(cfg, 0, "cuda")``, the teacher-forced logits (S, B, V)
    and KV pools of ``DECODE_RANK_SMALL`` on a one-card block table, and
    the outputs of ``serve()`` at ``DECODE_RANK_SMALL_SERVE`` on one card
    with the
    mesh's geometry and arenas (its idle slots append through stale block
    tables into recycled pages, as JAX's do: the same pages as the
    ranks')."""
    import torch
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import ModelMesh, mesh_coords
    from repro_torch.models import model
    B, S, pt = DECODE_RANK_SMALL
    out = {}
    for name, arch, mname, over in small_rank_cases():
        cfg = small_config(arch, over)
        params = model.init_params(cfg, 0, "cuda")
        shape = DECODE_MESHES[mname]
        axes = model.leaf_axes(params)
        digests = []
        for r in range(RANKS):
            mesh = ModelMesh(shape, r, mesh_coords(shape, r),
                             torch.device("cuda"), "", {})
            digests.append({n: digest(sharding.local_block(
                p, sharding.spec_for(shape, axes[n], p.shape), mesh))
                for n, p in params.named_parameters()})
        rng = np.random.default_rng(len(name))
        tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        ctx = decode_ctx(model, configs, cfg, B, S, pt)
        bt = np.arange(B * ctx.n_pages, dtype=np.int32).reshape(B, -1)
        lg, states = teacher_forced(model, params, cfg, tokens, bt, ctx)
        done, _, steps = serve.serve(cfg, mesh=shape, seed=0, verbose=False,
                                     device="cuda", **DECODE_RANK_SMALL_SERVE)
        out[name] = dict(
            digests=digests, tokens=tokens, bt=bt, logits=lg.cpu().numpy(),
            pools=[(s["k_pool"].cpu().numpy(), s["v_pool"].cpu().numpy())
                   for s in states],
            outs={r["id"]: r["out"] for r in done}, steps=steps)
        del params, states, lg
    torch.cuda.empty_cache()
    return out


def rank_small_decode(meshes, refs):
    """(a) on one rank: each case's ``init_params_sharded`` digests, its
    teacher-forced logits rows and pool slices through the serve step on a
    grouped block table from the rank's ``PageTableManager``, and a
    ``serve()`` over the mesh."""
    import torch
    from repro_torch import configs
    from repro_torch.core import hashmap
    from repro_torch.core.paged_kv import PageTableManager
    from repro_torch.distributed import steps
    from repro_torch.launch import serve
    from repro_torch.models import model
    B, S, pt = DECODE_RANK_SMALL
    out = {}
    for name, arch, mname, over in small_rank_cases():
        mesh = meshes[mname]
        cfg = small_config(arch, over)
        params = model.init_params_sharded(cfg, 0, mesh)
        scfg = configs.ServeConfig(model=cfg, shape=configs.ShapeConfig(
            "t", S, B, "decode"), kv_page_tokens=pt)
        step, ctx = steps.build_serve_step(cfg, scfg, mesh=mesh)
        groups = mesh.size(ctx.batch_axes)
        mgr = PageTableManager(ctx.pool_pages,
                               num_channels=mesh.size(ctx.channel_axes),
                               num_groups=groups, backend="perf",
                               device=mesh.device)
        phys = mgr.alloc_seqs([(b, ctx.n_pages, b // (B // groups))
                               for b in range(B)])
        bt = np.stack([phys[b] for b in range(B)])
        rows = ctx.local_batch(B)
        states = model.init_decode_states(params, cfg, rows.stop - rows.start,
                                          ctx, kv_dtype=torch.float32)
        tok = torch.from_numpy(refs[name]["tokens"][rows]).to(mesh.device)
        bt_d = torch.from_numpy(bt[rows]).to(mesh.device)
        lg = []
        for i in range(S):
            pos = torch.full((rows.stop - rows.start,), i, dtype=torch.int32,
                             device=mesh.device)
            _, logits, states = step(params, states, tok[:, i:i + 1], pos,
                                     bt_d)
            lg.append(logits[:, 0].cpu())
        done, smgr, n_steps = serve.serve(
            cfg, mesh=mesh, seed=0, verbose=False, **DECODE_RANK_SMALL_SERVE)
        out[name] = dict(
            digests={n: digest(p) for n, p in params.named_parameters()},
            rows=(rows.start, rows.stop), bt=bt,
            flat=mesh.index(ctx.batch_axes + ctx.channel_axes),
            logits=torch.stack(lg).numpy(),
            pools=[(s["k_pool"].cpu().numpy(), s["v_pool"].cpu().numpy())
                   for s in states],
            outs={r["id"]: r["out"] for r in done}, steps=n_steps,
            table=(table_digests(hashmap, smgr.hm),
                   [list(a) for a in smgr.free]))
        del params, states
    torch.cuda.empty_cache()
    return out


def table_digests(hashmap, hm) -> dict:
    """{leaf: sha256} of a table (its block tables, every entry)."""
    import hashlib
    return {n: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
            for n, a in hashmap.to_numpy(hm).items()}


def rank_paper_decode(mesh, k):
    """(b) on one rank: Qwen3-8B at its published widths, this rank's block
    drawn by ``init_params_sharded``; float32 teacher-forced logits of the
    first ``DECODE_RANK_TF`` steps of ``DECODE_TF`` against phase 10's;
    then ``DECODE_RANK_SERVE`` served and timed (``DecodeTimer``), with
    the collectives, launches and peak memory of the serve."""
    import torch
    from repro_torch import configs
    from repro_torch.core import hashmap
    from repro_torch.core.paged_kv import PageTableManager
    from repro_torch.distributed import steps
    from repro_torch.launch import serve
    from repro_torch.models import model
    dev = mesh.device
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are on: float32 decode would not be float32")
    cfg32 = configs.get_config(DECODE_ARCH).replace(dtype="float32")
    B, S, pt = DECODE_TF
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(k)
    params, init_s = host_s(lambda: model.init_params_sharded(cfg32, 0,
                                                              mesh))
    n_local = sum(p.numel() for p in params.parameters())
    scfg = configs.ServeConfig(model=cfg32, shape=configs.ShapeConfig(
        "t", S, B, "decode"), kv_page_tokens=pt)
    step, ctx = steps.build_serve_step(cfg32, scfg, mesh=mesh)
    check(not ctx.batch_axes, "(b) expects every rank on every row")
    mgr = PageTableManager(ctx.pool_pages,
                           num_channels=mesh.size(ctx.channel_axes),
                           backend="perf", device=dev)
    phys = mgr.alloc_seqs([(b, ctx.n_pages, 0) for b in range(B)])
    bt = mgr.block_table(list(range(B)), ctx.n_pages)
    check(all(np.array_equal(bt[b], phys[b]) for b in range(B)),
          "the probed block table differs from the allocation")
    tokens = np.random.default_rng(1).integers(
        0, cfg32.vocab_size, (B, S)).astype(np.int32)
    want = torch.from_numpy(np.load(DECODE_RANK_DATA / "tf_logits.npy"))
    states = model.init_decode_states(params, cfg32, B, ctx,
                                      kv_dtype=torch.float32)
    tok, bt_d = torch.from_numpy(tokens).to(dev), torch.from_numpy(bt).to(dev)

    def forced():
        nonlocal states
        got = []
        for i in range(DECODE_RANK_TF):
            pos = torch.full((B,), i, dtype=torch.int32, device=dev)
            _, lg, states = step(params, states, tok[:, i:i + 1], pos, bt_d)
            got.append(lg[:, 0].cpu())
        return torch.stack(got)
    got, tf_s = host_s(forced)
    ok = torch.isclose(got, want, rtol=DECODE_TOL, atol=DECODE_TOL)
    tf = dict(err=float((got - want).abs().max()), bad=int((~ok).sum()),
              finite=bool(torch.isfinite(got).all()), seconds=tf_s,
              largest=float(want.abs().max()))
    tf_launches = read_launches(k)["probe_perf"]
    del params, states, got
    torch.cuda.empty_cache()

    cfg = configs.get_config(DECODE_ARCH)
    reset_launches(k)
    torch.cuda.reset_peak_memory_stats(dev)
    before = collective_counts(mesh)
    with DecodeTimer() as timer:
        done, smgr, n_steps = serve.serve(cfg, mesh=mesh, seed=0,
                                          verbose=False, **DECODE_RANK_SERVE)
        sync()
        wall = time.perf_counter() - timer.t_first
    coll = collectives_since(mesh, before)
    return dict(init_s=init_s, n_local=n_local, tf=tf,
                tf_launches=tf_launches, outs={r["id"]: r["out"]
                                               for r in done},
                steps=n_steps, step_ms=timer.step_ms, wall=wall,
                table_ms=timer.table_ms, collectives=coll,
                launches=read_launches(k)["probe_perf"],
                peak=torch.cuda.max_memory_allocated(dev) / 2**30,
                live=smgr.live_pages(), table=table_digests(hashmap, smgr.hm))


def decode_rank_main(world, refs, parts):
    """Phase 15 on one rank: (a) and (b), or (b) alone (``parts``)."""
    from repro_torch.launch.mesh import make_model_mesh
    t_enter = time.time()
    k = rank_kernels()
    meshes = {n: make_model_mesh(world, s) for n, s in DECODE_MESHES.items()}
    out = dict(device=str(world.device), backend=world.backend,
               coords={n: m.coords for n, m in meshes.items()})
    if "small" in parts:
        reset_launches(k)
        t0 = time.perf_counter()
        out["small"] = rank_small_decode(meshes, refs)
        out["small_s"] = time.perf_counter() - t0
        out["small_launches"] = read_launches(k)["probe_perf"]
    if "paper" in parts:
        t0 = time.perf_counter()
        out["paper"] = rank_paper_decode(meshes[DECODE_RANK_MESH], k)
        out["paper_s"] = time.perf_counter() - t0
    out["span"] = (t_enter, time.time())
    return out


def check_small_ranks(refs, outs):
    """(a): every rank's digests, logits rows, pools, served tokens and
    page table against the one-card run and each other."""
    n = 0
    for name, arch, mname, _ in small_rank_cases():
        ref = refs[name]
        res = [o["small"][name] for o in outs]
        for r, got in enumerate(res):
            check(got["digests"] == ref["digests"][r],
                  f"ranks {name}: rank {r}'s shard differs from the slice of "
                  f"the one-card draw")
            a, b = got["rows"]
            err = float(np.abs(got["logits"] - ref["logits"][:, a:b]).max())
            check(err <= DECODE_TOL, f"ranks {name}: rank {r}'s logits "
                  f"{err} from the one-card run's")
            check(got["outs"] == ref["outs"] and got["steps"] == ref["steps"],
                  f"ranks {name}: rank {r}'s served tokens differ")
            check(got["table"] == res[0]["table"]
                  and np.array_equal(got["bt"], res[0]["bt"]),
                  f"ranks {name}: rank {r}'s page table differs from rank "
                  f"0's")
        check(sorted(g["flat"] for g in res) == list(range(RANKS)),
              f"ranks {name}: pool slices")
        order = sorted(range(RANKS), key=lambda r: res[r]["flat"])
        bt4, bt1 = res[0]["bt"], ref["bt"]
        kv = 0.0
        for layer, (k1, v1) in enumerate(ref["pools"]):
            for which, one in ((0, k1), (1, v1)):
                whole = np.concatenate([res[r]["pools"][layer][which]
                                        for r in order])
                kv = max(kv, float(np.abs(whole[bt4] - one[bt1]).max()))
                used = np.zeros(len(whole), bool)
                used[bt4.reshape(-1)] = True
                check(np.array_equal(whole[bt4].any(axis=(2, 3, 4)),
                                     one[bt1].any(axis=(2, 3, 4)))
                      and not whole[~used].any(),
                      f"ranks {name}: pages with keys differ (layer "
                      f"{layer})")
        check(kv <= DECODE_TOL, f"ranks {name}: pools {kv} from one card's")
        n += 1
    return n


def first_divergence(ref, outs, prompt_len):
    """[(request, output index, one-card token, ranks' token, one-card
    margin, bound)] at each request's first differing token: the margin
    l(a) - l(b) of the one-card logits and the bound BF16_U (S_a + S_b)
    (``TopLogits``); the ranks' token must be among the one-card top."""
    out = []
    for i, one in enumerate(ref["outs"]):
        got = outs[i]
        diff = [j for j, (x, y) in enumerate(zip(one, got)) if x != y]
        if not diff:
            continue
        j = diff[0]
        vals, idx, s_v = ref["top"][prompt_len - 1 + j][:, i]
        a, b = int(one[j]), int(got[j])
        check(int(idx[0]) == a, f"request {i}: the kept top logit is not "
              f"the one-card token")
        where = np.nonzero(idx.astype(np.int64) == b)[0]
        check(where.size == 1, f"request {i} output {j}: the ranks' token "
              f"{b} is not among the one-card top {TOP_LOGITS}")
        w = int(where[0])
        out.append((i, j, a, b, float(vals[0] - vals[w]),
                    float(BF16_U * (s_v[0] + s_v[w]))))
    return out


def check_recorded_serve(papers, label, smi):
    """(b)'s collectives on every rank against the dry-run's: a
    ``RecordingMesh``'s trace of one serve step of the same cell
    (``dryrun.trace_decode``: Qwen3-8B at its published widths,
    ``DECODE_RANK_SERVE``'s batch, horizon and pages, float32 pools, the
    vocabulary block's logits) on the first and the last rank; its calls
    and bytes by kind, times the steps served, must be what each rank's
    gloo or NCCL mesh counted."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import recording_mesh
    kw = DECODE_RANK_SERVE
    cfg = configs.get_config(DECODE_ARCH)
    scfg = configs.ServeConfig(model=cfg, shape=configs.ShapeConfig(
        "serve", kw["horizon"], kw["batch"], "decode"),
        kv_page_tokens=kw["page_tokens"])
    t0 = time.perf_counter()
    for r in (0, RANKS - 1):
        tr = dryrun.trace_decode(cfg, scfg, recording_mesh(
            DECODE_MESHES[DECODE_RANK_MESH], r), kv_dtype=torch.float32)
        step = {k: (v["calls"], v["bytes"])
                for k, v in tr.counts.by_kind.items()}
        for q, p in enumerate(papers):
            n = p["steps"]
            got = {k: (v["calls"], v["bytes"])
                   for k, v in p["collectives"]["by_kind"].items()}
            check(got == {k: (c * n, b * n) for k, (c, b) in step.items()},
                  f"{label}: rank {q}'s collectives over {n} steps {got} "
                  f"are not {n} x the RecordingMesh's step of rank {r} "
                  f"{step}")
    print(f"{label}_recorded: the dry-run's RecordingMesh trace of one "
          f"serve step on ranks 0 and {RANKS - 1} (fake tensors, "
          f"{time.perf_counter() - t0:.1f} s) counts every rank's "
          f"collectives a step, call for call and byte for byte by kind: "
          + ", ".join(f"{k} {c} x {b / max(c, 1) / 1e6:.3f} MB"
                      for k, (c, b) in sorted(step.items()))
          + f"; card: {smi}")


def check_paper_ranks(outs, label, smi, one_card_ms):
    """(b): the float32 logits, the served tokens against phase 10's
    reference, and the timing line."""
    papers = [o["paper"] for o in outs]
    for r, p in enumerate(papers):
        tf = p["tf"]
        check(p["tf_launches"] > 0 and p["launches"] > 0,
              f"{label}: rank {r} launched no probe_perf")
        check(tf["finite"] and tf["bad"] == 0, f"{label}: rank {r}'s float32 "
              f"logits differ from phase 10's at {tf['bad']} logits, max "
              f"|diff| {tf['err']}")
        check(p["outs"] == papers[0]["outs"] and p["table"] ==
              papers[0]["table"] and p["live"] == 0,
              f"{label}: rank {r}'s tokens or page table differ from rank "
              f"0's")
    ref = np.load(DECODE_RANK_DATA / "serve_ref.npz")
    kw = DECODE_RANK_SERVE
    outs0 = papers[0]["outs"]
    check(sorted(outs0) == list(range(kw["requests"])) and all(
        len(v) == kw["max_new"] for v in outs0.values()),
        f"{label}: requests ended short")
    div = first_divergence(ref, [outs0[i] for i in range(kw["requests"])],
                           kw["prompt_len"])
    for i, j, a, b, margin, bound in div:
        print(f"{label}_divergence: request {i} output {j}: one card {a}, "
              f"ranks {b}; one-card margin {margin:.6f} against the bf16 "
              f"rounding bound {bound:.6f}")
        check(margin <= bound, f"{label}: request {i} diverges at output {j} "
              f"with a one-card margin {margin} above the bound {bound}")
    same = sum(int(x == y) for i in range(kw["requests"])
               for x, y in zip(ref["outs"][i], outs0[i]))
    st = np.asarray(papers[0]["step_ms"])
    med = float(np.median(st))
    steps = papers[0]["steps"]
    gen = kw["requests"] * kw["max_new"]
    wall = max(p["wall"] for p in papers)
    colls = [p["collectives"] for p in papers]
    check_recorded_serve(papers, label, smi)
    tf = papers[0]["tf"]
    print(f"{label}_tf {DECODE_ARCH}: {DECODE_RANK_TF} teacher-forced steps "
          f"x {DECODE_TF[0]} sequences in float32 on {DECODE_RANK_MESH}, "
          f"every rank's logits within {DECODE_TOL} of phase 10's one-card "
          f"logits: max |diff| "
          f"{max(p['tf']['err'] for p in papers):.3e} (largest |logit| "
          f"{tf['largest']:.3f}); {tf['seconds']:.3f} s; "
          f"{papers[0]['n_local']} params a rank drawn in "
          f"{max(p['init_s'] for p in papers):.3f} s")
    print(f"{label}_serve {DECODE_ARCH} (params float32, activations "
          f"bfloat16, KV float32) over {RANKS} ranks on {DECODE_RANK_MESH}: "
          f"{kw['requests']} requests of prompt {kw['prompt_len']} + "
          f"{kw['max_new']} new at batch {kw['batch']}, horizon "
          f"{kw['horizon']}; {steps} steps, {gen} tokens in {wall:.3f} s = "
          f"{gen / wall:.1f} tokens/s; step ms median {med:.3f} (min "
          f"{st.min():.3f}, max {st.max():.3f}); one card (phase 10, same "
          f"settings) median {one_card_ms:.3f} ms; tokens equal to the "
          f"one-card run {same}/{gen}, {len(div)} requests diverge, each "
          f"within the bf16 bound; collectives a step "
          f"{colls[0]['calls'] / steps:.1f}, {colls[0]['bytes'] / steps / 1e3:.1f} "
          f"kB sent by rank 0, host ms in them a step by rank "
          f"{[round(c['seconds'] / steps * 1e3, 3) for c in colls]} "
          f"({colls[0]['seconds'] / papers[0]['wall'] * 100:.1f}% of rank "
          f"0's serve; by kind a step on rank 0: "
          f"{kinds_line(colls[0]['by_kind'], steps)}); "
          f"page-table host ms a step {papers[0]['table_ms'] / steps:.3f}; "
          f"probe_perf launches by rank "
          f"{[p['tf_launches'] + p['launches'] for p in papers]}; peak a "
          f"rank {max(p['peak'] for p in papers):.2f} GiB; card: {smi}")
    return sum(p["tf_launches"] + p["launches"] for p in papers)


def decode_ranks_path(smi):
    """Phase 15: decode over (data, model) meshes of ``RANKS`` rank
    processes (``spawn_ranks``, as phase 14): (a) the small meshes against
    one card, (b) Qwen3-8B at its published widths on (1, 4) against phase
    10; (c) (b) again over NCCL with a card a rank where there are four.
    Returns the ranks' ``probe_perf`` launches."""
    import torch
    from repro_torch.launch.mesh import spawn_ranks
    t_phase = time.perf_counter()
    refs = small_rank_references()
    ref_s = time.perf_counter() - t_phase
    one_card_ms = float(np.median(np.load(
        DECODE_RANK_DATA / "serve_ref.npz")["step_ms"]))
    torch.cuda.empty_cache()
    print(f"decode_ranks: parent holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB before spawning")
    t0, w0 = time.perf_counter(), time.time()
    outs = spawn_ranks(decode_rank_main, RANKS, refs, ("small", "paper"),
                       backend="gloo", device="cuda:0", timeout=RANK_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    start_s = max(o["span"][0] for o in outs) - w0
    end_s = time.time() - max(o["span"][1] for o in outs)
    n = check_small_ranks(refs, outs)
    small_l = sum(o["small_launches"] for o in outs)
    print(f"decode_ranks_small: {n} cases (the four dense archs at smoke "
          f"size on {' and '.join(DECODE_MESHES)}, qwen3 with 2 KV heads on "
          f"1x4) over {RANKS} ranks (gloo, all on cuda:0) equal one card: "
          f"shards = slices of the one-card draw (sha256), "
          f"{DECODE_RANK_SMALL[1]} "
          f"teacher-forced steps' logits and the pools within {DECODE_TOL} "
          f"(the same pages hold keys), served tokens equal, every rank's "
          f"page table equal; probe_perf launches over the ranks {small_l}; "
          f"one-card references {ref_s:.3f} s, ranks "
          f"{max(o['small_s'] for o in outs):.3f} s")
    launches = small_l + check_paper_ranks(outs, "decode_ranks", smi,
                                           one_card_ms)
    lines = [f"gloo {spawn_s:.3f} s (the ranks started {start_s:.3f} s "
             f"after the spawn and were joined {end_s:.3f} s after their "
             f"last return)"]
    if torch.cuda.device_count() >= RANKS:
        t0 = time.perf_counter()
        nccl = spawn_ranks(decode_rank_main, RANKS, refs, ("paper",),
                           backend="nccl", device=None, timeout=RANK_TIMEOUT)
        check([o["device"] for o in nccl] ==
              [f"cuda:{r}" for r in range(RANKS)], "nccl: a card a rank")
        launches += check_paper_ranks(nccl, "decode_ranks_nccl", smi,
                                      one_card_ms)
        lines.append(f"nccl {time.perf_counter() - t0:.3f} s")
    print(f"decode_ranks_time: phase 15 took "
          f"{time.perf_counter() - t_phase:.3f} s (one-card references "
          f"{ref_s:.3f} s; {', '.join(lines)}, spawn to the last rank's "
          f"exit; in the ranks (a) {max(o['small_s'] for o in outs):.3f} s, "
          f"(b) {max(o['paper_s'] for o in outs):.3f} s); card: {smi}")
    return launches


# ---------------------------------------------------------------------------
# 16. training over a (data, model) mesh of ranks
# ---------------------------------------------------------------------------

def collective_counts(mesh) -> dict:
    """A copy of ``mesh.collectives``: the totals and each kind's."""
    import copy
    return copy.deepcopy(mesh.collectives)


def collectives_since(mesh, before) -> dict:
    """``mesh.collectives`` less ``before``: totals and by kind."""
    now = mesh.collectives
    out = {k: now[k] - before[k] for k in ("calls", "bytes", "seconds")}
    zero = {"calls": 0, "bytes": 0, "seconds": 0.0}
    out["by_kind"] = {kind: {k: v[k] - before["by_kind"].get(kind, zero)[k]
                             for k in zero}
                      for kind, v in now["by_kind"].items()}
    out["by_kind"] = {k: v for k, v in out["by_kind"].items() if v["calls"]}
    return out


def kinds_line(by_kind, steps) -> str:
    """Calls, MB sent and host ms a step of each kind/pass."""
    return ", ".join(
        f"{k} {v['calls'] / steps:.1f} x {v['bytes'] / max(v['calls'], 1) / 1e6:.3f} "
        f"MB, {v['seconds'] / steps * 1e3:.1f} ms"
        for k, v in sorted(by_kind.items()))


TRAIN_RANK_SMALL = dict(batch=4, seq=64)
TRAIN_RANK_TOL = 1e-5
TRAIN_RANK_CKPT = "qwen3-8b@2x2"
# (b): OLMoE-1B-7B at its published widths on (2, 2) with expert
# parallelism, cut to 4 of 16 layers (1.885G params: 30.2 GB of float32
# parameters, gradients and moments over the 4 ranks) at phase 12's
# 4 x 4096, 3 steps (the first untimed), no checkpoint; at 2 layers its
# loss did not fall in 3 steps (11.26, 12.22, 11.31; PR 25 chip run 6)
TRAIN_RANK_FULL = dict(arch="olmoe-1b-7b", mesh="2x2", depth=4, seq=4096,
                       batch=4, steps=3)
TRAIN_RANK_NCCL_DEPTH = 16       # (c): all 16 layers, a card a rank


def train_rank_cases() -> list:
    """(a): [(name, arch, mesh, config overrides, seq_shard, compression,
    steps)] at smoke widths, 2 layers, float32.  EP at capacity_factor = E
    drops nothing, so it equals the one-card (global) dispatch up to the
    order of the additions."""
    E = 8                                   # smoke_config's experts
    return [
        ("qwen3-8b@2x2", "qwen3-8b", "2x2", {}, True, "none", 2),
        ("qwen3-8b-kv2@1x4", "qwen3-8b", "1x4", {"num_kv_heads": 2}, False,
         "int8", 1),
        ("olmoe-gspmd@2x2", "olmoe-1b-7b", "2x2", {}, True, "none", 1),
        ("olmoe-ep@2x2", "olmoe-1b-7b", "2x2",
         {"moe_impl": "ep", "capacity_factor": float(E)}, True, "none", 1),
        ("internvl2-2b@2x2", "internvl2-2b", "2x2", {}, True, "none", 1)]


def train_rank_batches(cfg, steps):
    """The global batches of (a), pads in rows 0 and 2, as torch tensors on
    the host."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import SyntheticLMData
    data = SyntheticLMData(cfg, ShapeConfig("t", TRAIN_RANK_SMALL["seq"],
                                            TRAIN_RANK_SMALL["batch"],
                                            "train"))
    out = []
    for s in range(steps):
        b = data.batch_at(s)
        b["labels"][0, :10] = -100
        b["labels"][2, -5:] = -100
        out.append({k: torch.from_numpy(v) for k, v in b.items()})
    return out


def small_train_rank_references(cases=None) -> dict:
    """(a) on one card: each case's (``train_rank_cases()`` by default)
    metrics, gradient and parameters after every step of the port's
    one-card step from ``init_params(cfg, 0)``, float32 with TF32 off
    (numpy, by parameter name)."""
    import torch
    from repro_torch.configs import OptimConfig
    from repro_torch.distributed import steps
    from repro_torch.models import model
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are on: float32 training would not be float32")
    out = {}
    for name, arch, _, over, _, comp, n in cases or train_rank_cases():
        cfg = small_config(arch, over)
        oc = OptimConfig(**TRAIN_OC)
        params = model.init_params(cfg, 0, "cuda")
        opt = steps.init_opt_state(params, oc)
        step = steps.build_train_step(cfg, oc, grad_compression=comp)
        batches = [{k: v.cuda() for k, v in b.items()}
                   for b in train_rank_batches(cfg, n)]
        _, _, grads = step.loss_and_grads(params, batches[0])
        ref = dict(grads=_np_blocks(grads), metrics=[], params=[])
        for b in batches:
            params, opt, m = step(params, opt, b)
            ref["metrics"].append({k: float(v) for k, v in m.items()})
            ref["params"].append(_np_blocks(dict(params.named_parameters())))
        out[name] = ref
        del params, opt, grads
    torch.cuda.empty_cache()
    return out


def _np_blocks(named) -> dict:
    """Host copies (never views of the tensors, which steps update in
    place)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in named.items()}


def rank_small_train(meshes, cases=None):
    """(a) on one rank: each case's (``train_rank_cases()`` by default)
    gradient and steps from ``init_params_sharded``; the checkpoint case
    saves its step-1 state, restores it on (1, 4), and resumes its step 2
    on its mesh."""
    import shutil
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import OptimConfig
    from repro_torch.distributed import steps
    from repro_torch.launch.train import _restore_tree_shapes
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are on in a rank")
    ckpt_dir = CKPT_ROOT / "train_ranks"
    out = {}
    for name, arch, mname, over, seq_shard, comp, n in \
            cases or train_rank_cases():
        mesh = meshes[mname]
        cfg = small_config(arch, over)
        oc = OptimConfig(**TRAIN_OC)
        params, opt = steps.init_train_state(cfg, oc, mesh, 0)
        step = steps.build_train_step(cfg, oc, mesh, seq_shard=seq_shard,
                                      grad_compression=comp)
        batches = train_rank_batches(cfg, n)
        _, _, grads = step.loss_and_grads(params, batches[0])
        res = dict(grads=_np_blocks(grads), metrics=[], params=[],
                   specs={k: p.spec for k, p in params.named_parameters()})
        for s, b in enumerate(batches):
            params, opt, m = step(params, opt, b)
            res["metrics"].append({k: float(v) for k, v in m.items()})
            res["params"].append(_np_blocks(dict(params.named_parameters())))
            if name == TRAIN_RANK_CKPT and s == 0:
                if mesh.rank == 0 and ckpt_dir.exists():
                    shutil.rmtree(ckpt_dir)
                t0 = time.perf_counter()
                ck = Checkpointer(str(ckpt_dir), mesh=mesh)
                ck.save(1, {"params": params, "opt": opt})
                ck.wait()
                res["save_s"] = time.perf_counter() - t0
        if name == TRAIN_RANK_CKPT:
            other = meshes["1x4"]
            st = Checkpointer(str(ckpt_dir), mesh=other).restore(
                1, _restore_tree_shapes(cfg, oc, other), mesh.device)
            res["restored_1x4"] = _np_blocks(dict(
                st["params"].named_parameters()))
            res["specs_1x4"] = {k: p.spec for k, p in
                                st["params"].named_parameters()}
            ck = Checkpointer(str(ckpt_dir), mesh=mesh)
            st = ck.restore(ck.latest_step(),
                            _restore_tree_shapes(cfg, oc, mesh), mesh.device)
            p2, _, m2 = step(st["params"], st["opt"], batches[1])
            res["resumed"] = (_np_blocks(dict(p2.named_parameters())),
                              {k: float(v) for k, v in m2.items()})
        out[name] = res
        del params, opt, grads
    torch.cuda.empty_cache()
    return out


class RankStepMeter:
    """``steps.build_train_step`` wrapped for the length of a ``with``
    block on a rank: each step timed between synchronises, its metrics
    kept, and the mesh's collectives counted over it."""

    def __init__(self, mesh, keys):
        self.mesh, self.keys, self.rows = mesh, keys, []

    def __enter__(self):
        from repro_torch.distributed import steps
        self._build = steps.build_train_step
        meter = self

        def build(*a, **kw):
            fn = meter._build(*a, **kw)

            def step(*sa, **skw):
                sync()
                before = collective_counts(meter.mesh)
                t0 = time.perf_counter()
                out = fn(*sa, **skw)
                sync()
                ms = (time.perf_counter() - t0) * 1e3
                meter.rows.append(dict(
                    ms=ms, coll=collectives_since(meter.mesh, before),
                    **{k: float(out[2][k]) for k in meter.keys}))
                return out
            return step
        steps.build_train_step = build
        return self

    def __exit__(self, *exc):
        from repro_torch.distributed import steps
        steps.build_train_step = self._build


def rank_full_train(mesh, depth):
    """(b) on one rank: OLMoE-1B-7B at its published widths, ``depth``
    layers, expert parallelism, ``TRAIN_RANK_FULL``'s steps through
    ``launch.train.train`` (no checkpoint)."""
    import torch
    from repro_torch import configs
    from repro_torch.launch.train import train
    f = TRAIN_RANK_FULL
    cfg = configs.get_config(f["arch"]).replace(num_layers=depth,
                                                moe_impl="ep")
    shape = configs.ShapeConfig("train_4k_cut", f["seq"], f["batch"],
                                "train")
    oc = configs.OptimConfig(lr=3e-4, warmup_steps=f["steps"] // 5 + 1,
                             total_steps=f["steps"])
    keys = ("loss", "ce_loss", "moe_aux", "moe_z", "moe_dropped",
            "grad_norm")
    torch.cuda.reset_peak_memory_stats(mesh.device)
    t0 = time.perf_counter()
    with RankStepMeter(mesh, keys) as meter:
        params, opt, losses, _, _ = train(
            cfg, shape, oc, mesh, num_steps=f["steps"], ckpt_dir=None,
            verbose=False)
    run_s = time.perf_counter() - t0
    n_local = sum(p.numel() for p in params.parameters())
    p_bytes = sum(t.numel() * t.element_size() for t in params.parameters())
    state_gb = (2 * p_bytes + sum(   # the parameters, their gradients
        t.numel() * t.element_size() for t in
        list(opt["m"].values()) + list(opt["v"].values()))) / 1e9
    del params, opt
    torch.cuda.empty_cache()
    return dict(rows=meter.rows, losses=[losses[s] for s in sorted(losses)],
                run_s=run_s, n_local=n_local, state_gb=state_gb,
                peak=torch.cuda.max_memory_allocated(mesh.device) / 2**30)


def train_rank_main(world, parts, depth):
    """Phase 16 on one rank: (a) and (b), or (b) alone (``parts``)."""
    from repro_torch.launch.mesh import make_model_mesh
    t_enter = time.time()
    meshes = {n: make_model_mesh(world, s) for n, s in DECODE_MESHES.items()}
    out = dict(device=str(world.device), backend=world.backend,
               coords={n: m.coords for n, m in meshes.items()})
    if "small" in parts:
        t0 = time.perf_counter()
        out["small"] = rank_small_train(meshes)
        out["small_s"] = time.perf_counter() - t0
    if "full" in parts:
        t0 = time.perf_counter()
        out["full"] = rank_full_train(meshes[TRAIN_RANK_FULL["mesh"]], depth)
        out["full_s"] = time.perf_counter() - t0
    out["span"] = (t_enter, time.time())
    return out


def _close_step(got, want, what):
    check(set(got) == set(want), f"{what}: metrics {sorted(got)} are not "
          f"one card's {sorted(want)}")
    for k in ("loss", "ce_loss", "grad_norm", "lr", "moe_aux", "moe_z"):
        if k in want:
            check(abs(got[k] - want[k]) <= TRAIN_RANK_TOL * abs(want[k]),
                  f"{what}: {k} {got[k]} against one card's {want[k]}")
    if "moe_dropped" in want:
        check(got["moe_dropped"] == want["moe_dropped"],
              f"{what}: moe_dropped {got['moe_dropped']} against one card's "
              f"{want['moe_dropped']}")


def check_small_train_ranks(refs, outs, cases=None, key="small",
                            grad_tols=None):
    """(a): every rank's metrics, gradient blocks and stepped parameter
    blocks (``outs[r][key]``) against the one-card references, a gradient
    block within ``grad_tols[arch]`` (default ``TRAIN_RANK_TOL``) of its
    leaf's largest, and a never-read ``final_norm.bias`` (whisper's) with
    a zero gradient and zero after every step; where the cases
    (``train_rank_cases()`` by default) hold the checkpoint's, its
    restore on (1, 4) and on one card, and the resumed step.  Returns
    (cases, worst gradient error over its leaf's largest, worst parameter
    error where |g| >= 1e-6, int8 elements a step apart)."""
    cases = cases or train_rank_cases()
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import OptimConfig
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import ModelMesh
    from repro_torch.launch.train import _restore_tree_shapes
    worst_g = worst_p = 0.0
    flips = 0
    for name, arch, mname, over, _, comp, n in cases:
        ref = refs[name]
        for r, o in enumerate(outs):
            got = o[key][name]
            mesh = ModelMesh(DECODE_MESHES[mname], r, o["coords"][mname],
                             torch.device("cpu"), "", {})
            for s in range(n):
                _close_step(got["metrics"][s], ref["metrics"][s],
                            f"{name} rank {r} step {s}")
            lr = ref["metrics"][0]["lr"]
            for k, g in got["grads"].items():
                spec = got["specs"][k]
                wg = ref["grads"][k]
                scale = max(float(np.abs(wg).max()), 1e-30)
                blk = sharding.local_block(torch.from_numpy(wg), spec,
                                           mesh).numpy()
                err = float(np.abs(g - blk).max()) / scale
                worst_g = max(worst_g, err)
                check(err <= (grad_tols or {}).get(arch, TRAIN_RANK_TOL),
                      f"{name} rank {r}: gradient of {k} off by {err:.3e} "
                      f"of its largest")
                if k == "final_norm.bias":
                    check(not g.any() and not any(
                        got["params"][s][k].any() for s in range(n)),
                        f"{name} rank {r}: final_norm.bias, which the loss "
                        f"never reads, has a gradient or moved")
                for s in range(n):
                    wp = sharding.local_block(torch.from_numpy(
                        ref["params"][s][k]), spec, mesh).numpy()
                    d = np.abs(got["params"][s][k] - wp)
                    sure = np.abs(blk) >= 1e-6
                    off = d[sure] > TRAIN_RANK_TOL
                    if comp == "int8":
                        # a gradient within rounding of a half step of the
                        # int8 grid quantizes one step apart: AdamW's first
                        # step then moves its element by lr or by nothing
                        flips += int(off.sum())
                    else:
                        worst_p = max(worst_p, float(d[sure].max(initial=0)))
                        check(not off.any(), f"{name} rank {r} step {s}: "
                              f"parameter {k} off by "
                              f"{d[sure].max(initial=0):.3e}")
                    check(d.max() <= 2 * lr, f"{name} rank {r} step {s}: "
                          f"parameter {k} off by {d.max():.3e}")
    if all(c[0] != TRAIN_RANK_CKPT for c in cases):
        return len(cases), worst_g, worst_p, flips
    # the checkpoint: read back on one card it is the gathered blocks; on
    # (1, 4) each rank's block of it; resumed, the step is bit-equal
    name = TRAIN_RANK_CKPT
    arch, over = [(c[1], c[3]) for c in train_rank_cases() if c[0] == name][0]
    cfg = small_config(arch, over)
    one = Checkpointer(str(CKPT_ROOT / "train_ranks")).restore(
        1, _restore_tree_shapes(cfg, OptimConfig(**TRAIN_OC)), "cuda")
    whole = {k: p.detach().cpu() for k, p in one["params"].named_parameters()}
    mname = [c[2] for c in train_rank_cases() if c[0] == name][0]
    for r, o in enumerate(outs):
        got = o["small"][name]
        for m, blocks, specs in ((mname, got["params"][0], got["specs"]),
                                 ("1x4", got["restored_1x4"],
                                  got["specs_1x4"])):
            mesh = ModelMesh(DECODE_MESHES[m], r, o["coords"][m],
                             torch.device("cpu"), "", {})
            for k, a in blocks.items():
                check(np.array_equal(a, sharding.local_block(
                    whole[k], specs[k], mesh).numpy()),
                    f"checkpoint: rank {r}'s {m} block of {k} is not the "
                    f"one-card restore's")
        p2, m2 = got["resumed"]
        check(m2 == got["metrics"][1] and all(
            np.array_equal(a, got["params"][1][k]) for k, a in p2.items()),
            f"checkpoint: rank {r}'s resumed step differs from the "
            f"uninterrupted one")
    return len(refs), worst_g, worst_p, flips


def check_full_train_ranks(outs, label, smi, depth, cards):
    """(b)/(c): the losses finite and falling, the same on every rank; the
    timing, FLOP, collective and MoE lines."""
    from repro_torch import configs
    from repro_torch.models import model
    f = TRAIN_RANK_FULL
    fulls = [o["full"] for o in outs]
    for r, fu in enumerate(fulls):
        check(fu["losses"] == fulls[0]["losses"],
              f"{label}: rank {r}'s losses differ from rank 0's")
    losses = fulls[0]["losses"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{label}: the loss is not finite and falling: {losses}")
    rows = fulls[0]["rows"]
    check([r_["loss"] for r_ in rows] == losses,
          f"{label}: the metered steps are not train's")
    cfg = configs.get_config(f["arch"]).replace(num_layers=depth,
                                                moe_impl="ep")
    B, S = f["batch"], f["seq"]
    mm, attn, n_params, n_active = train_flops(cfg, B, S)
    # the routed experts' weights at their active share (top_k / E) of the
    # tokens instead of at capacity
    meta = model.Model(cfg, "meta")
    routed = sum(p.numel() for n, p in meta.named_parameters()
                 if ".ffn_moe." in n and ".shared." not in n
                 and not n.endswith("router"))
    C = max(int(B * S * cfg.top_k / cfg.num_experts * cfg.capacity_factor),
            cfg.top_k)
    mm_active = mm - 8 * routed * C + 8 * routed * B * S * cfg.top_k \
        / cfg.num_experts
    timed = [r_["ms"] for r_ in rows[1:]]
    med = float(np.median(timed))
    tokens = B * S
    flops = mm_active + attn
    share = flops / (med / 1e3) / (BF16_RATE * cards)
    colls = [fu["rows"][1:] for fu in fulls]
    nsteps = len(timed)
    by_kind: dict = {}
    for row in colls[0]:
        for k, v in row["coll"]["by_kind"].items():
            acc = by_kind.setdefault(k, {"calls": 0, "bytes": 0,
                                         "seconds": 0.0})
            for q in acc:
                acc[q] += v[q]
    host = [sum(r_["coll"]["seconds"] for r_ in c) / nsteps * 1e3
            for c in colls]
    print(f"{label} {f['arch']}: {depth} of 16 layers at its published "
          f"widths (d_model {cfg.d_model}, {cfg.num_heads} heads, "
          f"{cfg.num_experts} experts top-{cfg.top_k}, d_ff {cfg.d_ff}, "
          f"padded vocab {cfg.padded_vocab}), moe_impl ep over "
          f"{f['mesh']} ({outs[0]['backend']}, {len(outs)} ranks on "
          f"{cards} card(s)); {n_params} params ({n_active} active), "
          f"{fulls[0]['n_local']} a rank, state (params, gradients, "
          f"moments) {fulls[0]['state_gb']:.2f} GB a rank; params float32, "
          f"activations {cfg.dtype}, AdamW float32, remat {cfg.remat}; batch "
          f"{B} x {S} through launch.train.train; step ms "
          f"{[round(r_['ms'], 1) for r_ in rows]} (the first untimed); "
          f"median {med:.1f} ms = {tokens / med * 1e3:.1f} tokens/s; "
          f"{flops / 1e12:.2f} TFLOP a step (the routed experts at their "
          f"active share, + {attn / 1e12:.2f} attention) = "
          f"{share * 100:.3f}% of {cards} x the {BF16_RATE / 1e12:.0f} "
          f"TFLOP/s bf16 peak; peak a rank "
          f"{max(fu['peak'] for fu in fulls):.2f} GiB; run "
          f"{max(fu['run_s'] for fu in fulls):.1f} s; card: {smi}")
    print(f"{label}_collectives: a timed step, rank 0: "
          f"{sum(r_['coll']['calls'] for r_ in colls[0]) / nsteps:.1f} "
          f"calls, {sum(r_['coll']['bytes'] for r_ in colls[0]) / nsteps / 1e9:.3f} "
          f"GB sent; host ms in them a step by rank "
          f"{[round(h, 1) for h in host]} ({host[0] / med * 100:.1f}% of the "
          f"step); by kind: {kinds_line(by_kind, nsteps)}")
    for k in ("loss", "ce_loss", "moe_aux", "moe_z", "moe_dropped",
              "grad_norm"):
        print(f"{label} {k} by step: {[round(r_[k], 6) for r_ in rows]}")
    return med


def train_ranks_path(smi):
    """Phase 16: training over (data, model) meshes of ``RANKS`` rank
    processes (``spawn_ranks``, gloo with every rank on the one card, as
    phases 14 and 15): (a) the small cases and the checkpoint against one
    card, (b) OLMoE-1B-7B at its published widths with expert parallelism;
    (c) with four cards, (b) at all 16 layers over NCCL, a card a rank."""
    import shutil
    import torch
    from repro_torch.launch.mesh import spawn_ranks
    t_phase = time.perf_counter()
    refs = small_train_rank_references()
    ref_s = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    t0, w0 = time.perf_counter(), time.time()
    outs = spawn_ranks(train_rank_main, RANKS, ("small", "full"),
                       TRAIN_RANK_FULL["depth"], backend="gloo",
                       device="cuda:0", timeout=RANK_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    start_s = max(o["span"][0] for o in outs) - w0
    # (b)'s numbers first: a failed check of (a) stops the script
    check_full_train_ranks(outs, "train_ranks_full", smi,
                           TRAIN_RANK_FULL["depth"], 1)
    n, worst_g, worst_p, flips = check_small_train_ranks(refs, outs)
    shutil.rmtree(CKPT_ROOT / "train_ranks", ignore_errors=True)
    save_s = outs[0]["small"][TRAIN_RANK_CKPT]["save_s"]
    print(f"train_ranks_small: {n} cases (qwen3-8b on 2x2 with seq_shard "
          f"and 2 steps, with 2 KV heads on 1x4 and int8 compression, "
          f"olmoe-1b-7b gspmd and ep at capacity_factor = E on 2x2, "
          f"internvl2-2b on 2x2; smoke widths, 2 layers, float32) over "
          f"{RANKS} ranks (gloo, all on cuda:0) equal one card: loss, grad "
          f"norm and aux terms within {TRAIN_RANK_TOL} relative, "
          f"moe_dropped equal, every gradient block within "
          f"{worst_g:.3e} of its leaf's largest, parameters within "
          f"{worst_p:.3e} where |g| >= 1e-6 (with int8 compression "
          f"{flips} elements a quantization step apart, each within 2 lr); "
          f"the {TRAIN_RANK_CKPT} state "
          f"saved after step 1 ({save_s:.3f} s) and restored on one card "
          f"(the gathered blocks, bit for bit) and on 1x4 (each rank's "
          f"block), the step resumed from it bit-equal; one-card references "
          f"{ref_s:.3f} s, ranks {max(o['small_s'] for o in outs):.3f} s")
    lines = [f"gloo {spawn_s:.3f} s (the ranks started {start_s:.3f} s "
             f"after the spawn)"]
    if torch.cuda.device_count() >= RANKS:
        t0 = time.perf_counter()
        nccl = spawn_ranks(train_rank_main, RANKS, ("full",),
                           TRAIN_RANK_NCCL_DEPTH, backend="nccl",
                           device=None, timeout=RANK_TIMEOUT)
        check([o["device"] for o in nccl] ==
              [f"cuda:{r}" for r in range(RANKS)], "nccl: a card a rank")
        check_full_train_ranks(nccl, "train_ranks_nccl", smi,
                               TRAIN_RANK_NCCL_DEPTH, RANKS)
        lines.append(f"nccl {time.perf_counter() - t0:.3f} s")
    print(f"train_ranks_time: phase 16 took "
          f"{time.perf_counter() - t_phase:.3f} s (one-card references "
          f"{ref_s:.3f} s; {', '.join(lines)}; in the ranks (a) "
          f"{max(o['small_s'] for o in outs):.3f} s, (b) "
          f"{max(o['full_s'] for o in outs):.3f} s); card: {smi}")


# ---------------------------------------------------------------------------
# 17. the moe, hybrid and vlm families decoding over a (data, model) mesh of
#     ranks, and the hybrid family training there
# ---------------------------------------------------------------------------

FAMILY_RANK_DATA = ROOT / "build" / "family_ranks"
# (a) at smoke widths in float32, phase 15's 8 teacher-forced steps on
# 2-token pages: olmoe (2 layers), jamba (its 4-layer unit: mamba, MoE,
# attention, MoE) on both meshes, internvl2 (2 layers); float32 on both
# sides, the order of the partial sums apart: logits within 1e-5
# (absolute), greedy tokens equal
FAMILY_RANK_CASES = (
    ("olmoe-1b-7b@2x2", "olmoe-1b-7b", "2x2", {}),
    ("jamba-v0.1-52b@1x4", "jamba-v0.1-52b", "1x4", {"num_layers": 4}),
    ("jamba-v0.1-52b@2x2", "jamba-v0.1-52b", "2x2", {"num_layers": 4}),
    ("internvl2-2b@1x4", "internvl2-2b", "1x4", {}))
FAMILY_RANK_SERVED = "jamba-v0.1-52b@2x2"
FAMILY_RANK_TOL = 1e-5
# jamba's training case, as phase 16 holds its cases (capacity_factor = E,
# the smoke config's 8 experts: EP drops nothing, as one card)
FAMILY_RANK_TRAIN = [("jamba-v0.1-52b-ep@2x2", "jamba-v0.1-52b", "2x2",
                      {"moe_impl": "ep", "capacity_factor": 8.0,
                       "num_layers": 4}, True, "none", 1)]
# (b) jamba at its published widths, phase 12's 8-layer cut, on (1, 4) (no
# expert moves): the first 16 of phase 12's teacher-forced steps within
# 1e-5 of their largest |logit|, then phase 12's bf16 serve
FAMILY_RANK_MESH = "1x4"
FAMILY_RANK_TF = 16
# (c) NCCL, a card a rank: all 32 layers, decode against the forward over
# the ranks on phase 12's 2 x 64 tokens (DECODE_TOL, as phase 12)
FAMILY_RANK_NCCL_DEPTH = 32


def family_rank_config(depth, dtype="float32"):
    """jamba-v0.1-52b at its published widths and ``depth`` layers; in
    float32 with phase 12's capacity_factor = E (no drops), in bfloat16
    (serving) as phase 12 serves it."""
    from repro_torch import configs
    cfg = configs.get_config(HYBRID_ARCH).replace(num_layers=depth)
    if dtype == "float32":
        cfg = cfg.replace(dtype="float32",
                          capacity_factor=float(cfg.num_experts))
    return cfg


def small_family_rank_references(cases=FAMILY_RANK_CASES,
                                 served=FAMILY_RANK_SERVED) -> dict:
    """(a) on one card, each case: its tokens (an encdec case's stub frames
    too, ``SSM_RANK_FRAMES`` of them), the teacher-forced logits (S, B, V)
    on a one-card block table and their greedy tokens; for ``served`` the
    outputs of ``serve()`` at ``DECODE_RANK_SMALL_SERVE`` with the mesh's
    geometry."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are on: float32 decode would not be float32")
    B, S, pt = DECODE_RANK_SMALL
    out = {}
    for name, arch, mname, over in cases:
        cfg = small_config(arch, over)
        params = model.init_params(cfg, 0, "cuda")
        rng = np.random.default_rng(len(name))
        tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        frames = rng.standard_normal((B, SSM_RANK_FRAMES, cfg.d_model)) \
            .astype(np.float32) if cfg.is_encoder_decoder else None
        ctx = decode_ctx(model, configs, cfg, B, S, pt)
        bt = np.arange(B * ctx.n_pages, dtype=np.int32).reshape(B, -1)
        with torch.no_grad():
            lg, _ = teacher_forced(
                model, params, cfg, tokens, bt, ctx,
                None if frames is None else torch.from_numpy(frames).cuda())
        out[name] = dict(tokens=tokens, frames=frames, logits=lg.cpu().numpy(),
                         next=torch.argmax(lg, -1).cpu().numpy())
        if name == served:
            done, _, steps = serve.serve(
                cfg, mesh=DECODE_MESHES[mname], seed=0, verbose=False,
                device="cuda", **DECODE_RANK_SMALL_SERVE)
            out[name].update(outs={r["id"]: r["out"] for r in done},
                             steps=steps)
        del params, lg
    torch.cuda.empty_cache()
    return out


def expert_block_bytes(params) -> int:
    """The bytes of the smallest MoE layer's expert blocks (``gate``,
    ``up``, ``down``) in a rank's model: a gather of the layer would send
    at least these."""
    per_layer: dict = {}
    for n, p in params.named_parameters():
        layer, _, leaf = n.partition(".ffn_moe.")
        if leaf in ("gate", "up", "down"):
            per_layer[layer] = per_layer.get(layer, 0) \
                + p.numel() * p.element_size()
    return min(per_layer.values())


class StepCollectives:
    """The mesh's collective counts for the length of a ``with`` block
    alone (each kind's ``largest`` call included); the earlier counts come
    back added to them at the end."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        import copy
        from repro_torch.launch.mesh import _new_collectives
        self.outer = copy.deepcopy(self.mesh.collectives)
        self.mesh.collectives.update(_new_collectives())
        return self

    def __exit__(self, *exc):
        import copy
        now = self.mesh.collectives
        self.counts = copy.deepcopy(now)
        for k in ("calls", "bytes", "seconds"):
            now[k] += self.outer[k]
        for kind, v in self.outer["by_kind"].items():
            acc = now["by_kind"].setdefault(kind, dict(v))
            if acc is not v:
                for q in ("calls", "bytes", "seconds"):
                    acc[q] += v[q]
                acc["largest"] = max(acc.get("largest", 0),
                                     v.get("largest", 0))

    def largest_gather(self) -> int:
        return max([v.get("largest", 0) for k, v in
                    self.counts["by_kind"].items()
                    if k.startswith("all_gather/")] or [0])


def rank_family_small(meshes, refs, cases=FAMILY_RANK_CASES,
                      served=FAMILY_RANK_SERVED):
    """(a) on one rank: each case's teacher-forced logits rows and greedy
    tokens through the serve step on a grouped block table from the rank's
    ``PageTableManager`` (the largest all-gather of the steps against the
    rank's expert blocks; an encdec case's cross K/V from its rows of the
    stub frames), and ``served``'s ``serve()``."""
    import torch
    from repro_torch import configs
    from repro_torch.core.paged_kv import PageTableManager
    from repro_torch.distributed import steps
    from repro_torch.launch import serve
    from repro_torch.models import model
    B, S, pt = DECODE_RANK_SMALL
    out = {}
    for name, arch, mname, over in cases:
        mesh = meshes[mname]
        cfg = small_config(arch, over)
        params = model.init_params_sharded(cfg, 0, mesh)
        scfg = configs.ServeConfig(model=cfg, shape=configs.ShapeConfig(
            "t", S, B, "decode"), kv_page_tokens=pt)
        step, ctx = steps.build_serve_step(cfg, scfg, mesh=mesh)
        groups = mesh.size(ctx.batch_axes)
        mgr = PageTableManager(ctx.pool_pages,
                               num_channels=mesh.size(ctx.channel_axes),
                               num_groups=groups, backend="perf",
                               device=mesh.device)
        phys = mgr.alloc_seqs([(b, ctx.n_pages, b // (B // groups))
                               for b in range(B)])
        bt = np.stack([phys[b] for b in range(B)])
        rows = ctx.local_batch(B)
        frames = refs[name]["frames"]
        states = model.init_decode_states(
            params, cfg, rows.stop - rows.start, ctx, kv_dtype=torch.float32,
            enc_frames=None if frames is None else torch.from_numpy(
                frames[rows]))
        tok = torch.from_numpy(refs[name]["tokens"][rows]).to(mesh.device)
        bt_d = torch.from_numpy(bt[rows]).to(mesh.device)
        lg, nts = [], []
        with StepCollectives(mesh) as coll:
            for i in range(S):
                pos = torch.full((rows.stop - rows.start,), i,
                                 dtype=torch.int32, device=mesh.device)
                nt, logits, states = step(params, states, tok[:, i:i + 1],
                                          pos, bt_d)
                lg.append(logits[:, 0].cpu())
                nts.append(nt.cpu())
        res = dict(rows=(rows.start, rows.stop),
                   logits=torch.stack(lg).numpy(),
                   next=torch.stack(nts).numpy(),
                   largest_gather=coll.largest_gather(),
                   experts=expert_block_bytes(params) if cfg.num_experts
                   else 0)
        del params, states
        if name == served:
            done, _, n_steps = serve.serve(
                cfg, mesh=mesh, seed=0, verbose=False,
                **DECODE_RANK_SMALL_SERVE)
            res.update(outs={r["id"]: r["out"] for r in done}, steps=n_steps)
        out[name] = res
    torch.cuda.empty_cache()
    return out


def rank_jamba_decode(mesh, k, depth, serial):
    """(b) and (c) on one rank: jamba at its published widths and
    ``depth`` layers, the rank's block drawn by ``init_params_sharded``
    (with ``serial`` the ranks of one card draw one after another: each
    draws every layer whole, and four whole MoE layers beside the blocks
    would not fit); ``FAMILY_RANK_TF`` float32 teacher-forced steps of
    ``HYBRID_TF`` (all of them with ``depth`` 32, and the forward over the
    ranks on the same tokens); then ``HYBRID_SERVE`` in bfloat16 from the
    same draw, timed (``DecodeTimer``), its collectives by kind, launches
    and peak."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core import hashmap
    from repro_torch.core.paged_kv import PageTableManager
    from repro_torch.distributed import sharding, steps
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch import serve
    from repro_torch.models import model
    dev = mesh.device
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are on: float32 decode would not be float32")
    cfg32 = family_rank_config(depth)
    B, S, pt = HYBRID_TF
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(k)
    params = None
    t0 = time.perf_counter()
    for r in range(mesh.num_shards if serial else 1):
        if not serial or mesh.rank == r:
            params, init_s = host_s(lambda: model.init_params_sharded(
                cfg32, 0, mesh))
            torch.cuda.empty_cache()    # the whole layers' memory back
        if serial:
            dist.barrier()
    draw_s = time.perf_counter() - t0
    n_local = sum(p.numel() for p in params.parameters())
    scfg = configs.ServeConfig(model=cfg32, shape=configs.ShapeConfig(
        "t", S, B, "decode"), kv_page_tokens=pt)
    step, ctx = steps.build_serve_step(cfg32, scfg, mesh=mesh)
    check(not ctx.batch_axes, "(b) expects every rank on every row")
    mgr = PageTableManager(ctx.pool_pages,
                           num_channels=mesh.size(ctx.channel_axes),
                           backend="perf", device=dev)
    mgr.alloc_seqs([(b, ctx.n_pages, 0) for b in range(B)])
    bt = mgr.block_table(list(range(B)), ctx.n_pages)
    tokens = np.random.default_rng(1).integers(
        0, cfg32.vocab_size, (B, S)).astype(np.int32)
    n_tf = S if depth == FAMILY_RANK_NCCL_DEPTH else FAMILY_RANK_TF
    states = model.init_decode_states(params, cfg32, B, ctx,
                                      kv_dtype=torch.float32)
    tok, bt_d = torch.from_numpy(tokens).to(dev), torch.from_numpy(bt).to(dev)

    def forced():
        nonlocal states
        got = []
        for i in range(n_tf):
            pos = torch.full((B,), i, dtype=torch.int32, device=dev)
            _, lg, states = step(params, states, tok[:, i:i + 1], pos, bt_d)
            got.append(lg[:, 0].cpu())
        return torch.stack(got)
    got, tf_s = host_s(forced)
    tf = dict(got=got.numpy(), seconds=tf_s,
              launches=read_launches(k)["probe_perf"])
    del states
    if depth == FAMILY_RANK_NCCL_DEPTH:
        # the forward over the ranks (the training forward without
        # autograd, so its MoE layers are expert-stationary too)
        ctx_f = sharding.ShardCtx(mesh).bind(B, S)
        with torch.no_grad():
            batch = ctx_f.local_batch({"tokens": torch.from_numpy(tokens)})
            (x, aux), fwd_s = host_s(lambda: model.forward(
                params, cfg32, batch, shard_ctx=ctx_f))
            head = params.embed if cfg32.tie_embeddings else params.head
            full = tp.gather_vocab(model.logits_fn(
                params, cfg32, ctx_f.gather_seq(x)), head, mesh)
        tf.update(full=full.transpose(0, 1).cpu().numpy(), fwd_s=fwd_s,
                  dropped=float(aux["moe_dropped"]))
        del x, full
    torch.cuda.empty_cache()

    cfg = family_rank_config(depth, "bfloat16")
    drawn = model.init_params_sharded
    model.init_params_sharded = lambda *a, **kw: params     # the same draw
    reset_launches(k)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        with DecodeTimer() as timer, StepCollectives(mesh) as coll:
            done, smgr, n_steps = serve.serve(cfg, mesh=mesh, seed=0,
                                              verbose=False, **HYBRID_SERVE)
            sync()
            wall = time.perf_counter() - timer.t_first
    finally:
        model.init_params_sharded = drawn
    return dict(init_s=init_s, draw_s=draw_s, n_local=n_local, tf=tf,
                outs={r["id"]: r["out"] for r in done}, steps=n_steps,
                step_ms=timer.step_ms, wall=wall, table_ms=timer.table_ms,
                collectives=coll.counts, largest_gather=coll.largest_gather(),
                experts=expert_block_bytes(params),
                launches=read_launches(k)["probe_perf"],
                peak=torch.cuda.max_memory_allocated(dev) / 2**30,
                live=smgr.live_pages(), table=table_digests(hashmap, smgr.hm))


def family_rank_main(world, refs, parts, depth):
    """Phase 17 on one rank: (a) and (b), or (c) alone (``parts``)."""
    from repro_torch.launch.mesh import make_model_mesh
    t_enter = time.time()
    k = rank_kernels()
    meshes = {n: make_model_mesh(world, s) for n, s in DECODE_MESHES.items()}
    out = dict(device=str(world.device), backend=world.backend,
               coords={n: m.coords for n, m in meshes.items()})
    if "small" in parts:
        reset_launches(k)
        t0 = time.perf_counter()
        out["small"] = rank_family_small(meshes, refs)
        out["small_launches"] = read_launches(k)["probe_perf"]
        out["small_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["train"] = rank_small_train(meshes, FAMILY_RANK_TRAIN)
        out["train_s"] = time.perf_counter() - t0
    if "paper" in parts:
        t0 = time.perf_counter()
        out["paper"] = rank_jamba_decode(meshes[FAMILY_RANK_MESH], k, depth,
                                         serial=world.backend == "gloo")
        out["paper_s"] = time.perf_counter() - t0
    out["span"] = (t_enter, time.time())
    return out


def check_small_family_ranks(refs, outs, cases=FAMILY_RANK_CASES,
                             served=FAMILY_RANK_SERVED):
    """(a): every rank's logits rows and greedy tokens against the one-card
    run, the MoE cases' steps moving no expert block, and the served
    case's outputs and steps.  Returns (cases, worst |logit| difference,
    largest all-gather over the smallest expert layer's blocks); each
    case's worst difference is printed first."""
    worst = worst_share = 0.0
    errs = {name: max(float(np.abs(
        o["small"][name]["logits"] - refs[name]["logits"][
            :, slice(*o["small"][name]["rows"])]).max()) for o in outs)
        for name, *_ in cases}
    print("family ranks: worst |logit| difference by case: "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    for name, arch, mname, _ in cases:
        ref = refs[name]
        for r, o in enumerate(outs):
            got = o["small"][name]
            a, b = got["rows"]
            err = float(np.abs(got["logits"] - ref["logits"][:, a:b]).max())
            worst = max(worst, err)
            check(err <= FAMILY_RANK_TOL, f"family ranks {name}: rank {r}'s "
                  f"logits {err} from the one-card run's")
            check(np.array_equal(got["next"], ref["next"]),
                  f"family ranks {name}: rank {r}'s greedy tokens differ "
                  f"from one card's")
            if got["experts"]:
                share = got["largest_gather"] / got["experts"]
                worst_share = max(worst_share, share)
                check(share < 1, f"family ranks {name}: rank {r} gathered "
                      f"{got['largest_gather']} bytes at once, as much as "
                      f"a MoE layer's expert blocks ({got['experts']})")
            if name == served:
                check(got["outs"] == ref["outs"]
                      and got["steps"] == ref["steps"],
                      f"family ranks {name}: rank {r}'s served tokens or "
                      f"steps differ from one card's")
    return len(cases), worst, worst_share


def check_jamba_ranks(outs, label, smi, depth, cards):
    """(b)/(c): the float32 logits (against phase 12's one-card logits, or
    the forward over the ranks), the served run (finite, every request
    whole, the same on every rank, drained, no expert block gathered) and
    its figures.  Returns the ranks' ``probe_perf`` launches."""
    from repro_torch.models import transformer
    papers = [o["paper"] for o in outs]
    kw = HYBRID_SERVE
    cfg = family_rank_config(depth, "bfloat16")
    for r, p in enumerate(papers):
        got = p["tf"]["got"]
        check(bool(np.isfinite(got).all()), f"{label}: rank {r}'s logits "
              f"are not finite")
        if depth == FAMILY_RANK_NCCL_DEPTH:
            want = p["tf"]["full"]
            ok = np.isclose(got, want, rtol=DECODE_TOL, atol=DECODE_TOL)
            check(bool(ok.all()) and p["tf"]["dropped"] == 0.0,
                  f"{label}: rank {r}'s decode differs from the forward over "
                  f"the ranks at {int((~ok).sum())} logits, max |diff| "
                  f"{float(np.abs(got - want).max())} (forward drops "
                  f"{p['tf']['dropped']})")
        else:
            want = np.load(FAMILY_RANK_DATA / "tf_logits.npy")
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            p["tf"]["rel"] = rel
            check(rel <= FAMILY_RANK_TOL, f"{label}: rank {r}'s float32 "
                  f"logits differ from phase 12's one-card logits by {rel} "
                  f"of the largest")
        p["tf"]["err"] = float(np.abs(got - want).max())
        p["tf"]["largest"] = float(np.abs(want).max())
        check(p["outs"] == papers[0]["outs"] and p["table"] ==
              papers[0]["table"] and p["live"] == 0,
              f"{label}: rank {r}'s tokens or page table differ from rank "
              f"0's, or pages stay live")
        check(p["launches"] > 0 and p["tf"]["launches"] > 0,
              f"{label}: rank {r} launched no probe_perf")
        check(p["largest_gather"] < p["experts"], f"{label}: rank {r} "
              f"gathered {p['largest_gather']} bytes at once, as much as a "
              f"MoE layer's expert blocks ({p['experts']})")
    outs0 = papers[0]["outs"]
    check(sorted(outs0) == list(range(kw["requests"])) and all(
        len(v) == kw["max_new"] and all(0 <= t < cfg.padded_vocab for t in v)
        for v in outs0.values()), f"{label}: requests ended short")
    bound_ms, w_bytes, kv_bytes, ssm_bytes = decode_bound(cfg, kw)
    bound_ms /= cards               # each card reads its ranks' blocks
    st = np.asarray(papers[0]["step_ms"])
    med = float(np.median(st))
    steps = papers[0]["steps"]
    gen = kw["requests"] * kw["max_new"]
    wall = max(p["wall"] for p in papers)
    colls = [p["collectives"] for p in papers]
    kinds = [transformer.layer_kind(cfg, i) for i in range(depth)]
    tf = papers[0]["tf"]
    what = (f"the forward over the ranks (no autograd: its MoE layers "
            f"expert-stationary over all {HYBRID_TF[0] * HYBRID_TF[1]} "
            f"tokens, no drops), every position within {DECODE_TOL}: max "
            f"|diff|"
            if depth == FAMILY_RANK_NCCL_DEPTH else
            f"phase 12's one-card logits, within {FAMILY_RANK_TOL} of the "
            f"largest: worst {max(p['tf']['rel'] for p in papers):.3e}, "
            f"max |diff|")
    print(f"{label}_tf {HYBRID_ARCH}: {depth} of 32 layers at its published "
          f"widths ({kinds.count('mamba')} mamba, {kinds.count('attn')} "
          f"attention, {sum(cfg.is_moe_layer(i) for i in range(depth))} MoE "
          f"of {cfg.num_experts} experts top-{cfg.top_k}) over {len(outs)} "
          f"ranks on {FAMILY_RANK_MESH} ({outs[0]['backend']}, {cards} "
          f"card(s)); {papers[0]['n_local']} params a rank (float32), drawn "
          f"in {max(p['draw_s'] for p in papers):.3f} s; {len(tf['got'])} "
          f"teacher-forced steps x {HYBRID_TF[0]} sequences in float32 "
          f"(capacity_factor = E) in {tf['seconds']:.3f} s, every rank's "
          f"logits against {what} "
          f"{max(p['tf']['err'] for p in papers):.3e} (largest |logit| "
          f"{tf['largest']:.3f})"
          + (f"; forward {tf['fwd_s']:.3f} s" if 'fwd_s' in tf else ""))
    print(f"{label}_serve {HYBRID_ARCH} ({depth} layers; params float32, "
          f"activations bfloat16, KV float32) over {len(outs)} ranks: "
          f"{kw['requests']} requests of prompt {kw['prompt_len']} + "
          f"{kw['max_new']} new at batch {kw['batch']}, horizon "
          f"{kw['horizon']}; {steps} steps, {gen} tokens in {wall:.3f} s = "
          f"{gen / wall:.1f} tokens/s; step ms median {med:.3f} (min "
          f"{st.min():.3f}, max {st.max():.3f}) against a bound of "
          f"{bound_ms:.3f} ms (weights {w_bytes / 1e9:.3f} GB + KV "
          f"{kv_bytes / 1e9:.3f} GB + SSM states {ssm_bytes / 1e9:.3f} GB "
          f"over {cards} card(s) at {HBM_RATE / 1e12:.2f} TB/s each; "
          f"{bound_ms / med * 100:.2f}% of bound); collectives a step "
          f"{colls[0]['calls'] / steps:.1f}, "
          f"{colls[0]['bytes'] / steps / 1e6:.3f} MB sent by rank 0, host ms "
          f"in them a step by rank "
          f"{[round(c['seconds'] / steps * 1e3, 3) for c in colls]} "
          f"({colls[0]['seconds'] / papers[0]['wall'] * 100:.1f}% of rank "
          f"0's serve; by kind a step on rank 0: "
          f"{kinds_line(colls[0]['by_kind'], steps)}); largest all-gather "
          f"{max(p['largest_gather'] for p in papers)} bytes, an expert "
          f"layer's blocks {papers[0]['experts'] / 1e9:.3f} GB a rank; "
          f"page-table host ms a step {papers[0]['table_ms'] / steps:.3f}; "
          f"probe_perf launches by rank "
          f"{[p['tf']['launches'] + p['launches'] for p in papers]}; peak a "
          f"rank {max(p['peak'] for p in papers):.2f} GiB; card: {smi}")
    return sum(p["tf"]["launches"] + p["launches"] for p in papers)


def family_ranks_nccl(smi):
    """(c): jamba at all 32 layers over NCCL, a card a rank (four cards).
    Returns the ranks' ``probe_perf`` launches."""
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.perf_counter()
    nccl = spawn_ranks(family_rank_main, RANKS, {}, ("paper",),
                       FAMILY_RANK_NCCL_DEPTH, backend="nccl", device=None,
                       timeout=RANK_TIMEOUT)
    check([o["device"] for o in nccl] == [f"cuda:{r}" for r in range(RANKS)],
          "nccl: a card a rank")
    launches = check_jamba_ranks(nccl, "family_ranks_nccl", smi,
                                 FAMILY_RANK_NCCL_DEPTH, RANKS)
    print(f"family_ranks_nccl_time: {time.perf_counter() - t0:.3f} s, spawn "
          f"to the last rank's exit (in the ranks "
          f"{max(o['paper_s'] for o in nccl):.3f} s); card: {smi}")
    return launches


def family_ranks_path(smi):
    """Phase 17: the moe, hybrid and vlm families decoding over (data,
    model) meshes of ``RANKS`` rank processes (gloo, every rank on the one
    card, as phases 15 and 16) and jamba training there: (a) the small
    cases against one card, (b) jamba at its published widths and phase
    12's 8 layers on (1, 4) against phase 12, then served; (c) with four
    cards, jamba at all 32 layers over NCCL.  Returns the ranks'
    ``probe_perf`` launches."""
    import torch
    from repro_torch.launch.mesh import spawn_ranks
    t_phase = time.perf_counter()
    refs = small_family_rank_references()
    train_refs = small_train_rank_references(FAMILY_RANK_TRAIN)
    ref_s = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    t0, w0 = time.perf_counter(), time.time()
    outs = spawn_ranks(family_rank_main, RANKS, refs, ("small", "paper"),
                       HYBRID_DEPTH, backend="gloo", device="cuda:0",
                       timeout=RANK_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    start_s = max(o["span"][0] for o in outs) - w0
    n, worst, share = check_small_family_ranks(refs, outs)
    nt, worst_g, worst_p, _ = check_small_train_ranks(
        train_refs, outs, FAMILY_RANK_TRAIN, key="train")
    small_l = sum(o["small_launches"] for o in outs)
    print(f"family_ranks_small: {n} decode cases (olmoe-1b-7b on 2x2, "
          f"jamba-v0.1-52b's 4-layer unit on 1x4 and 2x2, internvl2-2b on "
          f"1x4; smoke widths, float32) over {RANKS} ranks (gloo, all on "
          f"cuda:0) equal one card: {DECODE_RANK_SMALL[1]} teacher-forced "
          f"steps' logits within {worst:.3e} (bound {FAMILY_RANK_TOL}), "
          f"greedy tokens equal, the experts stationary (the largest "
          f"all-gather {share * 100:.1f}% of a MoE layer's expert blocks); "
          f"{FAMILY_RANK_SERVED} served as one card (tokens, steps); "
          f"{nt} training case (jamba ep on 2x2, seq_shard, capacity_factor "
          f"= E) equal one card: every gradient block within {worst_g:.3e} "
          f"of its leaf's largest, parameters within {worst_p:.3e} where "
          f"|g| >= 1e-6, moe_dropped equal; probe_perf launches over the "
          f"ranks {small_l}; one-card references {ref_s:.3f} s, ranks "
          f"{max(o['small_s'] for o in outs):.3f} s decode + "
          f"{max(o['train_s'] for o in outs):.3f} s training")
    launches = small_l + check_jamba_ranks(outs, "family_ranks", smi,
                                           HYBRID_DEPTH, 1)
    lines = [f"gloo {spawn_s:.3f} s (the ranks started {start_s:.3f} s "
             f"after the spawn)"]
    if torch.cuda.device_count() >= RANKS:
        t0 = time.perf_counter()
        launches += family_ranks_nccl(smi)
        lines.append(f"nccl {time.perf_counter() - t0:.3f} s")
    print(f"family_ranks_time: phase 17 took "
          f"{time.perf_counter() - t_phase:.3f} s (one-card references "
          f"{ref_s:.3f} s; {', '.join(lines)}; in the ranks (a) "
          f"{max(o['small_s'] + o['train_s'] for o in outs):.3f} s, (b) "
          f"{max(o['paper_s'] for o in outs):.3f} s, of which the serialised "
          f"draw {max(o['paper']['draw_s'] for o in outs):.3f} s); card: "
          f"{smi}")
    return launches


# ---------------------------------------------------------------------------
# 18. the ssm and encdec families decoding and training over a (data,
#     model) mesh of ranks
# ---------------------------------------------------------------------------

XLSTM_RANK_DATA = ROOT / "build" / "xlstm_ranks"
# (a) at smoke widths in float32 (``small_config``: 2 layers, xlstm's an
# sLSTM and an mLSTM, whisper's 2 + 2), phase 15's 8 teacher-forced steps
# on 2-token pages against one card from the same draw: logits within
# FAMILY_RANK_TOL (absolute), greedy tokens equal; whisper from seeded
# stub frames
SSM_RANK_CASES = (
    ("xlstm-1.3b@1x4", "xlstm-1.3b", "1x4", {}),
    ("xlstm-1.3b@2x2", "xlstm-1.3b", "2x2", {}),
    ("whisper-tiny@2x2", "whisper-tiny", "2x2", {}),
    # 6 heads, as published: 6 % 4 != 0, so the rules replicate the heads
    # of every attention leaf over "model"
    ("whisper-tiny-h6@1x4", "whisper-tiny", "1x4",
     {"num_heads": 6, "num_kv_heads": 6}))
SSM_RANK_SERVED = "xlstm-1.3b@1x4"
SSM_RANK_FRAMES = 24             # whisper smoke stub frames
SSM_RANK_TRAIN = [
    ("xlstm-1.3b@2x2", "xlstm-1.3b", "2x2", {}, True, "none", 1),
    ("whisper-tiny-h6@1x4", "whisper-tiny", "1x4",
     {"num_heads": 6, "num_kv_heads": 6}, True, "none", 1)]
# xLSTM's exponential gates amplify float32 rounding (ROADMAP Queue 3): JAX
# against itself on (2, 2) against (1, 1) moves the smoke sLSTM's ``up1``
# gradient by 1.07e-5 of its largest; xlstm keeps its one-device bound
# (tests/test_torch_train.py)
SSM_RANK_GRAD_TOL = {"xlstm-1.3b": 1e-4}
# (b) xlstm-1.3b at its published widths and depth on (1, 4), one head a
# rank, phase 13(b)'s first 16 teacher-forced steps.  The ranks' decode
# drifts from one card's with depth (the same float32 sums in another
# order, grown by the exponential gates: at smoke widths 7.7e-7 of the
# largest logit at 2 layers, 6.8e-5 at 8, 9.7e-4 at 16, gloo on the CPU),
# so each layer's decode, fed the one-card layer's input, is held within
# 1e-5 of the norm of that layer's own output (1.1e-6 at 16 smoke
# layers), and the end-to-end difference is printed.  At full width a few
# (layer, step) points are ill-conditioned in float32: a one-ulp move of
# the input moves one card's own output by up to 1.13e-4 of its norm
# (``layer_sensitivity``; layer 39's mLSTM at step 0, where the ranks
# differ by 1.36e-4; NVIDIA H100 80GB HBM3, PR 25 chip run 2).  A rank's
# reordered sums round a few ulps apart, so a point is held within
# XLSTM_RANK_SENS times its one-card sensitivity where that exceeds 1e-5
XLSTM_RANK_TF = 16
XLSTM_RANK_MESH = "1x4"
XLSTM_RANK_TOL = 1e-5
XLSTM_RANK_SENS = 4.0
# cut for time (phase 18 took 88.7 s of its 80, PR 25 chip run 4; ≈ 0.5 s
# a step, 98 gloo collectives): the printed end-to-end run to the first 8
# of the 16 steps; phase 15's serve (cut to 8 new tokens a request)
XLSTM_RANK_E2E = 8
XLSTM_RANK_SERVE = DECODE_RANK_SERVE
# (c) whisper-tiny at its published widths and depth: phase 13(c)'s 1500
# stub frames and decoder tokens, 8 teacher-forced steps on (1, 4) (heads
# replicated) and (2, 2) (3 heads a rank); one training step in float32 at
# phase 13(c)'s shape on (2, 2) with seq_shard
WHISPER_RANK_TF = 8
WHISPER_RANK_TRAIN = dict(WHISPER_TRAIN, steps=1, mesh="2x2")
# (d) xlstm-1.3b trained at its published widths, 8 of 48 layers (one
# unit: 1 sLSTM, 7 mLSTM), one float32 step at 4 x 256 on (2, 2) with
# seq_shard; the collectives of its loss and gradient counted again at
# 4 x 64
XLSTM_RANK_TRAIN = dict(depth=8, seq=256, batch=4, mesh="2x2")
# (d)'s one-card gradients, every leaf whole, which each rank holds its
# blocks against, leaf by leaf.  The step run in float64 (``float64_mode``:
# every float32 tensor of it made float64) within SSM_RANK_GRAD_TOL of the
# leaf's largest: there the ranks' sums in another order round 2^29 times
# finer than in float32 (the worst leaf 8.9e-12; NVIDIA H100 80GB HBM3),
# while a wrong term (a shard boundary, a missing block) would stay as
# large.  The float32 step within XLSTM_RANK_SENS times the leaf's own
# conditioning, where that exceeds SSM_RANK_GRAD_TOL: the most a one-ulp
# move of every parameter (``one_ulp``, over XLSTM_RANK_ULP_DRAWS seeded
# draws) moves that leaf of one card's gradient (5.5e-5 to 1.4e-2 of a
# leaf's largest; the ranks' leaves at most 1.26 times it)
XLSTM_RANK_GRADS = XLSTM_RANK_DATA / "xtrain_grads.pt"
XLSTM_RANK_GRADS64 = XLSTM_RANK_DATA / "xtrain_grads64.pt"
XLSTM_RANK_ULP_DRAWS = 3


class LayerTape:
    """``transformer._apply_layer_decode`` wrapped for the length of a
    ``with`` block: every layer's input and output (B, d) of the first
    ``steps`` decode steps copied into device buffers, call by call (no
    synchronise)."""

    def __init__(self, layers, steps):
        self.layers, self.steps, self.calls = layers, steps, 0
        self.x = self.y = None

    def __enter__(self):
        from repro_torch.models import transformer
        self._orig = orig = transformer._apply_layer_decode
        tape = self

        def apply(p, cfg, x, *a):
            y, st = orig(p, cfg, x, *a)
            t, layer = divmod(tape.calls, tape.layers)
            tape.calls += 1
            if t < tape.steps:
                if tape.x is None:
                    shape = (tape.layers, tape.steps) + tuple(x[:, 0].shape)
                    tape.x, tape.y = x.new_empty(shape), x.new_empty(shape)
                tape.x[layer, t].copy_(x[:, 0])
                tape.y[layer, t].copy_(y[:, 0])
            return y, st
        transformer._apply_layer_decode = apply
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer
        transformer._apply_layer_decode = self._orig


def layer_sensitivity(layers, cfg, tape, bt, ctx):
    """(layers, steps): how far each layer's one-card decode moves, over
    the norm of the layer's own output, when every element of its taped
    input moves by one float32 ulp (a seeded random sign an element), its
    states carried from the moved inputs as the ranks' are from theirs:
    the float32 conditioning of that layer at that step."""
    import torch
    from repro_torch.models import transformer
    g = torch.Generator(device="cuda").manual_seed(0)
    B = tape.x.shape[2]
    states = transformer.init_decode_states(cfg, B, ctx, torch.float32,
                                            device="cuda")
    resp = torch.zeros(tape.x.shape[:2], dtype=torch.float32, device="cuda")
    for t in range(tape.steps):
        pos = torch.full((B,), t, dtype=torch.int32, device="cuda")
        for i, p in enumerate(layers):
            x = tape.x[i, t]
            sign = torch.randint(0, 2, x.shape, generator=g,
                                 device="cuda") * 2 - 1
            y, states[i] = transformer._apply_layer_decode(
                p, cfg, (x * (1 + sign * 2.0 ** -23))[:, None], states[i],
                bt, pos, ctx)
            resp[i, t] = (y[:, 0] - tape.y[i, t]).norm() / \
                (tape.y[i, t] - x).norm()
    return resp.cpu().numpy()


def save_xlstm_rank_reference(tokens, dec, tape, resp):
    """Phase 13(b)'s one-card decode for phase 18(b): the tokens, the
    first ``XLSTM_RANK_TF`` steps' float32 logits, every layer's input and
    output in them and its sensitivity (``layer_sensitivity``)."""
    check(tape.calls == tape.layers * tokens.shape[1],
          f"the tape saw {tape.calls} layer calls")
    XLSTM_RANK_DATA.mkdir(parents=True, exist_ok=True)
    np.savez(XLSTM_RANK_DATA / "reference.npz", tokens=tokens,
             logits=dec[:XLSTM_RANK_TF].cpu().numpy(),
             layer_in=tape.x.cpu().numpy(), layer_out=tape.y.cpu().numpy(),
             sensitivity=resp)


def whisper_rank_references(smi):
    """(c) on one card, float32, TF32 off, from ``init_params(cfg, 0)``:
    the teacher-forced logits of ``WHISPER_RANK_TF`` steps over phase
    13(c)'s stub frames and every layer's cross ``ek``/``ev``; then one
    training step at ``WHISPER_RANK_TRAIN``'s shape (its loss, grad norm
    and ms)."""
    import torch
    from repro_torch import configs
    from repro_torch.distributed import steps
    from repro_torch.models import model
    cfg = configs.get_config(WHISPER_ARCH).replace(dtype="float32")
    B, S, pt, n_frames = WHISPER_TF
    params = model.init_params(cfg, 0, "cuda")
    ctx = decode_ctx(model, configs, cfg, B, S, pt)
    bt = np.arange(B * ctx.n_pages, dtype=np.int32).reshape(B, -1)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, n_frames, cfg.d_model)).astype(
        np.float32)
    with torch.no_grad():
        lg, states = teacher_forced(model, params, cfg,
                                    tokens[:, :WHISPER_RANK_TF], bt, ctx,
                                    torch.from_numpy(frames).cuda())
    out = dict(tokens=tokens, frames=frames, logits=lg.cpu().numpy(),
               next=torch.argmax(lg, -1).cpu().numpy(),
               ek=np.stack([st["ek"].cpu().numpy() for st in states]),
               ev=np.stack([st["ev"].cpu().numpy() for st in states]))
    del states, lg
    oc = configs.OptimConfig(lr=3e-4, warmup_steps=1, total_steps=1)
    step = steps.build_train_step(cfg, oc)
    batch = whisper_rank_batch(cfg, "cuda")
    opt = steps.init_opt_state(params, oc)
    torch.cuda.reset_peak_memory_stats()
    (_, _, m), step_s = host_s(lambda: step(params, opt, batch))
    out["train"] = dict(metrics={k: float(v) for k, v in m.items()},
                        ms=step_s * 1e3,
                        peak=torch.cuda.max_memory_allocated() / 2**30)
    del params, opt, batch
    torch.cuda.empty_cache()
    return out


def whisper_rank_batch(cfg, device):
    """(c)'s training batch: phase 13(c)'s shape, step 0."""
    import torch
    from repro_torch import configs
    from repro_torch.data import SyntheticLMData
    f = WHISPER_RANK_TRAIN
    data = SyntheticLMData(cfg, configs.ShapeConfig(
        "train_4k_cut", f["seq"], f["batch"], "train"))
    return {k: torch.from_numpy(v).to(device)
            for k, v in data.batch_at(0).items()}


def xlstm_rank_train_config():
    from repro_torch import configs
    return configs.get_config(XLSTM_ARCH).replace(
        num_layers=XLSTM_RANK_TRAIN["depth"], dtype="float32")


def xlstm_rank_batch(cfg, seq, device):
    """(d)'s training batch of ``seq`` tokens, step 0."""
    import torch
    from repro_torch import configs
    from repro_torch.data import SyntheticLMData
    data = SyntheticLMData(cfg, configs.ShapeConfig(
        "t", seq, XLSTM_RANK_TRAIN["batch"], "train"))
    return {k: torch.from_numpy(v).to(device)
            for k, v in data.batch_at(0).items()}


def xlstm_train_reference():
    """(d) on one card: the cut's loss and grad norm of one float32 step
    from ``init_params(cfg, 0)``, TF32 off, and its ms; its gradient,
    every leaf whole, saved to ``XLSTM_RANK_GRADS`` for the ranks; each
    leaf's one-ulp sensitivity (the most over ``XLSTM_RANK_ULP_DRAWS``
    draws); and the loss and gradient of the same step in float64
    (``float64_mode``), saved to ``XLSTM_RANK_GRADS64``."""
    import torch
    from repro_torch import configs
    from repro_torch.distributed import steps
    from repro_torch.models import model
    cfg = xlstm_rank_train_config()
    oc = configs.OptimConfig(lr=3e-4, warmup_steps=1, total_steps=1)
    step = steps.build_train_step(cfg, oc)
    batch = xlstm_rank_batch(cfg, XLSTM_RANK_TRAIN["seq"], "cuda")
    moved_g = []
    for seed in range(XLSTM_RANK_ULP_DRAWS):
        moved = model.init_params(cfg, 0, "cuda")
        one_ulp(moved, seed)
        moved_g.append(step.loss_and_grads(moved, batch)[2])
        del moved
    params = model.init_params(cfg, 0, "cuda")
    opt = steps.init_opt_state(params, oc)
    grads = None

    def one_step():
        nonlocal grads
        loss, metrics, grads = step.loss_and_grads(params, batch)
        _, _, stats = step.apply_grads(params, opt, grads)
        return {"loss": loss, **metrics, **stats}
    m, step_s = host_s(one_step)
    sens = {k: max(float((mg[k] - g).abs().max()) for mg in moved_g)
            / max(float(g.abs().max()), 1e-30) for k, g in grads.items()}
    XLSTM_RANK_DATA.mkdir(parents=True, exist_ok=True)
    torch.save({k: g.cpu() for k, g in grads.items()}, XLSTM_RANK_GRADS)
    del params, opt, grads, moved_g
    with float64_mode():
        step64 = steps.build_train_step(cfg, oc)
        loss64, _, g64 = step64.loss_and_grads(
            model.init_params(cfg, 0, "cuda"), batch)
    check(all(g.dtype == torch.float64 for g in g64.values()),
          "xlstm ranks training: float64_mode left a gradient leaf in "
          "another type")
    torch.save({k: g.cpu() for k, g in g64.items()}, XLSTM_RANK_GRADS64)
    del batch, g64
    torch.cuda.empty_cache()
    return dict(metrics={k: float(v) for k, v in m.items()},
                ms=step_s * 1e3, sens=sens, loss64=float(loss64))


def one_ulp(params, seed: int):
    """Move every parameter element by one float32 ulp, up or down by a
    random sign drawn from ``seed``: a gradient taken there against the
    one taken at the draw is the float32 conditioning of the step's
    gradient."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for p in params.parameters():
            up = torch.randint(0, 2, p.shape, generator=g, device="cuda")
            p.copy_(torch.nextafter(p, torch.where(
                up.bool(), float("inf"), float("-inf")).to(p.dtype)))


def float64_mode():
    """A context in which every op that would make a float32 tensor makes
    it float64, and the default type is float64: a float32 step run in
    float64, its backward and its remat recompute included (a dispatch
    mode, which the autograd engine keeps in its threads)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Float64(TorchDispatchMode):
        def __enter__(self):
            self.default = torch.get_default_dtype()
            torch.set_default_dtype(torch.float64)
            return super().__enter__()

        def __exit__(self, *exc):
            torch.set_default_dtype(self.default)
            return super().__exit__(*exc)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if kwargs.get("dtype") is torch.float32:
                kwargs = dict(kwargs, dtype=torch.float64)
            return func(*args, **kwargs)
    return Float64()


def grad_errors(grads, params, mesh, path) -> dict:
    """{leaf: the largest |difference| of this rank's gradient block from
    its block of the one-card gradient saved at ``path``, over that
    leaf's largest |g|}."""
    import torch
    from repro_torch.distributed import sharding
    want = torch.load(path, mmap=True)
    specs = {k: p.spec for k, p in params.named_parameters()}
    out = {}
    for k, g in grads.items():
        w = want[k]
        blk = sharding.local_block(w, specs[k], mesh).to(g.device)
        scale = max(float(w.abs().max()), 1e-30)
        out[k] = float((g - blk).abs().max()) / scale
    return out


def rank_xlstm_decode(mesh, k):
    """(b) on one rank: xlstm-1.3b at its published widths and depth, the
    rank's block drawn by ``init_params_sharded``; ``XLSTM_RANK_E2E``
    float32 teacher-forced steps of phase 13(b)'s tokens through the serve
    step (the logits rows) and, from fresh states, each layer's decode fed
    phase 13(b)'s input of that layer at each of ``XLSTM_RANK_TF`` steps
    (its error over the norm of the one-card layer's own output); then ``XLSTM_RANK_SERVE`` in bfloat16
    from the same draw, timed (``DecodeTimer``), its collectives by kind,
    launches and peak."""
    import torch
    from repro_torch import configs
    from repro_torch.core import hashmap
    from repro_torch.core.paged_kv import PageTableManager
    from repro_torch.distributed import steps
    from repro_torch.launch import serve
    from repro_torch.models import model, transformer
    dev = mesh.device
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are on: float32 decode would not be float32")
    cfg32 = configs.get_config(XLSTM_ARCH).replace(dtype="float32")
    B, S, pt = XLSTM_TF
    T = XLSTM_RANK_TF
    with np.load(XLSTM_RANK_DATA / "reference.npz") as z:
        ref = {n: z[n] for n in ("tokens", "layer_in", "layer_out")}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(k)
    params, draw_s = host_s(lambda: model.init_params_sharded(cfg32, 0,
                                                              mesh))
    n_local = sum(p.numel() for p in params.parameters())
    scfg = configs.ServeConfig(model=cfg32, shape=configs.ShapeConfig(
        "t", S, B, "decode"), kv_page_tokens=pt)
    step, ctx = steps.build_serve_step(cfg32, scfg, mesh=mesh)
    check(not ctx.batch_axes, "(b) expects every rank on every row")
    mgr = PageTableManager(ctx.pool_pages,
                           num_channels=mesh.size(ctx.channel_axes),
                           backend="perf", device=dev)
    mgr.alloc_seqs([(b, ctx.n_pages, 0) for b in range(B)])
    bt_d = torch.from_numpy(mgr.block_table(list(range(B)),
                                            ctx.n_pages)).to(dev)
    tok = torch.from_numpy(ref["tokens"]).to(dev)

    def positions(i):
        return torch.full((B,), i, dtype=torch.int32, device=dev)

    def end_to_end():
        states = model.init_decode_states(params, cfg32, B, ctx,
                                          kv_dtype=torch.float32)
        got = []
        for i in range(XLSTM_RANK_E2E):
            _, lg, states = step(params, states, tok[:, i:i + 1],
                                 positions(i), bt_d)
            got.append(lg[:, 0].cpu())
        return torch.stack(got)
    with StepCollectives(mesh) as coll_tf:
        got, tf_s = host_s(end_to_end)

    layers = [p for unit in params.units for p in unit.values()]
    x_in = torch.from_numpy(ref["layer_in"]).to(dev)
    y_one = torch.from_numpy(ref["layer_out"]).to(dev)
    errs = torch.zeros((len(layers), T), dtype=torch.float32, device=dev)

    def layer_by_layer():
        states = model.init_decode_states(params, cfg32, B, ctx,
                                          kv_dtype=torch.float32)
        with torch.no_grad():
            for t in range(T):
                for i, p in enumerate(layers):
                    y, states[i] = transformer._apply_layer_decode(
                        p, cfg32, x_in[i, t][:, None], states[i], bt_d,
                        positions(t), ctx)
                    errs[i, t] = (y[:, 0] - y_one[i, t]).norm() / \
                        (y_one[i, t] - x_in[i, t]).norm()
    _, layer_s = host_s(layer_by_layer)
    tf = dict(got=got.numpy(), seconds=tf_s, layer_s=layer_s,
              layer_err=errs.cpu().numpy(), coll=coll_tf.counts,
              launches=read_launches(k)["probe_perf"])
    del x_in, y_one
    torch.cuda.empty_cache()

    cfg = configs.get_config(XLSTM_ARCH)
    drawn = model.init_params_sharded
    model.init_params_sharded = lambda *a, **kw: params     # the same draw
    reset_launches(k)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        with DecodeTimer() as timer, StepCollectives(mesh) as coll:
            done, smgr, n_steps = serve.serve(cfg, mesh=mesh, seed=0,
                                              verbose=False,
                                              **XLSTM_RANK_SERVE)
            sync()
            wall = time.perf_counter() - timer.t_first
    finally:
        model.init_params_sharded = drawn
    return dict(draw_s=draw_s, n_local=n_local, tf=tf,
                outs={r["id"]: r["out"] for r in done}, steps=n_steps,
                step_ms=timer.step_ms, wall=wall, table_ms=timer.table_ms,
                collectives=coll.counts,
                launches=read_launches(k)["probe_perf"],
                peak=torch.cuda.max_memory_allocated(dev) / 2**30,
                live=smgr.live_pages(), table=table_digests(hashmap, smgr.hm))


def rank_whisper(meshes, ref):
    """(c) on one rank: whisper-tiny at its published widths, the rank's
    block drawn by ``init_params_sharded``, on both meshes: the cross
    ``ek``/``ev`` of its rows of the stub frames (encoded over the ranks)
    against its block of one card's, ``WHISPER_RANK_TF`` float32
    teacher-forced steps through the serve step (logits rows, greedy
    tokens); then one training step on ``WHISPER_RANK_TRAIN``'s mesh from
    the whole batch."""
    import torch
    from repro_torch import configs
    from repro_torch.core.paged_kv import PageTableManager
    from repro_torch.distributed import sharding, steps
    from repro_torch.models import model
    cfg = configs.get_config(WHISPER_ARCH).replace(dtype="float32")
    B, S, pt, _ = WHISPER_TF
    out = {}
    for mname, mesh in meshes.items():
        dev = mesh.device
        params = model.init_params_sharded(cfg, 0, mesh)
        scfg = configs.ServeConfig(model=cfg, shape=configs.ShapeConfig(
            "t", S, B, "decode"), kv_page_tokens=pt)
        step, ctx = steps.build_serve_step(cfg, scfg, mesh=mesh)
        groups = mesh.size(ctx.batch_axes)
        mgr = PageTableManager(ctx.pool_pages,
                               num_channels=mesh.size(ctx.channel_axes),
                               num_groups=groups, backend="perf", device=dev)
        phys = mgr.alloc_seqs([(b, ctx.n_pages, b // (B // groups))
                               for b in range(B)])
        bt = np.stack([phys[b] for b in range(B)])
        rows = ctx.local_batch(B)
        n = rows.stop - rows.start
        states, enc_s = host_s(lambda: model.init_decode_states(
            params, cfg, n, ctx, kv_dtype=torch.float32,
            enc_frames=torch.from_numpy(ref["frames"][rows])))
        kv_err = 0.0
        for layer, st in enumerate(states):
            for key in ("ek", "ev"):
                whole = torch.from_numpy(ref[key][layer])
                spec = sharding.spec_for(
                    mesh, steps._STATE_AXES[(key, whole.dim())], whole.shape)
                want = sharding.local_block(whole, spec, mesh)
                check(tuple(st[key].shape) == tuple(want.shape),
                      f"whisper {mname}: rank {mesh.rank}'s {key} of layer "
                      f"{layer} is {tuple(st[key].shape)}, its block "
                      f"{tuple(want.shape)}")
                # relative to the largest |value| of the whole layer's K/V
                kv_err = max(kv_err, float((st[key].cpu() - want).abs()
                                           .max()) / float(whole.abs().max()))
        tok = torch.from_numpy(ref["tokens"][rows]).to(dev)
        bt_d = torch.from_numpy(bt[rows]).to(dev)
        lg, nts = [], []
        with StepCollectives(mesh) as coll:
            for i in range(WHISPER_RANK_TF):
                pos = torch.full((n,), i, dtype=torch.int32, device=dev)
                nt, logits, states = step(params, states, tok[:, i:i + 1],
                                          pos, bt_d)
                lg.append(logits[:, 0].cpu())
                nts.append(nt.cpu())
        out[mname] = dict(rows=(rows.start, rows.stop), kv_err=kv_err,
                          enc_s=enc_s, logits=torch.stack(lg).numpy(),
                          next=torch.stack(nts).numpy(),
                          heads=int(params.decoder[0].attn.wq.shape[1]),
                          coll=coll.counts)
        del params, states
    torch.cuda.empty_cache()
    mesh = meshes[WHISPER_RANK_TRAIN["mesh"]]
    oc = configs.OptimConfig(lr=3e-4, warmup_steps=1, total_steps=1)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    params, opt = steps.init_train_state(cfg, oc, mesh, 0)
    step = steps.build_train_step(cfg, oc, mesh, seq_shard=True)
    batch = whisper_rank_batch(cfg, "cpu")
    before = collective_counts(mesh)
    (params, opt, m), step_s = host_s(lambda: step(params, opt, batch))
    n = "final_norm.bias"
    out["train"] = dict(
        metrics={k: float(v) for k, v in m.items()}, ms=step_s * 1e3,
        coll=collectives_since(mesh, before),
        bias_zero=not bool(dict(params.named_parameters())[n].any()
                           or opt["m"][n].any() or opt["v"][n].any()),
        peak=torch.cuda.max_memory_allocated(mesh.device) / 2**30)
    del params, opt, batch
    torch.cuda.empty_cache()
    return out


def rank_xlstm_train(mesh):
    """(d) on one rank: one float32 step of ``XLSTM_RANK_TRAIN``'s cut from
    ``init_train_state`` (the one-card draw's blocks) through the train
    step on ``mesh`` with ``seq_shard``, timed, the sLSTM's host time
    metered, its collectives by kind and pass (its loss and gradient's
    apart); the loss and gradient of the same draw in float64
    (``float64_mode``); then the collectives of the loss and gradient at
    4 x 64, which equal the step's at 4 x 256 (the sLSTM's loop issues
    none, so they do not grow with the sequence)."""
    import torch
    from repro_torch import configs
    from repro_torch.distributed import steps
    from repro_torch.models import model
    cfg = xlstm_rank_train_config()
    f = XLSTM_RANK_TRAIN
    oc = configs.OptimConfig(lr=3e-4, warmup_steps=1, total_steps=1)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    params, opt = steps.init_train_state(cfg, oc, mesh, 0)
    step = steps.build_train_step(cfg, oc, mesh, seq_shard=True)
    batch = xlstm_rank_batch(cfg, f["seq"], "cpu")
    def calls(before):
        return {k: v["calls"] for k, v in collectives_since(
            mesh, before)["by_kind"].items()}

    def timed_step():
        # the step's halves, its loss and gradient counted apart
        nonlocal grad_calls, grads
        b0 = collective_counts(mesh)
        loss, metrics, grads = step.loss_and_grads(params, batch)
        grad_calls = calls(b0)
        p, o, stats = step.apply_grads(params, opt, grads)
        return p, o, {"loss": loss, **metrics, **stats}
    grad_calls = grads = None
    before = collective_counts(mesh)
    with SlstmMeter() as sm:
        (params, opt, m), step_s = host_s(timed_step)
    coll = collectives_since(mesh, before)
    grad_err = grad_errors(grads, params, mesh, XLSTM_RANK_GRADS)
    del grads
    peak = torch.cuda.max_memory_allocated(mesh.device) / 2**30
    with float64_mode():
        p64 = model.init_params_sharded(cfg, 0, mesh)
        loss64, _, g64 = steps.build_train_step(
            cfg, oc, mesh, seq_shard=True).loss_and_grads(p64, batch)
    check(all(g.dtype == torch.float64 for g in g64.values()),
          "xlstm ranks training: float64_mode left a gradient leaf in "
          "another type")
    grad_err64 = grad_errors(g64, p64, mesh, XLSTM_RANK_GRADS64)
    del p64, g64
    short = f["seq"] // 4
    before = collective_counts(mesh)
    step.loss_and_grads(params, xlstm_rank_batch(cfg, short, "cpu"))
    by_seq = {f["seq"]: grad_calls, short: calls(before)}
    out = dict(metrics={k: float(v) for k, v in m.items()}, ms=step_s * 1e3,
               coll=coll, by_seq=by_seq, grad_err=grad_err,
               loss64=float(loss64), grad_err64=grad_err64,
               slstm_s=sum(sm.fwd_s) + sum(sm.bwd_s),
               slstm_calls=(len(sm.fwd_s), len(sm.bwd_s)), peak=peak)
    del params, opt
    torch.cuda.empty_cache()
    return out


def ssm_rank_main(world, refs, whisper_ref):
    """Phase 18 on one rank: (a) to (d)."""
    from repro_torch.launch.mesh import make_model_mesh
    t_enter = time.time()
    k = rank_kernels()
    meshes = {n: make_model_mesh(world, s) for n, s in DECODE_MESHES.items()}
    out = dict(device=str(world.device), backend=world.backend,
               coords={n: m.coords for n, m in meshes.items()})
    reset_launches(k)
    t0 = time.perf_counter()
    out["small"] = rank_family_small(meshes, refs, SSM_RANK_CASES,
                                     SSM_RANK_SERVED)
    out["small_launches"] = read_launches(k)["probe_perf"]
    out["train"] = rank_small_train(meshes, SSM_RANK_TRAIN)
    out["small_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["paper"] = rank_xlstm_decode(meshes[XLSTM_RANK_MESH], k)
    out["paper_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["whisper"] = rank_whisper(meshes, whisper_ref)
    out["whisper_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["xtrain"] = rank_xlstm_train(meshes[XLSTM_RANK_TRAIN["mesh"]])
    out["xtrain_s"] = time.perf_counter() - t0
    out["span"] = (t_enter, time.time())
    return out


def check_xlstm_ranks(outs, smi):
    """(b): every layer's decode at every step within ``XLSTM_RANK_TOL``
    of its one-card output (normwise), or within ``XLSTM_RANK_SENS`` times
    the one-card sensitivity there where that is larger, the end-to-end
    logits against phase 13(b)'s
    (finite, printed), the served run (finite, every request whole, the
    same on every rank, drained) and its figures.  Returns the ranks'
    ``probe_perf`` launches."""
    from repro_torch import configs
    from repro_torch.models import transformer
    papers = [o["paper"] for o in outs]
    want = np.load(XLSTM_RANK_DATA / "reference.npz")["logits"][
        :XLSTM_RANK_E2E]
    kw = XLSTM_RANK_SERVE
    cfg = configs.get_config(XLSTM_ARCH)
    kinds = [transformer.layer_kind(cfg, i) for i in range(cfg.num_layers)]
    worst_layer = {}
    sens = np.load(XLSTM_RANK_DATA / "reference.npz")["sensitivity"]
    bound = np.maximum(XLSTM_RANK_TOL, XLSTM_RANK_SENS * sens)
    for r, p in enumerate(papers):
        got, errs = p["tf"]["got"], p["tf"]["layer_err"]
        check(bool(np.isfinite(got).all()) and bool(np.isfinite(errs).all()),
              f"xlstm ranks: rank {r}'s logits or layer errors not finite")
        i, t = np.unravel_index(np.argmax(errs / bound), errs.shape)
        check(float(errs[i, t]) <= float(bound[i, t]), f"xlstm ranks: rank "
              f"{r}'s layer {i} ({kinds[i]}) decode at step {t}, fed one "
              f"card's input, is {float(errs[i, t]):.3e} of the layer's "
              f"output norm from one card's, past its bound "
              f"{float(bound[i, t]):.3e} (one-card sensitivity "
              f"{float(sens[i, t]):.3e})")
        for kind in ("mlstm", "slstm"):
            rows = [j for j, kk in enumerate(kinds) if kk == kind]
            worst_layer[kind] = max(worst_layer.get(kind, 0.0),
                                    float(errs[rows].max()))
        p["tf"]["err"] = float(np.abs(got - want).max())
        check(p["outs"] == papers[0]["outs"] and p["table"] ==
              papers[0]["table"] and p["live"] == 0,
              f"xlstm ranks: rank {r}'s tokens or page table differ from "
              f"rank 0's, or pages stay live")
        check(p["launches"] > 0 and p["tf"]["launches"] > 0,
              f"xlstm ranks: rank {r} launched no probe_perf")
    outs0 = papers[0]["outs"]
    check(sorted(outs0) == list(range(kw["requests"])) and all(
        len(v) == kw["max_new"] and all(0 <= t < cfg.padded_vocab for t in v)
        for v in outs0.values()), "xlstm ranks: requests ended short")
    largest = float(np.abs(want).max())
    e2e = max(p["tf"]["err"] for p in papers)
    tf = papers[0]["tf"]
    print(f"xlstm_ranks_tf {XLSTM_ARCH}: {cfg.num_layers} layers at its "
          f"published widths ({kinds.count('slstm')} sLSTM + "
          f"{kinds.count('mlstm')} mLSTM, {cfg.num_heads} heads of "
          f"{cfg.head_dim}: one a rank) over {len(outs)} ranks on "
          f"{XLSTM_RANK_MESH} ({outs[0]['backend']}, 1 card); "
          f"{papers[0]['n_local']} params a rank (float32), drawn in "
          f"{max(p['draw_s'] for p in papers):.3f} s; end to end, "
          f"{XLSTM_RANK_E2E} teacher-forced steps x {XLSTM_TF[0]} sequences "
          f"in float32 through the serve step ({tf['seconds']:.3f} s, "
          f"{tf['coll']['calls'] / XLSTM_RANK_E2E:.1f} collectives a step) "
          f"drift from phase 13(b)'s one-card logits by max |diff| "
          f"{e2e:.3e} ({e2e / largest:.3e} of the largest |logit| "
          f"{largest:.3f}; reported: the same sums in another order, grown "
          f"with depth by the exponential gates)")
    errs = np.stack([p["tf"]["layer_err"] for p in papers]).max(0)
    over = errs > XLSTM_RANK_TOL
    print(f"xlstm_ranks_layers: each of the {cfg.num_layers} layers' decode "
          f"on the ranks, fed phase 13(b)'s one-card input of that layer at "
          f"each of {XLSTM_RANK_TF} steps from fresh states, against the "
          f"norm of the one-card layer's own output: worst mLSTM "
          f"{worst_layer['mlstm']:.3e}, sLSTM {worst_layer['slstm']:.3e}, "
          f"median {float(np.median(errs)):.3e}; within {XLSTM_RANK_TOL} at "
          f"{int((~over).sum())} of {errs.size} (layer, step) points; the "
          f"other {int(over.sum())} within {XLSTM_RANK_SENS:g} x the "
          f"one-card sensitivity there (a one-ulp move of the input: median "
          f"{float(np.median(sens)):.3e}, max {float(sens.max()):.3e}), "
          f"error / sensitivity at most "
          f"{float((errs[over] / sens[over]).max(initial=0)):.2f}: "
          + ", ".join(f"layer {i} step {t} {errs[i, t]:.3e} "
                      f"({sens[i, t]:.3e})" for i, t in zip(*np.nonzero(over)))
          + f" ({tf['layer_s']:.3f} s)")
    bound_ms, w_bytes, _, st_bytes = decode_bound(cfg, kw)
    st = np.asarray(papers[0]["step_ms"])
    med = float(np.median(st))
    steps = papers[0]["steps"]
    gen = kw["requests"] * kw["max_new"]
    wall = max(p["wall"] for p in papers)
    colls = [p["collectives"] for p in papers]
    print(f"xlstm_ranks_serve {XLSTM_ARCH} (params float32, activations "
          f"{cfg.dtype}, float32 states, one head a rank) over {len(outs)} "
          f"ranks: {kw['requests']} requests of prompt {kw['prompt_len']} + "
          f"{kw['max_new']} new at batch {kw['batch']}, horizon "
          f"{kw['horizon']}; {steps} steps, {gen} tokens in {wall:.3f} s = "
          f"{gen / wall:.1f} tokens/s; step ms median {med:.3f} (min "
          f"{st.min():.3f}, max {st.max():.3f}) against a bound of "
          f"{bound_ms:.3f} ms (weights {w_bytes / 1e9:.3f} GB + states read "
          f"and written {st_bytes / 1e9:.3f} GB at {HBM_RATE / 1e12:.2f} "
          f"TB/s, one card; {bound_ms / med * 100:.2f}% of bound); "
          f"collectives a step {colls[0]['calls'] / steps:.1f} "
          f"({colls[0]['calls'] / steps / cfg.num_layers:.2f} a layer), "
          f"{colls[0]['bytes'] / steps / 1e6:.3f} MB sent by rank 0, host ms "
          f"in them a step by rank "
          f"{[round(c['seconds'] / steps * 1e3, 3) for c in colls]} "
          f"({colls[0]['seconds'] / papers[0]['wall'] * 100:.1f}% of rank "
          f"0's serve; by kind a step on rank 0: "
          f"{kinds_line(colls[0]['by_kind'], steps)}); page-table host ms a "
          f"step {papers[0]['table_ms'] / steps:.3f}; probe_perf launches by "
          f"rank {[p['tf']['launches'] + p['launches'] for p in papers]}; "
          f"peak a rank {max(p['peak'] for p in papers):.2f} GiB; card: "
          f"{smi}")
    return sum(p["tf"]["launches"] + p["launches"] for p in papers)


def check_whisper_ranks(ref, outs, smi):
    """(c): every rank's logits rows and greedy tokens against one card's
    (within ``FAMILY_RANK_TOL``), its cross K/V blocks (within it of the
    largest |value|: the encoder's float32 sums over 1500 frames grow them
    to tens), the heads it holds, and the training step's loss, grad norm
    and ``final_norm/bias``."""
    from repro_torch import configs
    cfg = configs.get_config(WHISPER_ARCH)
    lines = []
    for mname, shape in DECODE_MESHES.items():
        worst = kv = 0.0
        for r, o in enumerate(outs):
            got = o["whisper"][mname]
            a, b = got["rows"]
            err = float(np.abs(got["logits"] - ref["logits"][:, a:b]).max())
            worst, kv = max(worst, err), max(kv, got["kv_err"])
            check(err <= FAMILY_RANK_TOL and got["kv_err"] <= FAMILY_RANK_TOL,
                  f"whisper ranks {mname}: rank {r}'s logits {err:.3e} or "
                  f"cross K/V {got['kv_err']:.3e} of the largest from one "
                  f"card's")
            check(np.array_equal(got["next"], ref["next"]),
                  f"whisper ranks {mname}: rank {r}'s greedy tokens differ")
            split = cfg.num_heads % shape["model"] == 0
            check(got["heads"] == cfg.num_heads // (shape["model"] if split
                                                   else 1),
                  f"whisper ranks {mname}: rank {r} holds {got['heads']} "
                  f"heads")
        got = outs[0]["whisper"][mname]
        steps = WHISPER_RANK_TF
        lines.append(f"{mname} ({got['heads']} heads a rank"
                     + (", replicated" if got["heads"] == cfg.num_heads
                        else "") + f"): logits within {worst:.3e}, cross "
                     f"K/V within {kv:.3e} of its largest, encode "
                     f"{got['enc_s']:.3f} s, "
                     f"{got['coll']['calls'] / steps:.1f} collectives a "
                     f"step")
    want = ref["train"]["metrics"]
    for r, o in enumerate(outs):
        m = o["whisper"]["train"]["metrics"]
        for key in ("loss", "grad_norm"):
            check(abs(m[key] - want[key]) <= TRAIN_RANK_TOL * abs(want[key]),
                  f"whisper ranks training: rank {r}'s {key} {m[key]} "
                  f"against one card's {want[key]}")
        check(o["whisper"]["train"]["bias_zero"], f"whisper ranks training: "
              f"rank {r}'s final_norm/bias or its moments moved from zero")
    t = outs[0]["whisper"]["train"]
    f = WHISPER_RANK_TRAIN
    rel = {key: abs(t["metrics"][key] - want[key]) / abs(want[key])
           for key in ("loss", "grad_norm")}
    print(f"whisper_ranks {WHISPER_ARCH} at its published widths (float32, "
          f"{WHISPER_TF[3]} stub frames, {WHISPER_RANK_TF} teacher-forced "
          f"steps x {WHISPER_TF[0]}) over {len(outs)} ranks against one "
          f"card within {FAMILY_RANK_TOL}, greedy tokens equal: "
          + "; ".join(lines))
    print(f"whisper_ranks_train: one float32 step on {f['mesh']} with "
          f"seq_shard at batch {f['batch']} x ({f['seq']} frames, "
          f"{min(512, f['seq'])} decoder tokens; phase 13(c)'s shape): loss "
          f"{t['metrics']['loss']:.6f} (one card {want['loss']:.6f}, "
          f"{rel['loss']:.3e} apart), grad norm "
          f"{t['metrics']['grad_norm']:.6f} ({rel['grad_norm']:.3e} apart), "
          f"final_norm/bias and its moments exactly 0 on every rank; "
          f"{max(o['whisper']['train']['ms'] for o in outs):.1f} ms (one "
          f"card {ref['train']['ms']:.1f} ms); collectives on rank 0: "
          f"{kinds_line(t['coll']['by_kind'], 1)}; peak a rank "
          f"{max(o['whisper']['train']['peak'] for o in outs):.2f} GiB (one "
          f"card {ref['train']['peak']:.2f}); card: {smi}")


def check_xlstm_train_ranks(ref, outs, smi):
    """(d): the loss against the cut's one-card step, the same on every
    rank; every rank's gradient blocks, leaf by leaf, in float64 within
    ``SSM_RANK_GRAD_TOL`` of one card's and in float32 within their leaf's
    bound (``XLSTM_RANK_SENS`` times its one-ulp sensitivity, at least
    ``SSM_RANK_GRAD_TOL``); the collectives the same at a quarter of
    the sequence; the figures."""
    want = ref["metrics"]
    tol = SSM_RANK_GRAD_TOL[XLSTM_ARCH]
    bound = {k: max(tol, XLSTM_RANK_SENS * v)
             for k, v in ref["sens"].items()}
    for r, o in enumerate(outs):
        x = o["xtrain"]
        for key, got, one in (("loss", x["metrics"]["loss"], want["loss"]),
                              ("float64 loss", x["loss64"], ref["loss64"])):
            check(abs(got - one) <= TRAIN_RANK_TOL * abs(one),
                  f"xlstm ranks training: rank {r}'s {key} {got} against "
                  f"one card's {one}")
        seqs = list(x["by_seq"])
        check(x["by_seq"][seqs[0]] == x["by_seq"][seqs[1]],
              f"xlstm ranks training: rank {r}'s collectives grow with the "
              f"sequence: {x['by_seq']}")
        bad = {k: e for k, e in x["grad_err64"].items() if e > tol}
        check(not bad, f"xlstm ranks training: rank {r}'s float64 gradient "
              f"blocks off one card's by more than {tol:g} of the leaf's "
              f"largest: {bad}")
        bad = {k: (e, bound[k]) for k, e in x["grad_err"].items()
               if e > bound[k]}
        check(not bad, f"xlstm ranks training: rank {r}'s float32 gradient "
              f"blocks past their leaf's bound (error, bound): {bad}")
    errs = [(e, r, k) for r, o in enumerate(outs)
            for k, e in o["xtrain"]["grad_err"].items()]
    worst64, worst64_r, worst64_k = max(
        (e, r, k) for r, o in enumerate(outs)
        for k, e in o["xtrain"]["grad_err64"].items())
    worst, worst_r, worst_k = max(errs)
    ratio, ratio_r, ratio_k = max((e / ref["sens"][k], r, k)
                                  for e, r, k in errs)
    sens = sorted(ref["sens"].values())
    x = outs[0]["xtrain"]
    f = XLSTM_RANK_TRAIN
    cfg = xlstm_rank_train_config()
    n_slstm = sum(cfg.is_slstm_layer(i) for i in range(cfg.num_layers))
    print(f"xlstm_ranks_train {XLSTM_ARCH} at its published widths, "
          f"{f['depth']} of 48 layers ({n_slstm} sLSTM), one float32 step at "
          f"batch {f['batch']} x {f['seq']} over {len(outs)} ranks on "
          f"{f['mesh']} with seq_shard: loss {x['metrics']['loss']:.6f} (one "
          f"card {want['loss']:.6f}, "
          f"{abs(x['metrics']['loss'] - want['loss']) / want['loss']:.3e} "
          f"apart; grad norm {x['metrics']['grad_norm']:.6f}, one card "
          f"{want['grad_norm']:.6f}); every rank's gradient block of all "
          f"{len(x['grad_err'])} leaves against one card's, over the "
          f"leaf's largest: in float64 the worst {worst64:.3e} "
          f"({worst64_k}, rank {worst64_r}; bound {tol:g}; loss "
          f"{x['loss64']:.12f}, one card {ref['loss64']:.12f}); in float32 "
          f"the worst {worst:.3e} ({worst_k}, rank {worst_r}), and over its "
          f"leaf's one-ulp move (the most of {XLSTM_RANK_ULP_DRAWS} draws; "
          f"the leaves' moves {sens[0]:.3e}-{sens[-1]:.3e}, median "
          f"{sens[len(sens) // 2]:.3e}) at most {ratio:.3f} ({ratio_k}, "
          f"rank {ratio_r}; bound {XLSTM_RANK_SENS:g}); "
          f"{max(o['xtrain']['ms'] for o in outs):.1f} ms a step (one card "
          f"{ref['ms']:.1f} ms); the sLSTM's host time {x['slstm_s']:.3f} s "
          f"= {x['slstm_s'] / (x['ms'] / 1e3) * 100:.1f}% of rank 0's step "
          f"({x['slstm_calls'][0]} passes, {x['slstm_calls'][1]} backward); "
          f"collectives {x['coll']['calls']}, "
          f"{x['coll']['bytes'] / 1e6:.1f} MB sent by rank 0, "
          f"{x['coll']['seconds'] * 1e3:.1f} host ms; by kind and pass: "
          f"{kinds_line(x['coll']['by_kind'], 1)}; the loss and gradient "
          f"alone issue the same collectives at {list(x['by_seq'])} tokens "
          f"({sum(next(iter(x['by_seq'].values())).values())}); peak a rank "
          f"{max(o['xtrain']['peak'] for o in outs):.2f} GiB; card: {smi}")


def ssm_ranks_path(smi):
    """Phase 18: the ssm and encdec families decoding and training over
    (data, model) meshes of ``RANKS`` rank processes (gloo, every rank on
    the one card, as phases 15–17): (a) the small cases against one card,
    (b) xlstm-1.3b at its published widths and depth on (1, 4) against
    phase 13(b), then served, (c) whisper-tiny at its published widths on
    both meshes and trained on (2, 2), (d) xlstm-1.3b's 8-layer cut trained
    on (2, 2).  Returns the ranks' ``probe_perf`` launches."""
    import torch
    from repro_torch.launch.mesh import spawn_ranks
    t_phase = time.perf_counter()
    refs = small_family_rank_references(SSM_RANK_CASES, SSM_RANK_SERVED)
    train_refs = small_train_rank_references(SSM_RANK_TRAIN)
    wref = whisper_rank_references(smi)
    xref = xlstm_train_reference()
    ref_s = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    t0, w0 = time.perf_counter(), time.time()
    outs = spawn_ranks(ssm_rank_main, RANKS, refs,
                       {k: v for k, v in wref.items() if k != "train"},
                       backend="gloo", device="cuda:0", timeout=RANK_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    start_s = max(o["span"][0] for o in outs) - w0
    n, worst, _ = check_small_family_ranks(refs, outs, SSM_RANK_CASES,
                                           SSM_RANK_SERVED)
    nt, worst_g, worst_p, _ = check_small_train_ranks(
        train_refs, outs, SSM_RANK_TRAIN, key="train",
        grad_tols=SSM_RANK_GRAD_TOL)
    small_l = sum(o["small_launches"] for o in outs)
    print(f"ssm_ranks_small: {n} decode cases (xlstm-1.3b on 1x4 and 2x2, "
          f"whisper-tiny on 2x2 and with 6 heads, replicated, on 1x4; smoke "
          f"widths, 2 layers, float32) over {RANKS} ranks (gloo, all on "
          f"cuda:0) equal one card: {DECODE_RANK_SMALL[1]} teacher-forced "
          f"steps' logits within {worst:.3e} (bound {FAMILY_RANK_TOL}), "
          f"greedy tokens equal; {SSM_RANK_SERVED} served as one card "
          f"(tokens, steps); {nt} training cases (xlstm on 2x2 and 6-head "
          f"whisper on 1x4, seq_shard) equal one card: every gradient block "
          f"within {worst_g:.3e} of its leaf's largest (bounds "
          f"{TRAIN_RANK_TOL}, xlstm {SSM_RANK_GRAD_TOL['xlstm-1.3b']}), "
          f"parameters within {worst_p:.3e} where |g| >= 1e-6, whisper's "
          f"final_norm/bias gradient 0; probe_perf launches over the ranks "
          f"{small_l}; ranks {max(o['small_s'] for o in outs):.3f} s")
    launches = small_l + check_xlstm_ranks(outs, smi)
    check_whisper_ranks(wref, outs, smi)
    check_xlstm_train_ranks(xref, outs, smi)
    print(f"ssm_ranks_time: phase 18 took "
          f"{time.perf_counter() - t_phase:.3f} s (one-card references "
          f"{ref_s:.3f} s; gloo {spawn_s:.3f} s, the ranks started "
          f"{start_s:.3f} s after the spawn; in the ranks (a) "
          f"{max(o['small_s'] for o in outs):.3f} s, (b) "
          f"{max(o['paper_s'] for o in outs):.3f} s, (c) "
          f"{max(o['whisper_s'] for o in outs):.3f} s, (d) "
          f"{max(o['xtrain_s'] for o in outs):.3f} s); card: {smi}")
    return launches


def main() -> int:
    t_script = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the card and has no CPU mode")
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
    laps, t_lap = {}, [t_script]

    def lap(phases):
        """Seconds since the last lap, kept under ``phases``."""
        now = time.perf_counter()
        laps[phases] = round(now - t_lap[0], 1)
        t_lap[0] = now

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
    _, small_cpu, one_cpu = check_small_mesh_vs_cpu(serving, hashmap,
                                                    HashMemConfig, k)
    lap("1-3")

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
    host_rate = probes.size / e2e_ms / 1e3
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
    lap("4")

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
    lap("5-6")

    # -- 7. the displaced path at PAPER_HASHMEM ---------------------------------
    data = dict(keys=keys, vals=vals, held_k=held_k, held_v=held_v,
                probes=probes, pidx=pidx, qd=qd, qbits=qbits)
    d_path = displaced_path(hashmap, k, ref, data, smi)
    del qd, qbits, data["qd"], data["qbits"]
    lap("7")

    # -- 8. serving at paper scale ----------------------------------------------
    s_path, host_results = serving_path(serving, hashmap, k, smi)
    lap("8")

    # -- 9. the mesh path at paper scale -------------------------------------
    m_probe, m_serve, m_digests = mesh_path(serving, hashmap, k, data, smi,
                                            host_rate, host_results)
    save_rank_data(data)
    del data
    lap("9")

    # -- 10. decode serving over the HashMem page table -------------------------
    with torch.no_grad():
        decode_launches, _, _ = decode_path(k, ref, smi)
    lap("10")

    # -- 11. training and the checkpoint -------------------------------------
    ckpt_launches, _ = training_path(hashmap, PAPER_HASHMEM, keys, vals,
                                     probes, pidx, k, smi)
    del keys, vals, probes, pidx
    lap("11")

    # -- 12. the moe and hybrid families ---------------------------------------
    family_launches, _, _ = family_path(k, ref, smi)
    lap("12")

    # -- 13. the ssm, encdec and vlm families -----------------------------------
    rest_launches, _ = rest_path(k, ref, smi)
    lap("13")

    # -- 14. the sharded table over ranks -----------------------------------
    rank_launches = ranks_path(smi, host_results, small_cpu, one_cpu,
                               m_digests)
    lap("14")

    # -- 15. decode over a (data, model) mesh of ranks ----------------------
    with torch.no_grad():
        decode_rank_launches = decode_ranks_path(smi)
    lap("15")

    # -- 16. training over a (data, model) mesh of ranks ---------------------
    reset_launches(k)
    train_ranks_path(smi)
    train_rank_launches = read_launches(k)
    check(not any(train_rank_launches.values()),
          f"phase 16 launched a probe kernel: {train_rank_launches}")
    print(f"train_ranks_launches: {train_rank_launches} (training launches "
          f"no probe kernel; the kernels line adds 0)")
    lap("16")

    # -- 17. the moe, hybrid and vlm families over a mesh of ranks ---------
    family_rank_launches = family_ranks_path(smi)
    lap("17")

    # -- 18. the ssm and encdec families over a mesh of ranks ---------------
    ssm_rank_launches = ssm_ranks_path(smi)
    lap("18")

    replaces = {"probe_perf": "src/repro/kernels/probe_perf.py:34",
                "probe_area": "src/repro/kernels/probe_area.py:32",
                "probe_bitserial": "src/repro/kernels/probe_bitserial.py:36"}
    check(d_path["probe_perf"] > 0,
          "the displaced path never launched probe_perf")
    check(s_path["probe_perf"] > 0,
          "the serving path never launched probe_perf")
    check(m_probe["probe_perf"] == 1 and m_serve["probe_perf"] > 0,
          "the mesh path did not launch probe_perf")
    launches = {"probe_perf": perf_path["probe_perf"] + decode_launches
                + ckpt_launches + family_launches + rest_launches
                + rank_launches["probe_perf"] + decode_rank_launches
                + family_rank_launches + ssm_rank_launches,
                "probe_area": bs_path["probe_area"]
                + rank_launches["probe_area"],
                "probe_bitserial": bs_path["probe_bitserial"]
                + rank_launches["probe_bitserial"]}
    print(f"chip_smoke: phases 1-18 in {time.perf_counter() - t_script:.1f} "
          f"s (by phase, s: {json.dumps(laps)}); card: {smi}")
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
