// HashMem area-optimized probe (paper §2.1, one comparator per subarray)
// for Hopper.
//
// Replaces src/repro/kernels/probe_area.py:_make_kernel(strip), the Pallas
// kernel that walks each activated row in strips of min(128, S) slots, one
// compare per strip, latching the first strip that matched.
//
// Contract (all words uint32 bits), the same function as probe_perf:
//   pool    (P, S, 2)  lane 0 = key, lane 1 = value; one page = one row
//   queries (Q,)
//   pages   (Q, C)     int32 page ids in chain order, -1 = skip
//   out     (Q, 4)     [value, found, page, slot]; [0, 0, 0, 0] if no match
// The first chain step that matches wins, then the lowest slot in its row.
// A page id >= P reads row P-1, as the JAX reference's clamped gather does.
// S must be a multiple of the strip (the wrapper checks).
//
// Bound: bytes of rows loaded, as for probe_perf: a probe needs its rows'
// slots up to the first match (the whole row on a step that misses), 8
// bytes each, for 4 bytes of query.  The design keeps the paper's single
// comparator as the TPU form has it, and loads only what that walk reads:
//   * one warp per query, several queries per block; the chain walk is a
//     loop inside the warp, and the first step that matched ends it;
//   * a -1 step loads nothing (the TPU needed a forward-filled fetch index);
//   * the row is walked strip by strip, in order: each lane loads its
//     strip/32 (key, value) pairs as 8-byte words, all in flight, then the
//     warp makes ONE compare of the strip (a min-reduce over the lanes'
//     lowest matching slot) and the next strip is loaded only if it found
//     nothing.  The value comes from the same load as its key.
// At S >= 128 the strip is 128 slots = 1 KiB, which is probe_perf's chunk,
// so on this card the two kernels move the same bytes; the paper's
// area/perf contrast is silicon area and compare cycles under a row
// buffer, not bytes.
//
// Plain C interface, bound from Python with ctypes; returns
// cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxStrip = 128;          // the TPU kernel's STRIP
constexpr int kMaxLoads = kMaxStrip / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kNoSlot = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
probe_area_kernel(const uint2* __restrict__ pool,
                  const uint32_t* __restrict__ queries,
                  const int32_t* __restrict__ pages,
                  uint4* __restrict__ out,
                  int64_t Q, int C, int S, int strip, int64_t P) {
  const int lane = threadIdx.x & 31;
  const int64_t q = int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= Q) return;                       // whole warp leaves together

  const uint32_t key = queries[q];
  const int32_t* sched = pages + q * C;
  uint4 res = make_uint4(0u, 0u, 0u, 0u);

  for (int c = 0; c < C; ++c) {
    const int32_t page = sched[c];
    if (page < 0) continue;                 // skipped step: no row load
    const int64_t row_id = page < P ? int64_t(page) : P - 1;
    const uint2* row = pool + row_id * S;

    unsigned first = kNoSlot;
    uint32_t val = 0u;
    for (int base = 0; base < S; base += strip) {   // one strip per compare
      uint2 kv[kMaxLoads];
#pragma unroll
      for (int u = 0; u < kMaxLoads; ++u) {          // issue every load first
        const int s = u * 32 + lane;
        kv[u] = s < strip ? __ldg(row + base + s) : make_uint2(~key, 0u);
      }
      unsigned slot = kNoSlot;
#pragma unroll
      for (int u = kMaxLoads - 1; u >= 0; --u) {     // lowest slot last
        if (kv[u].x == key) {
          slot = unsigned(base + u * 32 + lane);
          val = kv[u].y;
        }
      }
      first = __reduce_min_sync(kFull, slot);
      if (first != kNoSlot) break;          // latch the first strip's match
    }
    if (first != kNoSlot) {
      val = __shfl_sync(kFull, val, int(first & 31u));
      res = make_uint4(val, 1u, uint32_t(page), first);
      break;                                // first step that matched wins
    }
  }
  if (lane == 0) out[q] = res;
}

}  // namespace

extern "C" int probe_area_launch(const void* pool, const void* queries,
                                 const void* pages, void* out, int64_t Q,
                                 int C, int S, int strip, int64_t P,
                                 void* stream) {
  if (strip <= 0 || strip > kMaxStrip || S % strip != 0) {
    return int(cudaErrorInvalidValue);
  }
  if (Q > 0) {
    const int64_t blocks = (Q + kWarpsPerBlock - 1) / kWarpsPerBlock;
    probe_area_kernel<<<unsigned(blocks), kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint2*>(pool),
        static_cast<const uint32_t*>(queries),
        static_cast<const int32_t*>(pages), static_cast<uint4*>(out), Q, C, S,
        strip, P);
  }
  return int(cudaGetLastError());
}
