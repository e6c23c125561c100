// HashMem performance-optimized probe (paper §2.2, CAM compare) for Hopper.
//
// Replaces src/repro/kernels/probe_perf.py:_kernel, the Pallas kernel that
// runs one grid step (q, c) per chain step and latches the first match in a
// 128-lane output line.
//
// Contract (all words uint32 bits):
//   pool    (P, S, 2)  lane 0 = key, lane 1 = value; one page = one row
//   queries (Q,)
//   pages   (Q, C)     int32 page ids in chain order, -1 = skip
//   out     (Q, 4)     [value, found, page, slot]; [0, 0, 0, 0] if no match
// The first chain step that matches wins, then the lowest slot in its row.
// A page id >= P reads row P-1, as the JAX reference's clamped gather does.
//
// Bound: bytes of rows loaded.  A probe needs its rows' slots up to the first
// match (the whole row on a step that misses), 8 bytes each, for 4 bytes of
// query, so the kernel is memory-bound by far.  The design loads only those
// bytes, rounded up to one chunk, and each of them once:
//   * one warp per query, several queries per block; the chain walk is a
//     loop inside the warp (the TPU's sequential grid axis);
//   * a -1 step loads nothing (the TPU needed a forward-filled fetch index);
//   * each lane loads (key, value) as one 8-byte word, lanes on neighbouring
//     slots, so a warp reads 256 contiguous bytes per load; the value comes
//     from the same load as its key;
//   * a row is read in chunks of kLoadsPerChunk warp loads (1 KiB), all in
//     flight together; after each chunk a warp min-reduce picks the lowest
//     matching slot, and the walk stops at the first chunk that matched:
//     no later chunk of the row and no later row is loaded.
//
// Plain C interface, bound from Python with ctypes; returns
// cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kLoadsPerChunk = 4;       // 4 x 256 B per warp per match test
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kNoSlot = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
probe_perf_kernel(const uint2* __restrict__ pool,
                  const uint32_t* __restrict__ queries,
                  const int32_t* __restrict__ pages,
                  uint4* __restrict__ out,
                  int64_t Q, int C, int S, int64_t P) {
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
    for (int base = 0; base < S && first == kNoSlot;
         base += 32 * kLoadsPerChunk) {
      uint2 kv[kLoadsPerChunk];
#pragma unroll
      for (int u = 0; u < kLoadsPerChunk; ++u) {   // issue every load first
        const int s = base + u * 32 + lane;
        kv[u] = s < S ? __ldg(row + s) : make_uint2(~key, 0u);
      }
      unsigned slot = kNoSlot;
#pragma unroll
      for (int u = kLoadsPerChunk - 1; u >= 0; --u) {   // lowest slot last
        if (kv[u].x == key) {
          slot = unsigned(base + u * 32 + lane);
          val = kv[u].y;
        }
      }
      first = __reduce_min_sync(kFull, slot);
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

extern "C" int probe_perf_launch(const void* pool, const void* queries,
                                 const void* pages, void* out, int64_t Q,
                                 int C, int S, int64_t P, void* stream) {
  if (Q > 0) {
    const int64_t blocks = (Q + kWarpsPerBlock - 1) / kWarpsPerBlock;
    probe_perf_kernel<<<unsigned(blocks), kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint2*>(pool),
        static_cast<const uint32_t*>(queries),
        static_cast<const int32_t*>(pages), static_cast<uint4*>(out), Q, C, S,
        P);
  }
  return int(cudaGetLastError());
}
