// HashMem bit-serial probe (paper §2.2, column-oriented compare) for Hopper.
//
// Replaces src/repro/kernels/probe_bitserial.py:_make_kernel(key_bits), the
// Pallas kernel that, per chain step, ORs plane_j XOR broadcast(query bit j)
// over the b bit-planes of the row, inverts that into match words, takes the
// lowest matching slot and reads its value from the pool's value lane.
//
// Contract (all words uint32 bits):
//   planes  (P, b, W)  bit i of planes[p, j, w] = bit j of the key at slot
//                      32w + i of page p; W = S / 32
//   pool    (P, S, 2)  only lane 1 (the value) is read, never the key lane
//   queries (Q,)
//   pages   (Q, C)     int32 page ids in chain order, -1 = skip
//   out     (Q, 4)     [value, found, page, slot]; [0, 0, 0, 0] if no match
// A slot matches when its low b key bits equal the query's low b bits (all
// 32 at b = 32), exactly as in the TPU kernel: no other filter.  The first
// chain step that matches wins, then the lowest slot.  A page id >= P reads
// row P-1, as the JAX reference's clamped gather does.
//
// Bound: bytes of plane words loaded.  A step before the hit needs its b
// plane rows (b * W * 4 bytes, 2 KiB at b = 32, S = 512); the hit step needs
// each plane up to the hit's word, plus one value.  The compare is 2 integer
// ops per plane word, far below the card's rate.  The design:
//   * one warp per query, several queries per block; the chain walk is a
//     loop inside the warp, and the first step that matched ends it;
//   * a -1 step loads nothing;
//   * lane l owns plane word l (and l + 32, ... where W > 32): it issues its
//     b plane loads at once (all independent, so all in flight), and for
//     each plane the lanes read W neighbouring words;
//   * it ORs plane ^ query-word, inverts, and __ffs gives its lowest match;
//     a warp min over 32w + bit gives the slot, and one 4-byte load reads
//     the value.
// At W = 16 half the warp idles; whole plane rows are read on the hit step
// too (no intra-row early exit below 32 words).
//
// Plain C interface, bound from Python with ctypes; returns
// cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxBits = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kNoSlot = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
probe_bitserial_kernel(const uint32_t* __restrict__ planes,
                       const uint32_t* __restrict__ pool,
                       const uint32_t* __restrict__ queries,
                       const int32_t* __restrict__ pages,
                       uint4* __restrict__ out,
                       int64_t Q, int C, int W, int b, int64_t P) {
  const int lane = threadIdx.x & 31;
  const int64_t q = int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= Q) return;                       // whole warp leaves together

  const uint32_t key = queries[q];
  const int32_t* sched = pages + q * C;
  const int S = W * 32;
  uint4 res = make_uint4(0u, 0u, 0u, 0u);

  for (int c = 0; c < C; ++c) {
    const int32_t page = sched[c];
    if (page < 0) continue;                 // skipped step: no row load
    const int64_t row_id = page < P ? int64_t(page) : P - 1;
    const uint32_t* row = planes + row_id * b * W;

    unsigned first = kNoSlot;
    for (int base = 0; base < W && first == kNoSlot; base += 32) {
      const int w = base + lane;
      unsigned slot = kNoSlot;
      if (w < W) {
        uint32_t word[kMaxBits];
#pragma unroll
        for (int j = 0; j < kMaxBits; ++j) {          // issue every load first
          if (j < b) word[j] = __ldg(row + j * W + w);
        }
        uint32_t mism = 0u;
#pragma unroll
        for (int j = 0; j < kMaxBits; ++j) {          // b bit-serial steps
          if (j < b) mism |= word[j] ^ (0u - ((key >> j) & 1u));
        }
        const uint32_t match = ~mism;
        if (match != 0u) slot = unsigned(w * 32 + __ffs(match) - 1);
      }
      first = __reduce_min_sync(kFull, slot);
    }
    if (first != kNoSlot) {
      const uint32_t val = __ldg(pool + (row_id * S + first) * 2 + 1);
      res = make_uint4(val, 1u, uint32_t(page), first);
      break;                                // first step that matched wins
    }
  }
  if (lane == 0) out[q] = res;
}

}  // namespace

extern "C" int probe_bitserial_launch(const void* planes, const void* pool,
                                      const void* queries, const void* pages,
                                      void* out, int64_t Q, int C, int W,
                                      int b, int64_t P, void* stream) {
  if (b <= 0 || b > kMaxBits || W <= 0) return int(cudaErrorInvalidValue);
  if (Q > 0) {
    const int64_t blocks = (Q + kWarpsPerBlock - 1) / kWarpsPerBlock;
    probe_bitserial_kernel<<<unsigned(blocks), kWarpsPerBlock * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(planes),
        static_cast<const uint32_t*>(pool),
        static_cast<const uint32_t*>(queries),
        static_cast<const int32_t*>(pages), static_cast<uint4*>(out), Q, C, W,
        b, P);
  }
  return int(cudaGetLastError());
}
