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
// each plane up to the hit's word, in 32-byte sectors, plus one value.  The
// compare is 2 integer ops per plane word, far below the card's rate.
//
// Each query waits on three dependent loads in turn (its schedule entry,
// its plane words, its value), so the probe is bound by latency unless many
// warps are in flight; a lane that holds one word of every plane (b
// registers of plane words) caps the warps an SM can hold.  The design:
//   * one warp per query, several queries per block; the chain walk is a
//     loop inside the warp, and the first step that matched ends it; a -1
//     step loads nothing;
//   * splits the planes, not the words, over the lanes: lane pair
//     (2p, 2p+1) owns plane p and plane p + 16; each lane of the pair
//     reads 16 bytes (4 words) of the plane's 32-byte sector, so one warp
//     load covers 16 whole sectors and no lane idles at b = 32;
//   * reads a row one chunk at a time: 8 words of every plane, one sector
//     each, 256 slots.  A warp OR (__reduce_or_sync) per word gives the
//     chunk's 8 mismatch words; the first non-zero inverted word holds the
//     slot (32 * word + __ffs - 1), and the walk stops at the first chunk
//     that matched, so on the hit step each plane is read only up to the
//     hit's sector, as the bound counts; the value is one 4-byte load;
//   * keeps 8 plane words a lane (two 16-byte loads, both in flight): 29
//     registers, so 8 blocks of 8 warps fill an SM.
// On the H100 this reaches 59-63% of the bound, and the time stays the
// same when the hit step reads each plane whole (at W = 16 a plane is 64
// bytes, two sectors) or fetches its next sector ahead: the memory appears
// to move 64-byte pairs of sectors either way, so the traffic is whole
// plane rows, 2.9-3.1 TB/s of the card's 3.35.  A persistent grid, two
// queries side by side in a warp, and a lane per word with 4-byte loads
// were no faster (PERF.md).
// Edges: a word at index >= W counts as mismatch (all ones), so a ragged
// chunk (W < 8, or W not a multiple of 8) never matches there; a plane
// >= b contributes 0 to the OR and loads nothing.  The 16-byte loads need
// W % 4 == 0 and 16-byte-aligned planes; otherwise the same words are read
// with 4-byte loads (the wrapper's load_width states the same rule), at 6
// blocks an SM, where that path needs no spills.
//
// Plain C interface, bound from Python with ctypes; returns
// cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kBlocksPerSM = 8;        // 64 warps an SM: <= 32 registers
constexpr int kBlocksPerSM4 = 6;       // the 4-byte path: <= 40 registers
constexpr int kMaxBits = 32;
constexpr int kChunkWords = 8;         // one 32-byte sector of each plane
constexpr unsigned kFull = 0xFFFFFFFFu;

bool vector_loads(const void* planes, int W) {
  return W % 4 == 0 && reinterpret_cast<uintptr_t>(planes) % 16 == 0;
}

// Mismatch words w..w+3 of one plane against the query word qw (all ones
// where the query bit is 1): plane ^ qw, and all ones past W.
template <bool kVec>
__device__ __forceinline__ uint4 plane_mismatch(const uint32_t* plane, int w,
                                                int W, uint32_t qw) {
  if (kVec) {                            // W % 4 == 0: all 4 words or none
    if (w >= W) return make_uint4(kFull, kFull, kFull, kFull);
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(plane + w));
    return make_uint4(v.x ^ qw, v.y ^ qw, v.z ^ qw, v.w ^ qw);
  }
  return make_uint4(w + 0 < W ? __ldg(plane + w + 0) ^ qw : kFull,
                    w + 1 < W ? __ldg(plane + w + 1) ^ qw : kFull,
                    w + 2 < W ? __ldg(plane + w + 2) ^ qw : kFull,
                    w + 3 < W ? __ldg(plane + w + 3) ^ qw : kFull);
}

__device__ __forceinline__ uint32_t word_of(const uint4& m, int k) {
  return k == 0 ? m.x : k == 1 ? m.y : k == 2 ? m.z : m.w;
}

template <bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32,
                                  kVec ? kBlocksPerSM : kBlocksPerSM4)
probe_bitserial_kernel(const uint32_t* __restrict__ planes,
                       const uint32_t* __restrict__ pool,
                       const uint32_t* __restrict__ queries,
                       const int32_t* __restrict__ pages,
                       uint4* __restrict__ out,
                       int64_t Q, int C, int W, int b, int64_t P) {
  const int lane = threadIdx.x & 31;
  const int64_t q = int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= Q) return;                    // whole warp leaves together

  const int half = lane & 1;             // words 4*half .. 4*half+3 of a chunk
  const int j0 = lane >> 1;              // this lane's planes: j0, j0 + 16
  const int j1 = j0 + 16;
  const uint32_t key = __ldg(queries + q);
  const uint32_t qw0 = 0u - ((key >> j0) & 1u);      // j0 <= 15
  const uint32_t qw1 = 0u - ((key >> j1) & 1u);      // j1 <= 31
  const int32_t* sched = pages + q * C;
  const int chunks = (W + kChunkWords - 1) / kChunkWords;
  uint4 res = make_uint4(0u, 0u, 0u, 0u);

  for (int c = 0; c < C; ++c) {
    const int32_t page = __ldg(sched + c);
    if (page < 0) continue;              // skipped step: no row load
    const int64_t row_id = page < P ? int64_t(page) : P - 1;
    const uint32_t* row = planes + row_id * b * W;

    int slot = -1;
    for (int ch = 0; ch < chunks && slot < 0; ++ch) {
      const int w = ch * kChunkWords + 4 * half;
      uint4 m = make_uint4(0u, 0u, 0u, 0u);         // planes >= b: 0
      uint4 m1 = m;
      if (j0 < b) m = plane_mismatch<kVec>(row + j0 * W, w, W, qw0);
      if (j1 < b) m1 = plane_mismatch<kVec>(row + j1 * W, w, W, qw1);
      m.x |= m1.x; m.y |= m1.y; m.z |= m1.z; m.w |= m1.w;
      // word k of the chunk lies in the lanes of half k / 4; the lowest
      // matching word holds the slot
#pragma unroll
      for (int k = 0; k < kChunkWords; ++k) {
        const uint32_t mine = (k >> 2) == half ? word_of(m, k & 3) : 0u;
        const uint32_t match = ~__reduce_or_sync(kFull, mine);
        if (slot < 0 && match != 0u)
          slot = 32 * (ch * kChunkWords + k) + __ffs(match) - 1;
      }
    }
    if (slot >= 0) {
      const uint32_t val =
          __ldg(pool + (row_id * int64_t(W) * 32 + slot) * 2 + 1);
      res = make_uint4(val, 1u, uint32_t(page), uint32_t(slot));
      break;                             // first step that matched wins
    }
  }
  if (lane == 0) out[q] = res;
}

template <bool kVec>
int launch(const void* planes, const void* pool, const void* queries,
           const void* pages, void* out, int64_t Q, int C, int W, int b,
           int64_t P, cudaStream_t stream) {
  const int64_t blocks = (Q + kWarpsPerBlock - 1) / kWarpsPerBlock;
  probe_bitserial_kernel<kVec><<<unsigned(blocks), kWarpsPerBlock * 32, 0,
                                 stream>>>(
      static_cast<const uint32_t*>(planes),
      static_cast<const uint32_t*>(pool),
      static_cast<const uint32_t*>(queries),
      static_cast<const int32_t*>(pages), static_cast<uint4*>(out), Q, C, W,
      b, P);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int probe_bitserial_launch(const void* planes, const void* pool,
                                      const void* queries, const void* pages,
                                      void* out, int64_t Q, int C, int W,
                                      int b, int64_t P, void* stream) {
  if (b <= 0 || b > kMaxBits || W <= 0) return int(cudaErrorInvalidValue);
  if (Q <= 0) return int(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vector_loads(planes, W)
             ? launch<true>(planes, pool, queries, pages, out, Q, C, W, b, P, s)
             : launch<false>(planes, pool, queries, pages, out, Q, C, W, b, P,
                             s);
}
