// The decoupled look-back shared by the one-pass compactions: K2 and K10
// (compact3.cu), K3 and K6 (streampack.cu), K9 (compact_masked.cu),
// which carries two counts a tile (look_back_pair), and K11
// (gear_anchors.cu).
//
// A one-pass compaction cuts its input into tiles, one block a tile, and
// each block finds its tile's output offset itself (Merrill and Garland's
// single-pass scan): GPU blocks run in no order, so
//   - a block takes its tile index as a ticket, from an atomicAdd on the
//     first slot of a workspace that the launch zeroed by one
//     cudaMemsetAsync on its stream: a block then waits only on tiles with
//     lower tickets, whose blocks are already running, so the look-back
//     always makes progress, whatever order the blocks start in;
//   - each tile has one 64-bit descriptor in the workspace, status in the
//     high word (0 unset, kAggregate, kPrefix) and value in the low word,
//     written in one aligned 64-bit store, so no reader sees a status with
//     a stale value.  No other block reads anything else a block writes,
//     so the store needs no fence before it;
//   - warp 0 publishes the tile's aggregate, reads the descriptors of up
//     to 32 predecessors at a time, sums aggregates back to the nearest
//     inclusive prefix, and publishes its own inclusive prefix.
// A wait that never ends is a fault of the caller (a workspace not zeroed,
// a ticket lost): after about 2^24 polls it traps, a launch error, rather
// than hanging the card.
//
// The tiles are cut at 16-byte boundaries of the flags' address, so every
// flag vector that lies inside [0, k) is an aligned 16-byte load; load16
// reads the head and tail vectors that are not wholly inside byte by byte.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lookback {

constexpr unsigned kFull = 0xFFFFFFFFu;
// descriptor: status in the high word (0 unset), value in the low word
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

// The number of nonzero bytes of w.
__device__ __forceinline__ int nonzero_bytes(unsigned w) {
  // bit 7 of a byte of t is set iff that byte of w is nonzero
  const unsigned t = ((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w;
  return __popc(t & 0x80808080u);
}

// The 16 bytes from element e of p on; bytes outside [0, k) read as 0.
// `p + e` is 16-byte aligned whenever the caller says so (`aligned`); an
// aligned vector wholly inside [0, k) is one 16-byte load, any other is
// read byte by byte, so no read leaves [0, k).
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ p,
                                        int64_t e, int64_t k,
                                        bool aligned = true) {
  if (aligned && e >= 0 && e + 16 <= k)
    return __ldg(reinterpret_cast<const uint4*>(p + e));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int64_t i = e + j;
    if (i >= 0 && i < k) w[j >> 2] |= unsigned(p[i]) << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ int count16(uint4 v) {
  return nonzero_bytes(v.x) + nonzero_bytes(v.y) + nonzero_bytes(v.z) +
         nonzero_bytes(v.w);
}

__device__ __forceinline__ void publish(unsigned long long* d,
                                        unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(d) = v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The ticket: thread 0 takes it from ws[0]; every thread returns it.
// Must be called by all threads of the block.
__device__ __forceinline__ int take_ticket(unsigned long long* ws,
                                           int* s_slot) {
  if (threadIdx.x == 0) *s_slot = int(atomicAdd(ws, 1ull));
  __syncthreads();
  return *s_slot;
}

// Warp 0: the tile's exclusive prefix, with the aggregate published
// first and the inclusive prefix after.  `desc` holds one descriptor a
// tile.
__device__ inline int look_back(unsigned long long* desc, int tile, int agg) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) publish(desc, kPrefix | unsigned(agg));
    return 0;
  }
  if (lane == 0) publish(desc + tile, kAggregate | unsigned(agg));
  int excl = 0;
  for (int pred = tile - 1;; pred -= 32) {
    const int j = pred - lane;   // lane 0 the nearest predecessor
    unsigned long long d = kPrefix;  // before tile 0: a prefix of 0
    for (unsigned polls = 0;; ++polls) {
      if (j >= 0)
        d = *reinterpret_cast<volatile unsigned long long*>(desc + j);
      if (!__any_sync(kFull, (d >> 32) == 0)) break;
      if (polls == (1u << 24)) __trap();
      __nanosleep(64);
    }
    const unsigned prefixes = __ballot_sync(kFull, (d >> 32) == 2);
    const int v = int(unsigned(d));
    if (prefixes) {
      const int first = __ffs(prefixes) - 1;
      excl += warp_sum(lane <= first ? v : 0);
      break;
    }
    excl += warp_sum(v);
  }
  if (lane == 0) publish(desc + tile, kPrefix | unsigned(excl + agg));
  return excl;
}

// Warp 0, lanes < kWarps hold their warp's count in `v`: the exclusive
// offsets of the warps in the tile go to s_warp, the tile's aggregate is
// returned in every lane.  T is int, or unsigned for K9's two counts
// packed in one word (the high one may reach bit 31).
template <int kWarps, class T>
__device__ __forceinline__ T warp_offsets(T v, T* s_warp) {
  const int lane = threadIdx.x & 31;
  T incl = v;
#pragma unroll
  for (int o = 1; o < kWarps; o <<= 1) {
    const T y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane < kWarps) s_warp[lane] = incl - v;
  return __shfl_sync(kFull, incl, kWarps - 1);
}

// Two counts a tile (K9: the set flags of two masks) in one descriptor,
// written by one aligned 64-bit store as the one-count descriptor is:
// status in the top 2 bits (0 unset, 1 aggregate, 2 inclusive prefix), the
// second count in bits 31-61, the first in bits 0-30.  So no reader sees
// a status with a stale count of either kind, and with fewer than 2^31
// elements two values add field by field without a carry: each field's
// sum is at most the element count.
constexpr int kPairShift = 31;
constexpr unsigned long long kPairCount = (1ull << kPairShift) - 1;
constexpr unsigned long long kPairValue = (1ull << 62) - 1;
constexpr unsigned long long kPairAggregate = 1ull << 62;
constexpr unsigned long long kPairPrefix = 2ull << 62;

__device__ __forceinline__ unsigned long long pair(int first, int second) {
  return (unsigned long long)unsigned(first) |
         (unsigned long long)unsigned(second) << kPairShift;
}

__device__ __forceinline__ unsigned long long warp_sum_pair(
    unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// look_back with a pair of counts a tile: warp 0 publishes the tile's
// aggregate `agg` (a pair), sums its predecessors' values back to the
// nearest inclusive prefix, publishes its own and returns the exclusive
// pair.  Traps as look_back does.
__device__ inline unsigned long long look_back_pair(unsigned long long* desc,
                                                    int tile,
                                                    unsigned long long agg) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) publish(desc, kPairPrefix | agg);
    return 0;
  }
  if (lane == 0) publish(desc + tile, kPairAggregate | agg);
  unsigned long long excl = 0;
  for (int pred = tile - 1;; pred -= 32) {
    const int j = pred - lane;   // lane 0 the nearest predecessor
    unsigned long long d = kPairPrefix;  // before tile 0: a prefix of 0
    for (unsigned polls = 0;; ++polls) {
      if (j >= 0)
        d = *reinterpret_cast<volatile unsigned long long*>(desc + j);
      if (!__any_sync(kFull, (d >> 62) == 0)) break;
      if (polls == (1u << 24)) __trap();
      __nanosleep(64);
    }
    const unsigned prefixes = __ballot_sync(kFull, (d >> 62) == 2);
    const unsigned long long v = d & kPairValue;
    if (prefixes) {
      const int first = __ffs(prefixes) - 1;
      excl += warp_sum_pair(lane <= first ? v : 0ull);
      break;
    }
    excl += warp_sum_pair(v);
  }
  if (lane == 0) publish(desc + tile, kPairPrefix | (excl + agg));
  return excl;
}

// Spin until tile `tile`'s descriptor holds an inclusive prefix; returns
// it.  For blocks whose tickets come after every tile's (so the tile's
// block is running).  Traps as look_back does.
__device__ __forceinline__ int wait_prefix(unsigned long long* desc,
                                           int tile) {
  for (unsigned polls = 0;; ++polls) {
    const unsigned long long d =
        *reinterpret_cast<volatile unsigned long long*>(desc + tile);
    if ((d >> 32) == 2) return int(unsigned(d));
    if (polls == (1u << 24)) __trap();
    __nanosleep(64);
  }
}

}  // namespace lookback
