// K2 and K10: order-preserving compaction of three (K2) or two (K10) int32
// payloads at flagged positions, plus the count.  One source: the payload
// count is a template parameter of the scatter kernel, the count pass is
// shared.
//
// Replaces: lrzip_next_tpu/ops/compact_pallas.py : compact_starts3_pallas
// (kernel _compact_kernel3) and compact_starts_pallas (kernel
// _compact_kernel2).  out_x[r] = x[i] for the r-th set flag i, in index
// order, for x in (a, b, c) or (a, b).
//
// Bound on the card (NVIDIA H100 80GB HBM3 at a 700 W power limit):
// device memory.  Every element is read twice (the
// flag in the count pass, flag and payloads in the scatter pass) and only
// the kept elements are written: about 14 bytes per element plus 12 per
// kept one with three payloads (10 plus 8 with two), against a few
// integer operations.  The TPU design does not
// carry over: it routed elements with log-shift concats inside a tile and
// relied on its grid running IN ORDER, each tile's full window
// overwriting the previous tile's garbage tail.  GPU blocks run in no
// order, so this is the classic two-pass split instead:
//   1. lrzt_compact3_count: each block counts the flags of its TILE
//      elements (warp ballots + popc, one int32 per block);
//   2. the caller takes the exclusive scan of the block counts (a few
//      thousand values; torch.cumsum, as the JAX wrapper used jnp.cumsum);
//   3. lrzt_compact3_scatter: each block walks its TILE in kRounds rounds
//      of kThreads consecutive elements (coalesced loads), ranks the set
//      elements with a warp ballot and a shuffle scan over the warp
//      totals, and writes the payloads to offset[block] + rank.
// Writes land only at their final slots, so block order never matters.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;  // elements per block
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ flags, int64_t k,
             int32_t* __restrict__ counts) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = int64_t(blockIdx.x) * kTile;
  int total = 0;
#pragma unroll 4
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + int64_t(r) * kThreads + threadIdx.x;
    const bool f = i < k && flags[i] != 0;
    total += __popc(__ballot_sync(kFull, f));
  }
  if (lane == 0) s_warp[warp] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += s_warp[w];
    counts[blockIdx.x] = s;
  }
}

template <int kPayloads>
struct Payloads {
  const int32_t* in[kPayloads];
  int32_t* out[kPayloads];
};

template <int kPayloads>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint8_t* __restrict__ flags, Payloads<kPayloads> p,
               int64_t k, const int64_t* __restrict__ offsets) {
  __shared__ int s_pre[kWarps];
  __shared__ int s_tot;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = int64_t(blockIdx.x) * kTile;
  int64_t out = offsets[blockIdx.x];
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + int64_t(r) * kThreads + threadIdx.x;
    const bool f = i < k && flags[i] != 0;
    const unsigned ballot = __ballot_sync(kFull, f);
    const int lane_rank = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) s_pre[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      // exclusive scan of the kWarps warp totals by shuffles
      const int v = lane < kWarps ? s_pre[lane] : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < kWarps; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane < kWarps) s_pre[lane] = incl - v;
      if (lane == kWarps - 1) s_tot = incl;
    }
    __syncthreads();
    if (f) {
      const int64_t o = out + s_pre[warp] + lane_rank;
#pragma unroll
      for (int q = 0; q < kPayloads; ++q) p.out[q][o] = __ldg(p.in[q] + i);
    }
    out += s_tot;
    __syncthreads();  // s_pre / s_tot are rewritten next round
  }
}

template <int kPayloads>
int launch_scatter(const void* flags, const void* const (&in)[kPayloads],
                   void* const (&out)[kPayloads], int64_t k,
                   const void* offsets, void* stream) {
  if (k <= 0) return int(cudaErrorInvalidValue);
  Payloads<kPayloads> p;
  for (int q = 0; q < kPayloads; ++q) {
    p.in[q] = static_cast<const int32_t*>(in[q]);
    p.out[q] = static_cast<int32_t*>(out[q]);
  }
  const int64_t blocks = (k + kTile - 1) / kTile;
  scatter_kernel<kPayloads><<<dim3(unsigned(blocks)), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flags), p, k,
      static_cast<const int64_t*>(offsets));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int lrzt_compact3_count(const void* flags, int64_t k,
                                   void* counts, void* stream) {
  if (k <= 0) return int(cudaErrorInvalidValue);
  const int64_t blocks = (k + kTile - 1) / kTile;
  count_kernel<<<dim3(unsigned(blocks)), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flags), k, static_cast<int32_t*>(counts));
  return int(cudaGetLastError());
}

extern "C" int lrzt_compact3_scatter(const void* flags, const void* a,
                                     const void* b, const void* c,
                                     int64_t k, const void* offsets,
                                     void* out_a, void* out_b, void* out_c,
                                     void* stream) {
  const void* const in[3] = {a, b, c};
  void* const out[3] = {out_a, out_b, out_c};
  return launch_scatter<3>(flags, in, out, k, offsets, stream);
}

// K10: the same scatter with two payloads (its count pass is
// lrzt_compact3_count: the flags alone are counted).
extern "C" int lrzt_compact2_scatter(const void* flags, const void* a,
                                     const void* b, int64_t k,
                                     const void* offsets, void* out_a,
                                     void* out_b, void* stream) {
  const void* const in[2] = {a, b};
  void* const out[2] = {out_a, out_b};
  return launch_scatter<2>(flags, in, out, k, offsets, stream);
}

extern "C" int lrzt_compact3_tile() { return kTile; }
