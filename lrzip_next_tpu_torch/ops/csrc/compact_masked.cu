// K9: order-preserving compaction under two masks, plus both counts.
//
// Replaces: lrzip_next_tpu/ops/compact_pallas.py : compact_masked_pallas
// (kernel _compact_kernel).  out_s[r] = pos[i] and out_c[r] = cand[i] for
// the r-th set start flag i, out_e[r] = pos[j] for the r-th set end flag
// j, each stream in index order.  The dense stride-1 matcher hands it the
// run masks of its candidate chains: runs cannot nest, so the k-th start
// pairs with the k-th end, and the kernel only has to keep index order in
// each stream.
//
// Bound on the card (NVIDIA H100 80GB HBM3 at a 700 W power limit):
// device memory.  Both flags are read twice (count pass, scatter pass),
// both payloads once, and only the kept elements are written: about 12
// bytes per element plus 12 per run, against a few integer operations.
// The TPU design does not carry over: it routed each mask's elements by
// log-shift concats inside a 16384-element tile, relied on its grid
// running IN ORDER so that each tile's full window overwrote the
// previous tile's garbage tail, and merged the tiles with a cap-sized
// gather.  GPU blocks run in no order, so this is the two-pass split of
// compact3.cu with two ranks a block:
//   1. lrzt_compact_masked_count: each block counts the start flags and
//      the end flags of its TILE elements (warp ballots + popc) and
//      writes counts[block] and counts[blocks + block];
//   2. the caller takes the exclusive scan of each row of block counts
//      (torch.cumsum over a (2, blocks) tensor);
//   3. lrzt_compact_masked_scatter: each block walks its TILE in kRounds
//      rounds of kThreads consecutive elements (coalesced loads), ranks
//      the set elements of each mask with a warp ballot and a shuffle
//      scan over the warp totals (warp 0 scans the starts, warp 1 the
//      ends), and writes pos and cand at the start rank and pos at the
//      end rank.
// Writes land only at their final slots, so block order never matters,
// and a block whose ends close runs that started in an earlier block
// needs nothing from that block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;  // elements per block
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
masked_count_kernel(const uint8_t* __restrict__ start,
                    const uint8_t* __restrict__ is_end, int64_t m,
                    int32_t* __restrict__ counts) {
  __shared__ int s_warp[2][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = int64_t(blockIdx.x) * kTile;
  int total_s = 0, total_e = 0;
#pragma unroll 4
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + int64_t(r) * kThreads + threadIdx.x;
    const bool in = i < m;
    const bool fs = in && start[i] != 0;
    const bool fe = in && is_end[i] != 0;
    total_s += __popc(__ballot_sync(kFull, fs));
    total_e += __popc(__ballot_sync(kFull, fe));
  }
  if (lane == 0) {
    s_warp[0][warp] = total_s;
    s_warp[1][warp] = total_e;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += s_warp[threadIdx.x][w];
    counts[int64_t(threadIdx.x) * gridDim.x + blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
masked_scatter_kernel(const uint8_t* __restrict__ start,
                      const uint8_t* __restrict__ is_end,
                      const int32_t* __restrict__ pos,
                      const int32_t* __restrict__ cand, int64_t m,
                      const int64_t* __restrict__ offsets,
                      int32_t* __restrict__ out_s,
                      int32_t* __restrict__ out_e,
                      int32_t* __restrict__ out_c) {
  __shared__ int s_pre[2][kWarps];
  __shared__ int s_tot[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = int64_t(blockIdx.x) * kTile;
  int64_t o_s = offsets[blockIdx.x];
  int64_t o_e = offsets[int64_t(gridDim.x) + blockIdx.x];
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + int64_t(r) * kThreads + threadIdx.x;
    const bool in = i < m;
    const bool fs = in && start[i] != 0;
    const bool fe = in && is_end[i] != 0;
    const unsigned bs = __ballot_sync(kFull, fs);
    const unsigned be = __ballot_sync(kFull, fe);
    const unsigned below = (1u << lane) - 1u;
    if (lane == 0) {
      s_pre[0][warp] = __popc(bs);
      s_pre[1][warp] = __popc(be);
    }
    __syncthreads();
    if (warp < 2) {
      // exclusive scan of one mask's kWarps warp totals by shuffles
      const int v = lane < kWarps ? s_pre[warp][lane] : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < kWarps; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane < kWarps) s_pre[warp][lane] = incl - v;
      if (lane == kWarps - 1) s_tot[warp] = incl;
    }
    __syncthreads();
    if (fs || fe) {
      const int32_t p = pos[i];
      if (fs) {
        const int64_t o = o_s + s_pre[0][warp] + __popc(bs & below);
        out_s[o] = p;
        out_c[o] = cand[i];
      }
      if (fe) out_e[o_e + s_pre[1][warp] + __popc(be & below)] = p;
    }
    o_s += s_tot[0];
    o_e += s_tot[1];
    __syncthreads();  // s_pre / s_tot are rewritten next round
  }
}

}  // namespace

extern "C" int lrzt_compact_masked_count(const void* start,
                                         const void* is_end, int64_t m,
                                         void* counts, void* stream) {
  if (m <= 0) return int(cudaErrorInvalidValue);
  const int64_t blocks = (m + kTile - 1) / kTile;
  masked_count_kernel<<<dim3(unsigned(blocks)), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(start),
      static_cast<const uint8_t*>(is_end), m,
      static_cast<int32_t*>(counts));
  return int(cudaGetLastError());
}

extern "C" int lrzt_compact_masked_scatter(
    const void* start, const void* is_end, const void* pos,
    const void* cand, int64_t m, const void* offsets, void* out_s,
    void* out_e, void* out_c, void* stream) {
  if (m <= 0) return int(cudaErrorInvalidValue);
  const int64_t blocks = (m + kTile - 1) / kTile;
  masked_scatter_kernel<<<dim3(unsigned(blocks)), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(start),
      static_cast<const uint8_t*>(is_end),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(cand),
      m, static_cast<const int64_t*>(offsets), static_cast<int32_t*>(out_s),
      static_cast<int32_t*>(out_e), static_cast<int32_t*>(out_c));
  return int(cudaGetLastError());
}

extern "C" int lrzt_compact_masked_tile() { return kTile; }
