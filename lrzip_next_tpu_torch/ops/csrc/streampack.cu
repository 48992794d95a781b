// K3 and K6: order-preserving stream compaction of the literal coder.
//
// Replaces: lrzip_next_tpu/ops/streampack.py : pack_stream_pallas (K3,
// kernel _pack_kernel; the chunk bytes under the literal mask -> the dense
// literal block) and pack_plane_pallas (K6, kernel _pack_fused_kernel;
// the flagged words of the rANS encoder's fused word | flag << 16 plane
// -> the u16 wire stream).  out[r] = value(i) for the r-th flagged
// element i, in index order, for r < cap; the caller zeroes `out`, so
// everything past the count stays 0.
//
// Bound on the card (NVIDIA H100 80GB HBM3 at a 700 W power limit):
// device memory.  K3 reads 2 bytes per chunk byte (flag in the count
// pass, flag and value in the scatter pass, the flag twice) and writes
// one per literal; K6 reads the 4-byte plane element twice and writes 2
// bytes per flagged word.  A few integer operations per element.
//
// The TPU kernels packed each tile to its front with log-shift routing,
// then placed the tiles IN ORDER with a sequential scan of dynamic
// update slices, each tile's garbage tail overwritten by the next tile.
// GPU blocks run in no order, so this is the two-pass split of K2
// (compact3.cu), one template for both element types:
//   1. count: each block counts the flags of its kTile elements (warp
//      ballots + popc), one int32 per block;
//   2. the caller takes the exclusive scan of the block counts
//      (torch.cumsum);
//   3. scatter: each block walks its tile in kRounds rounds of kThreads
//      consecutive elements, ranks the flagged ones by a warp ballot and
//      a shuffle scan of the warp totals, and writes each value to its
//      final slot offset[block] + rank.  No write depends on block order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;  // elements per block
constexpr unsigned kFull = 0xFFFFFFFFu;

// K3's source: a byte and its flag from two arrays.
struct MaskedBytes {
  using Out = uint8_t;
  const uint8_t* vals;
  const uint8_t* flags;
  __device__ bool flag(int64_t i) const { return flags[i] != 0; }
  __device__ bool load(int64_t i, Out* v) const {
    const bool f = flags[i] != 0;
    if (f) *v = vals[i];
    return f;
  }
};

// K6's source: word and flag fused in one int32 element.
struct FusedPlane {
  using Out = uint16_t;
  const int32_t* plane;
  __device__ bool flag(int64_t i) const { return (plane[i] >> 16) & 1; }
  __device__ bool load(int64_t i, Out* v) const {
    const int32_t p = plane[i];
    *v = static_cast<uint16_t>(p & 0xFFFF);
    return (p >> 16) & 1;
  }
};

template <class Src>
__global__ void __launch_bounds__(kThreads)
count_kernel(Src src, int64_t m, int32_t* __restrict__ counts) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = int64_t(blockIdx.x) * kTile;
  int total = 0;
#pragma unroll 4
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + int64_t(r) * kThreads + threadIdx.x;
    const bool f = i < m && src.flag(i);
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

template <class Src>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(Src src, int64_t m, const int64_t* __restrict__ offsets,
               typename Src::Out* __restrict__ out, int64_t cap) {
  __shared__ int s_pre[kWarps];
  __shared__ int s_tot;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = int64_t(blockIdx.x) * kTile;
  int64_t at = offsets[blockIdx.x];
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + int64_t(r) * kThreads + threadIdx.x;
    typename Src::Out v = 0;
    const bool f = i < m && src.load(i, &v);
    const unsigned ballot = __ballot_sync(kFull, f);
    const int lane_rank = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) s_pre[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      // exclusive scan of the kWarps warp totals by shuffles
      const int x = lane < kWarps ? s_pre[lane] : 0;
      int incl = x;
#pragma unroll
      for (int o = 1; o < kWarps; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane < kWarps) s_pre[lane] = incl - x;
      if (lane == kWarps - 1) s_tot = incl;
    }
    __syncthreads();
    if (f) {
      const int64_t o = at + s_pre[warp] + lane_rank;
      if (o < cap) out[o] = v;
    }
    at += s_tot;
    __syncthreads();  // s_pre / s_tot are rewritten next round
  }
}

inline unsigned blocks_for(int64_t m) {
  return unsigned((m + kTile - 1) / kTile);
}

}  // namespace

extern "C" int lrzt_pack_tile() { return kTile; }

extern "C" int lrzt_pack_bytes_count(const void* flags, int64_t m,
                                     void* counts, void* stream) {
  if (m <= 0) return int(cudaErrorInvalidValue);
  const MaskedBytes src{nullptr, static_cast<const uint8_t*>(flags)};
  count_kernel<<<blocks_for(m), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      src, m, static_cast<int32_t*>(counts));
  return int(cudaGetLastError());
}

extern "C" int lrzt_pack_bytes_scatter(const void* vals, const void* flags,
                                       int64_t m, const void* offsets,
                                       void* out, int64_t cap,
                                       void* stream) {
  if (m <= 0) return int(cudaErrorInvalidValue);
  const MaskedBytes src{static_cast<const uint8_t*>(vals),
                        static_cast<const uint8_t*>(flags)};
  scatter_kernel<<<blocks_for(m), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      src, m, static_cast<const int64_t*>(offsets),
      static_cast<uint8_t*>(out), cap);
  return int(cudaGetLastError());
}

extern "C" int lrzt_pack_plane_count(const void* plane, int64_t m,
                                     void* counts, void* stream) {
  if (m <= 0) return int(cudaErrorInvalidValue);
  const FusedPlane src{static_cast<const int32_t*>(plane)};
  count_kernel<<<blocks_for(m), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      src, m, static_cast<int32_t*>(counts));
  return int(cudaGetLastError());
}

extern "C" int lrzt_pack_plane_scatter(const void* plane, int64_t m,
                                       const void* offsets, void* out,
                                       int64_t cap, void* stream) {
  if (m <= 0) return int(cudaErrorInvalidValue);
  const FusedPlane src{static_cast<const int32_t*>(plane)};
  scatter_kernel<<<blocks_for(m), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      src, m, static_cast<const int64_t*>(offsets),
      static_cast<uint16_t*>(out), cap);
  return int(cudaGetLastError());
}
