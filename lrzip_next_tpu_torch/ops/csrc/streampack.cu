// K3 and K6: order-preserving stream compaction of the literal coder.
//
// Replaces: lrzip_next_tpu/ops/streampack.py : pack_stream_pallas (K3,
// kernel _pack_kernel; the chunk bytes under the literal mask -> the dense
// literal block) and pack_plane_pallas (K6, kernel _pack_fused_kernel;
// the flagged words of the rANS encoder's fused word | flag << 16 plane
// -> the u16 wire stream).  out[r] = value(i) for the r-th flagged
// element i, in index order, for r < cap; everything past the count is
// 0 (the padding reaches the rANS planes); the count counts every flag.
//
// The TPU kernels packed each tile to its front with log-shift routing,
// then placed the tiles IN ORDER with a sequential scan of dynamic
// update slices, each tile's garbage tail overwritten by the next tile.
// GPU blocks run in no order, so each kernel here finds a tile's output
// offset another way.
//
// K3 (pack_bytes_kernel): ONE launch, after one cudaMemsetAsync of a
// small per-call workspace, with a decoupled look-back (lookback.cuh, the
// design of K2 and K10 in compact3.cu).  Bound on the card (NVIDIA H100
// 80GB HBM3 at a 700 W power limit): device memory.  The function reads
// each flag once, the value bytes only in the 32-byte sectors that hold a
// set flag (literal spans are runs, so most 16-byte groups are all-set or
// all-clear), and writes the cap-sized block and the count; a few integer
// operations per element.  The two-pass kernel it replaces read the mask
// twice, read flag and value one byte a thread and met three block
// barriers a round of 256 elements (0.27 ms of device time on the 64 MiB
// chunk), and needed a zeroed output, a torch.cumsum and a count
// conversion between its passes.  A tile is 8192 elements, cut at 16-byte
// boundaries of the flags' address; a block takes its tile by ticket and
//   1. loads each thread's 32 flags as two 16-byte vectors into shared
//      memory, counts them, and loads the 16-byte value vector of each
//      group that holds a set flag (byte by byte where the values' address
//      is not aligned like the flags'; flags and values read byte by byte
//      only at an unaligned head or the tail);
//   2. warp 0 publishes the tile's count and looks back for its offset;
//      the tile that holds element m - 1 writes the count;
//   3. each warp ranks its 1024 flags in batches of 8 rounds of one
//      ballot and puts the kept bytes, in order, into a shared run that
//      starts at the output offset's place in its 16-byte group;
//   4. the block writes its run [offset, offset + count) clipped at cap
//      with coalesced 16-byte stores, bytes only in the two partial
//      vectors at its ends.
// One block a ticket; the launch has a few blocks more than tiles, and a
// ticket past the last tile is a share of the zero tail: it waits for the
// last tile's inclusive prefix (the count) and zeroes its share of
// [min(count, cap), cap).  The tiles it waits for hold lower tickets, so
// their blocks are running.  What holds the kernel back, measured on an
// H100 at the 64 MiB chunk's 8192 tiles: a floor of about 0.06 ms that
// an all-clear mask takes too (0.02 ms of flag bytes), the blocks' chain
// of ticket, loads, look-back and barriers.  Tiles of 16384, a block
// that keeps taking tickets and loads the next tile's flags ahead, and a
// look-back that reads 256 predecessors a round did not lower it.
//
// K6 (count_kernel, scatter_kernel over FusedPlane): still two passes
// (count, torch.cumsum over the block counts, scatter).  Bound: device
// memory; it reads the 4-byte plane element twice and writes 2 bytes per
// flagged word.
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

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;  // elements per block
constexpr unsigned kFull = 0xFFFFFFFFu;

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

// --- K3: one pass with a decoupled look-back -------------------------------

namespace k3 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8192;                // elements a tile
constexpr int kSeg = kTile / kWarps;       // elements a warp
constexpr int kVecs = kSeg / 512;          // 16-byte flag vectors a lane
constexpr int kRounds = kSeg / 32;         // ballot rounds a warp
constexpr int kBatch = 8;                  // rounds whose loads overlap
constexpr int64_t kZeroShare = 32768;      // tail bytes a zeroing ticket
constexpr int kMaxZeroShares = 256;
static_assert(kSeg % 512 == 0 && kRounds % kBatch == 0, "tile shape");

// Zero out[a, b): bytes at the unaligned ends, 16-byte stores between
// (`out` is 16-byte aligned).
__device__ void zero_range(uint8_t* __restrict__ out, int64_t a, int64_t b) {
  if (a >= b) return;
  const int64_t a16 = (a + 15) & ~int64_t(15);
  const int64_t b16 = b & ~int64_t(15);
  if (a16 >= b16) {
    for (int64_t i = a + threadIdx.x; i < b; i += kThreads) out[i] = 0;
    return;
  }
  for (int64_t i = a + threadIdx.x; i < a16; i += kThreads) out[i] = 0;
  for (int64_t i = b16 + threadIdx.x; i < b; i += kThreads) out[i] = 0;
  for (int64_t q = a16 / 16 + threadIdx.x; q < b16 / 16; q += kThreads)
    reinterpret_cast<uint4*>(out)[q] = make_uint4(0u, 0u, 0u, 0u);
}

__global__ void __launch_bounds__(kThreads)
pack_bytes_kernel(const uint8_t* __restrict__ vals,
                  const uint8_t* __restrict__ flags, int64_t m, int head,
                  bool vals_aligned, int tiles, int zero_shares, int64_t cap,
                  uint8_t* __restrict__ out, unsigned long long* ws,
                  int32_t* __restrict__ n_out) {
  __shared__ __align__(16) uint8_t s_flags[kTile];
  __shared__ __align__(16) uint8_t s_vals[kTile];
  __shared__ __align__(16) uint8_t s_out[kTile + 16];
  __shared__ int s_warp[kWarps];
  __shared__ int s_tile;
  __shared__ int s_excl;
  __shared__ int s_agg;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = lookback::take_ticket(ws, &s_tile);
  if (tile >= tiles) {   // a share of the zero tail [min(count, cap), cap)
    if (threadIdx.x == 0) s_excl = lookback::wait_prefix(ws + 1, tiles - 1);
    __syncthreads();
    const int64_t lo = s_excl < cap ? int64_t(s_excl) : cap;
    const int64_t share = ((cap - lo + zero_shares - 1) / zero_shares + 15) &
                          ~int64_t(15);
    const int64_t a = lo + (tile - tiles) * share;
    zero_range(out, a, a + share < cap ? a + share : cap);
    return;
  }
  // element index of the tile's first flag: tiles are cut at 16-byte
  // boundaries of the flags' address, the first one `head` bytes early
  const int64_t base = int64_t(tile) * kTile - head;
  int cnt = 0;
#pragma unroll
  for (int h = 0; h < kVecs; ++h) {
    const int local = warp * kSeg + h * 512 + lane * 16;
    const uint4 f = lookback::load16(flags, base + local, m);
    *reinterpret_cast<uint4*>(s_flags + local) = f;
    const int c = lookback::count16(f);
    if (c != 0)
      *reinterpret_cast<uint4*>(s_vals + local) =
          lookback::load16(vals, base + local, m, vals_aligned);
    cnt += c;
  }
  cnt = lookback::warp_sum(cnt);   // the warp's count, in every lane
  if (lane == 0) s_warp[warp] = cnt;
  __syncthreads();
  if (warp == 0) {
    const int agg = lookback::warp_offsets<kWarps>(
        lane < kWarps ? s_warp[lane] : 0, s_warp);
    const int excl = lookback::look_back(ws + 1, tile, agg);
    if (lane == 0) {
      s_excl = excl;
      s_agg = agg;
      if (tile == tiles - 1) *n_out = excl + agg;
    }
  }
  __syncthreads();
  const int64_t excl = s_excl;
  const int agg = s_agg;
  // the run's first byte sits at its output offset's place in a 16-byte
  // group, so the run's 16-byte vectors are the output's
  const int shift = int(excl & 15);
  if (cnt != 0) {
    int o = shift + s_warp[warp];
    const unsigned below = (1u << lane) - 1u;
    int done = 0;
    for (int r0 = 0; r0 < kRounds && done < cnt; r0 += kBatch) {
      // the batch's flags and values first, its stores after (a value
      // byte read where no flag is set is never stored)
      unsigned ballot[kBatch];
      uint8_t v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int local = warp * kSeg + (r0 + u) * 32 + lane;
        ballot[u] = __ballot_sync(lookback::kFull, s_flags[local] != 0);
        v[u] = s_vals[local];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if ((ballot[u] >> lane) & 1u)
          s_out[o + __popc(ballot[u] & below)] = v[u];
        o += __popc(ballot[u]);
        done += __popc(ballot[u]);
      }
    }
  }
  __syncthreads();
  const int64_t lo = excl;
  const int64_t hi = excl + agg < cap ? excl + agg : cap;
  if (lo >= hi) return;
  const int64_t g0 = lo - shift;    // 16-byte aligned
  const int nvec = int((hi - g0 + 15) / 16);
  for (int q = threadIdx.x; q < nvec; q += kThreads) {
    const int64_t g = g0 + 16 * int64_t(q);
    if (g >= lo && g + 16 <= hi) {
      *reinterpret_cast<uint4*>(out + g) =
          *reinterpret_cast<const uint4*>(s_out + 16 * q);
    } else {
      for (int j = 0; j < 16; ++j)
        if (g + j >= lo && g + j < hi) out[g + j] = s_out[16 * q + j];
    }
  }
}

}  // namespace k3

}  // namespace

extern "C" int lrzt_pack_tile() { return kTile; }

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

// K3.  `ws` holds `ws_slots` 8-byte slots, at least lrzt_pack_bytes_slots(m);
// `out` (16-byte aligned) holds cap bytes; `n` is one int32 on the device.
extern "C" int lrzt_pack_bytes(const void* vals, const void* flags,
                               int64_t m, void* out, int64_t cap, void* ws,
                               int64_t ws_slots, void* n, void* stream) {
  if (m <= 0 || m >= (int64_t(1) << 31) || cap < 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15u) != 0)
    return int(cudaErrorInvalidValue);
  const uintptr_t f = reinterpret_cast<uintptr_t>(flags);
  const int head = int(f & 15u);
  const bool vals_aligned =
      ((reinterpret_cast<uintptr_t>(vals) ^ f) & 15u) == 0;
  const int64_t tiles = (head + m + k3::kTile - 1) / k3::kTile;
  if (ws_slots < tiles + 1) return int(cudaErrorInvalidValue);
  int64_t shares = (cap + k3::kZeroShare - 1) / k3::kZeroShare;
  shares = shares < 1 ? 1 : shares > k3::kMaxZeroShares
                                ? k3::kMaxZeroShares : shares;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      ws, 0, size_t(tiles + 1) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return int(err);
  k3::pack_bytes_kernel<<<dim3(unsigned(tiles + shares)), k3::kThreads, 0,
                          s>>>(
      static_cast<const uint8_t*>(vals), static_cast<const uint8_t*>(flags),
      m, head, vals_aligned, int(tiles), int(shares), cap,
      static_cast<uint8_t*>(out), static_cast<unsigned long long*>(ws),
      static_cast<int32_t*>(n));
  return int(cudaGetLastError());
}

// Workspace slots a K3 call with 0 < m < 2**31 elements needs at any
// alignment: the ticket counter and one descriptor a tile.
extern "C" int lrzt_pack_bytes_slots(int64_t m) {
  return int((m + 15 + k3::kTile - 1) / k3::kTile + 1);
}
