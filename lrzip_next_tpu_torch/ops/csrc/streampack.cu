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
// K6 (pack_plane_kernel): the same design on the int32 plane, ONE launch
// after one cudaMemsetAsync of its workspace.  Bound on the card: device
// memory.  The function reads each 4-byte plane element once and writes
// the whole cap-sized u16 stream (the kept words, then the zero tail) and
// the count: 6 * cap + 4 bytes at cap = m, 0.0376 ms at the 64 MiB
// chunk's 16384 x 1280 plane.  A tile is 16384 elements (64 KB; 1280
// tiles at the main shape), cut at 16-byte boundaries of the plane's
// address, the first one 0-3 elements early; a block takes its tile by
// ticket and
//   1. loads each lane's 64 elements as sixteen streaming 16-byte
//      vectors into registers (a warp's 2048 elements are contiguous;
//      elements read one by one only at an unaligned head or the tail)
//      and counts their flags (bit 16);
//   2. warp 0 publishes the tile's count and looks back for its offset;
//      the tile that holds element m - 1 writes the count;
//   3. each warp ranks its kept words, round by round, by four ballots
//      (one for each element of a lane's vector), and puts them, in
//      index order, into a shared run of u16 that starts at the output
//      offset's place in its 16-byte group (excl & 7 words);
//   4. the block writes its run clipped at cap with streaming 16-byte
//      stores, single words only in the two partial vectors at its ends.
// Tickets past the last tile zero the tail [min(count, cap), cap) in
// shares, as K3's do.  The variants measured and not kept are in PERF.md
// section 6.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

// Zero out[a, b) of a 16-byte aligned array of T: single elements at the
// unaligned ends, 16-byte stores between.  Called by every thread of a
// block of kThreads.
template <class T, int kThreads>
__device__ void zero_range(T* __restrict__ out, int64_t a, int64_t b) {
  constexpr int64_t kV = 16 / sizeof(T);   // elements a 16-byte store
  if (a >= b) return;
  const int64_t av = (a + kV - 1) & ~(kV - 1);
  const int64_t bv = b & ~(kV - 1);
  if (av >= bv) {
    for (int64_t i = a + threadIdx.x; i < b; i += kThreads) out[i] = 0;
    return;
  }
  for (int64_t i = a + threadIdx.x; i < av; i += kThreads) out[i] = 0;
  for (int64_t i = bv + threadIdx.x; i < b; i += kThreads) out[i] = 0;
  for (int64_t q = av / kV + threadIdx.x; q < bv / kV; q += kThreads)
    reinterpret_cast<uint4*>(out)[q] = make_uint4(0u, 0u, 0u, 0u);
}

// A ticket past the last of `tiles` tiles: share `tile - tiles` of the
// `zero_shares` shares of the zero tail [min(count, cap), cap), once the
// last tile's inclusive prefix (the count) is published in `desc`.  The
// tiles hold lower tickets, so their blocks are running.  Each share is
// a whole number of 16-byte vectors long.
template <class T, int kThreads>
__device__ void zero_share(T* __restrict__ out, unsigned long long* desc,
                           int tiles, int tile, int zero_shares,
                           int64_t cap, int* s_count) {
  constexpr int64_t kV = 16 / sizeof(T);
  if (threadIdx.x == 0) *s_count = lookback::wait_prefix(desc, tiles - 1);
  __syncthreads();
  const int64_t lo = *s_count < cap ? int64_t(*s_count) : cap;
  const int64_t share =
      ((cap - lo + zero_shares - 1) / zero_shares + kV - 1) & ~(kV - 1);
  const int64_t a = lo + (tile - tiles) * share;
  zero_range<T, kThreads>(out, a, a + share < cap ? a + share : cap);
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
  if (tile >= tiles) {
    zero_share<uint8_t, kThreads>(out, ws + 1, tiles, tile, zero_shares, cap,
                                  &s_excl);
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

// --- K6: one pass with a decoupled look-back -------------------------------

namespace k6 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16384;               // int32 elements a tile
constexpr int kSeg = kTile / kWarps;       // elements a warp
constexpr int kVecs = kSeg / 128;          // 16-byte vectors a lane
constexpr int64_t kZeroShare = 16384;      // tail words a zeroing ticket
constexpr int kMaxZeroShares = 256;
static_assert(kSeg % 128 == 0, "tile shape");

// The 4 elements from element e of p on; elements outside [0, m) read as
// 0 (no flag).  `p + e` is 16-byte aligned (the tiles are cut so), and a
// vector wholly inside [0, m) is one streaming 16-byte load; only the
// head and tail vectors are read element by element.
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ p,
                                      int64_t e, int64_t m) {
  if (e >= 0 && e + 4 <= m)
    return __ldcs(reinterpret_cast<const int4*>(p + e));
  int w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = (e + j >= 0 && e + j < m) ? p[e + j] : 0;
  return make_int4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ unsigned flag(int x) { return (x >> 16) & 1; }

__global__ void __launch_bounds__(kThreads)
pack_plane_kernel(const int32_t* __restrict__ plane, int64_t m, int head,
                  int tiles, int zero_shares, int64_t cap,
                  uint16_t* __restrict__ out, unsigned long long* ws,
                  int32_t* __restrict__ n_out) {
  __shared__ __align__(16) uint16_t s_out[kTile + 8];
  __shared__ int s_warp[kWarps];
  __shared__ int s_tile;
  __shared__ int s_excl;
  __shared__ int s_agg;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = lookback::take_ticket(ws, &s_tile);
  if (tile >= tiles) {
    zero_share<uint16_t, kThreads>(out, ws + 1, tiles, tile, zero_shares,
                                   cap, &s_excl);
    return;
  }
  // the warp's first element: tiles are cut at 16-byte boundaries of the
  // plane's address, the first one `head` elements early; vector h of a
  // lane holds elements seg + 128 h + 4 lane + [0, 4)
  const int64_t seg = int64_t(tile) * kTile - head + warp * kSeg;
  int4 v[kVecs];
  int cnt = 0;
#pragma unroll
  for (int h = 0; h < kVecs; ++h) {
    v[h] = load4(plane, seg + 128 * h + 4 * lane, m);
    cnt += flag(v[h].x) + flag(v[h].y) + flag(v[h].z) + flag(v[h].w);
  }
  const int wcnt = lookback::warp_sum(cnt);   // the warp's count
  if (lane == 0) s_warp[warp] = wcnt;
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
  // the run's first word sits at its output offset's place in a 16-byte
  // group of 8 words, so the run's 16-byte vectors are the output's
  const int shift = int(excl & 7);
  if (wcnt != 0) {          // warp-uniform
    const unsigned below = (1u << lane) - 1u;
    int o = shift + s_warp[warp];
#pragma unroll
    for (int h = 0; h < kVecs; ++h) {
      // the kept words of round h rank by lane, then by place in the lane
      const unsigned b0 = __ballot_sync(lookback::kFull, flag(v[h].x));
      const unsigned b1 = __ballot_sync(lookback::kFull, flag(v[h].y));
      const unsigned b2 = __ballot_sync(lookback::kFull, flag(v[h].z));
      const unsigned b3 = __ballot_sync(lookback::kFull, flag(v[h].w));
      int at = o + __popc(b0 & below) + __popc(b1 & below) +
               __popc(b2 & below) + __popc(b3 & below);
      if (flag(v[h].x)) s_out[at++] = uint16_t(v[h].x);
      if (flag(v[h].y)) s_out[at++] = uint16_t(v[h].y);
      if (flag(v[h].z)) s_out[at++] = uint16_t(v[h].z);
      if (flag(v[h].w)) s_out[at] = uint16_t(v[h].w);
      o += __popc(b0) + __popc(b1) + __popc(b2) + __popc(b3);
    }
  }
  __syncthreads();
  const int64_t lo = excl;
  const int64_t hi = excl + agg < cap ? excl + agg : cap;
  if (lo >= hi) return;
  const int64_t g0 = lo - shift;    // 16-byte aligned
  const int nvec = int((hi - g0 + 7) / 8);
  for (int q = threadIdx.x; q < nvec; q += kThreads) {
    const int64_t g = g0 + 8 * int64_t(q);
    if (g >= lo && g + 8 <= hi) {
      __stcs(reinterpret_cast<uint4*>(out + g),
             *reinterpret_cast<const uint4*>(s_out + 8 * q));
    } else {
      for (int j = 0; j < 8; ++j)
        if (g + j >= lo && g + j < hi) out[g + j] = s_out[8 * q + j];
    }
  }
}

}  // namespace k6

}  // namespace

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

// K6.  `plane` holds m int32 elements (4-byte aligned); `ws` holds
// `ws_slots` 8-byte slots, at least lrzt_pack_plane_slots(m); `out`
// (16-byte aligned) holds cap uint16 words; `n` is one int32 on the
// device.
extern "C" int lrzt_pack_plane(const void* plane, int64_t m, void* out,
                               int64_t cap, void* ws, int64_t ws_slots,
                               void* n, void* stream) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(plane);
  if (m <= 0 || m >= (int64_t(1) << 31) || cap < 0 || (p & 3u) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15u) != 0)
    return int(cudaErrorInvalidValue);
  const int head = int((p & 15u) >> 2);
  const int64_t tiles = (head + m + k6::kTile - 1) / k6::kTile;
  if (ws_slots < tiles + 1) return int(cudaErrorInvalidValue);
  int64_t shares = (cap + k6::kZeroShare - 1) / k6::kZeroShare;
  shares = shares < 1 ? 1 : shares > k6::kMaxZeroShares
                                ? k6::kMaxZeroShares : shares;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      ws, 0, size_t(tiles + 1) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return int(err);
  k6::pack_plane_kernel<<<dim3(unsigned(tiles + shares)), k6::kThreads, 0,
                          s>>>(
      static_cast<const int32_t*>(plane), m, head, int(tiles), int(shares),
      cap, static_cast<uint16_t*>(out), static_cast<unsigned long long*>(ws),
      static_cast<int32_t*>(n));
  return int(cudaGetLastError());
}

// Workspace slots a K6 call with 0 < m < 2**31 elements needs at any
// alignment: the ticket counter and one descriptor a tile.
extern "C" int lrzt_pack_plane_slots(int64_t m) {
  return int((m + 3 + k6::kTile - 1) / k6::kTile + 1);
}
