// K9: order-preserving compaction under two masks, plus the count of the
// first, in ONE launch: a single-pass compaction with a decoupled
// look-back (Merrill and Garland's scan; the ticket, load16 and the
// two-count look-back are lookback.cuh's) that carries two ranks a tile.
//
// Replaces: lrzip_next_tpu/ops/compact_pallas.py : compact_masked_pallas
// (kernel _compact_kernel).  out_s[r] = pos[i] and out_c[r] = cand[i] for
// the r-th set start flag i, out_e[r] = pos[j] for the r-th set end flag
// j, each stream in index order; *n = the number of set start flags.  The
// masks are general: nothing here assumes that they pair.  (The dense
// stride-1 matcher's run masks do, since runs cannot nest, so its k-th
// start pairs with its k-th end.)
//
// Bound on the card (NVIDIA H100 80GB HBM3 at a 700 W power limit):
// device memory.  The function reads each flag of both masks once, pos
// only in the 32-byte sectors that hold a set start or end flag, cand only
// in those that hold a set start flag, and writes the kept elements and
// the count: on the run masks of the 64 MiB dense chunk (about 2% of each
// mask set) 225 MB, 0.067 ms at 3.35 TB/s, against a few integer
// operations per element.  The TPU design does not carry over: it routed
// each mask's elements by log-shift concats inside a 16384-element tile,
// relied on its grid running IN ORDER so that each tile's full window
// overwrote the previous tile's garbage tail, and merged the tiles with a
// cap-sized gather.  GPU blocks run in no order, so each block works out
// both of its tile's output offsets itself:
//   1. ticket: thread 0 takes the tile index from an atomicAdd on the
//      zeroed workspace's counter, so a block waits only on tiles with
//      lower tickets, whose blocks are already running;
//   2. load and count, each mask read once: a tile is kTile elements, cut
//      at 16-byte boundaries of start's address (the first tile `head`
//      bytes early), and each lane owns kLane consecutive elements:
//      kVecs 16-byte vectors of start, one aligned load each.  is_end may
//      sit at another offset mod 16 (a slice such as is_end[3:]): the lane
//      loads the kVecs + 1 aligned vectors of is_end that cover its
//      elements and shifts their bit masks by that offset, so no vector
//      falls back to byte loads.  Only a vector not wholly inside [0, m)
//      (a head or a tail) is read byte by byte, so no read leaves the
//      masks.  Each vector's nonzero bytes become a 16-bit mask (one bit
//      trick and a multiply a word), so a lane holds its flags as one bit
//      mask a mask;
//   3. rank: one warp scan of the lane's two counts packed in one word
//      (start count low, end count high: 16 bits each hold a tile's
//      count), the warps' totals through shared memory, and warp 0
//      publishes the tile's two counts in ONE 64-bit descriptor: status in
//      the top 2 bits, the end count in bits 31-61, the start count in bits
//      0-30 (lookback::pair).  A descriptor is written by one aligned
//      64-bit store, so no reader sees a status with a stale count of
//      either mask; aggregates add field by field without a carry, since
//      each field's sum is at most m < 2^31.  The look-back then runs as
//      K2's does.  The tile that holds element m - 1 writes the count;
//   4. scatter, spread over the warp: the warp's j-th set flag of a mask
//      goes to lane j % 32 in round j / 32, which finds it by warp_nth (a
//      five-step search over the lanes' inclusive counts by shuffles, then
//      the bit of that lane's mask), loads pos (and cand) there and stores
//      to the warp's offset plus j.  So a round is one payload load and one
//      coalesced store a lane, however the set flags fall among the lanes;
//      at about 2% density a warp's 2048 elements take one or two rounds.
//      A warp whose flags are all clear skips the scatter.
// Writes land only at their final slots, so block order never matters.
// Tile = 32768 elements (512 threads, 64 a lane, 32 registers, so 4 blocks
// a multiprocessor): the 64 MiB dense chunk's 67,108,833 candidates make
// 2048 tiles.  Measured on an H100 at that chunk, the kernel takes about
// 0.115 ms, of which an all-clear mask (flags, look-back, no scatter)
// takes 0.037; tiles of 8192 or 16384, 128 to 1024 threads, two scatter
// rounds' loads issued together, and payloads loaded ahead of the
// look-back (which cost registers) were no faster (PERF.md section 6).
// The workspace (ticket counter and one descriptor a tile) is the
// caller's, allocated per call on the launch stream, and zeroed here by
// one cudaMemsetAsync on that stream.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

using lookback::kFull;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;                   // 16-byte vectors a lane a mask
constexpr int kLane = 16 * kVecs;          // elements a lane
constexpr int kTile = 32768;               // elements a tile
static_assert(kTile == kThreads * kLane, "tile shape");
static_assert(kLane <= 64, "a lane's flags fit one 64-bit mask");
static_assert(kTile < 65536, "a tile's counts fit 16 bits of a word");

// Bit j set iff byte j of v is nonzero.
__device__ __forceinline__ unsigned byte_bits(uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // bit 7 of a byte of t is set iff that byte of w is nonzero; the
    // multiply gathers bits 0, 8, 16, 24 of t >> 7 into bits 21-24
    const unsigned t =
        (((w[k] & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w[k]) & 0x80808080u;
    bits |= ((((t >> 7) * 0x00204081u) >> 21) & 0xFu) << (4 * k);
  }
  return bits;
}

// The bit index of the r-th set bit (from 0) of w, which has more than r.
__device__ __forceinline__ int nth_set(unsigned long long w, int r) {
  int at = 0;
#pragma unroll
  for (int s = 32; s > 0; s >>= 1) {
    const int c = __popcll(w & ((1ull << s) - 1));
    if (r >= c) {
      r -= c;
      w >>= s;
      at += s;
    }
  }
  return at;
}

// Every lane of a warp, for the warp's j-th set flag of one mask (j below
// the warp's count of that mask): its bit in the flags of the lane that
// holds it, as that lane's index times kLane plus the bit.  `incl` is the
// lane's inclusive count of the mask in the warp, `flags` its bit mask.
__device__ __forceinline__ int warp_nth(int j, int incl,
                                        unsigned long long flags) {
  // the lane that holds it: the first whose inclusive count exceeds j
  int at = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1)
    if (__shfl_sync(kFull, incl, at + step - 1) <= j) at += step;
  const unsigned long long w = __shfl_sync(kFull, flags, at);
  const int before = __shfl_sync(kFull, incl, at) - __popcll(w);
  return at * kLane + nth_set(w, j - before);
}

__global__ void __launch_bounds__(kThreads)
compact_masked_kernel(const uint8_t* __restrict__ start,
                      const uint8_t* __restrict__ is_end,
                      const int32_t* __restrict__ pos,
                      const int32_t* __restrict__ cand, int64_t m, int head,
                      int end_shift, int tiles, unsigned long long* ws,
                      int32_t* __restrict__ out_s,
                      int32_t* __restrict__ out_e,
                      int32_t* __restrict__ out_c,
                      int32_t* __restrict__ n_out) {
  __shared__ unsigned s_warp[kWarps];
  __shared__ int s_tile;
  __shared__ unsigned long long s_excl;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = lookback::take_ticket(ws, &s_tile);
  // the lane's first element: tiles are cut at 16-byte boundaries of
  // start's address, the first one `head` bytes early
  const int64_t e0 = int64_t(tile) * kTile - head +
                     (warp * 32 + lane) * kLane;

  unsigned long long fs = 0, fe = 0;   // bit b: element e0 + b is set
  unsigned eb[kVecs + 1];
#pragma unroll
  for (int h = 0; h < kVecs; ++h) {
    fs |= (unsigned long long)byte_bits(
              lookback::load16(start, e0 + 16 * h, m)) << (16 * h);
    // is_end + e0 - end_shift is 16-byte aligned
    eb[h] = byte_bits(lookback::load16(is_end, e0 - end_shift + 16 * h, m));
  }
  eb[kVecs] = end_shift == 0 ? 0u : byte_bits(lookback::load16(
      is_end, e0 - end_shift + 16 * kVecs, m));
#pragma unroll
  for (int h = 0; h < kVecs; ++h)
    fe |= (unsigned long long)(((eb[h] | eb[h + 1] << 16) >> end_shift) &
                               0xFFFFu) << (16 * h);

  // the lane's two counts packed, start count low and end count high,
  // unsigned: a tile of set end flags puts its count in bit 31
  const unsigned cnt = unsigned(__popcll(fs)) | unsigned(__popcll(fe)) << 16;
  unsigned incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  const unsigned wtot = __shfl_sync(kFull, incl, 31);   // the warp's counts
  if (lane == 0) s_warp[warp] = wtot;
  __syncthreads();
  if (warp == 0) {
    const unsigned agg = lookback::warp_offsets<kWarps>(
        lane < kWarps ? s_warp[lane] : 0u, s_warp);
    const unsigned long long excl = lookback::look_back_pair(
        ws + 1, tile, lookback::pair(int(agg & 0xFFFF), int(agg >> 16)));
    if (lane == 0) {
      s_excl = excl;
      if (tile == tiles - 1)
        *n_out = int(excl & lookback::kPairCount) + int(agg & 0xFFFF);
    }
  }
  __syncthreads();
  if (wtot == 0) return;   // warp-uniform

  // the warp's j-th set flag of each mask goes to lane j % 32 in round
  // j / 32: one payload load and one coalesced store a lane a round
  const unsigned long long excl = s_excl;
  const int64_t out0_s = int64_t(excl & lookback::kPairCount) +
                         (s_warp[warp] & 0xFFFF);
  const int64_t out0_e = int64_t(excl >> lookback::kPairShift) +
                         (s_warp[warp] >> 16);
  const int64_t seg = e0 - lane * kLane;   // the warp's first element
  const int ns = int(wtot & 0xFFFF), ne = int(wtot >> 16);
  const int is = int(incl & 0xFFFF), ie = int(incl >> 16);
  for (int r = 0; r < max(ns, ne); r += 32) {
    const int j = r + lane;
    const int64_t i = seg + warp_nth(min(j, ns - 1), is, fs);
    const int64_t k = seg + warp_nth(min(j, ne - 1), ie, fe);
    // the loads of both masks first, their stores after
    int32_t ps = 0, cs = 0, pe = 0;
    if (j < ns) {
      ps = __ldg(pos + i);
      cs = __ldg(cand + i);
    }
    if (j < ne) pe = __ldg(pos + k);
    if (j < ns) {
      out_s[out0_s + j] = ps;
      out_c[out0_s + j] = cs;
    }
    if (j < ne) out_e[out0_e + j] = pe;
  }
}

}  // namespace

// K9.  `ws` holds `ws_slots` 8-byte slots, at least
// lrzt_compact_masked_slots(m); `n` is one int32 on the device.
extern "C" int lrzt_compact_masked(const void* start, const void* is_end,
                                   const void* pos, const void* cand,
                                   int64_t m, void* ws, int64_t ws_slots,
                                   void* out_s, void* out_e, void* out_c,
                                   void* n, void* stream) {
  if (m <= 0 || m >= (int64_t(1) << 31)) return int(cudaErrorInvalidValue);
  const uintptr_t s = reinterpret_cast<uintptr_t>(start);
  const int head = int(s & 15u);
  const int end_shift =
      int((reinterpret_cast<uintptr_t>(is_end) - s) & 15u);
  const int64_t tiles = (head + m + kTile - 1) / kTile;
  if (ws_slots < tiles + 1) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      ws, 0, size_t(tiles + 1) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return int(err);
  compact_masked_kernel<<<dim3(unsigned(tiles)), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(start),
      static_cast<const uint8_t*>(is_end),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(cand),
      m, head, end_shift, int(tiles), static_cast<unsigned long long*>(ws),
      static_cast<int32_t*>(out_s), static_cast<int32_t*>(out_e),
      static_cast<int32_t*>(out_c), static_cast<int32_t*>(n));
  return int(cudaGetLastError());
}

// Workspace slots a call with 0 < m < 2**31 elements needs at any
// alignment: the ticket counter and one descriptor a tile.
extern "C" int lrzt_compact_masked_slots(int64_t m) {
  return int((m + 15 + kTile - 1) / kTile + 1);
}
