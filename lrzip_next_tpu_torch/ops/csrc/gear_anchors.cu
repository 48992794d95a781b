// K11: a window's content-defined anchors and their fingerprints, in ONE
// launch: the scan of the cross-window index (models/crosschunk.py).
//
// Replaces no Pallas kernel: its counterpart is the JAX package's numpy
// scan, lrzip_next_tpu/models/crosschunk.py gear_anchor_positions and
// window_hashes_at, which the port ran twice a window on the host (once
// to look the window up, once to add it to the index).  It writes, in
// ascending order, every position j with 8 <= j < n - 32 where the low
// mask_bits bits of the gear hash
//     g[j] = sum_{k<8} GEAR[data[j-1-k]] << k    (mod 2^64)
// are all set, the two 5-level 32-bit tree hashes of bytes [j, j+32) at
// each (multipliers m1 and m2 of window_hashes_at), packed as
// (a << 32) | b, and the count.
//
// Only the low mask_bits <= 32 bits of g are compared, and a left shift
// never carries high bits down, so sums of the table's low 32-bit words
// mod 2^32 give those bits exactly: the host passes the low words, and
// they sit in shared memory.
//
// Bound on the card (NVIDIA H100 80GB HBM3, 3.35 TB/s): device memory,
// and barely that: the window is read once (8 MiB) and about 1/2^mask_bits
// of its positions are written (16 bytes each), 2.6 us for an 8 MiB
// window; the launch, the memset and the read-back of the count cost
// more.  The design keeps the window's bytes to one read:
//   1. ticket and stage: a block takes its tile (8192 positions) by
//      ticket (lookback.cuh) and stages the tile's bytes with a 16-byte
//      halo before and a 32-byte tail after, [base - 16, base + 8224), in
//      shared memory by 16-byte loads (byte loads only where a vector is
//      not wholly inside [0, n), so no read leaves the window, and the
//      padding past n is never read);
//   2. gear flags: each thread owns 32 consecutive positions and reads
//      its 48 bytes with three 16-byte shared loads; it rolls the gear
//      hash in a register, g[j+1] = (g[j] << 1) + T[b[j]] - (T[b[j-8]] <<
//      8), two table look-ups a position, and keeps one bit a position;
//   3. publish, then look back: the thread counts (popc) are scanned in
//      the warp, the warp totals by warp 0, whose look-back over the
//      tiles before gives the tile's output offset, so the anchors come
//      out in position order (the index's greedy walk follows them in
//      order, and its stable sort breaks equal fingerprints by it).  The
//      last tile writes the count;
//   4. each thread hashes its anchors' 32-byte windows from shared memory
//      (the 32-byte tail covers the last position's window) and writes
//      position and fingerprint to their slots.
// The output has room for every position: content of one repeated byte
// can make every position an anchor.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kP = 32;                     // positions a thread
constexpr int kTile = kThreads * kP;       // positions a block
constexpr int kHalo = 16;                  // bytes staged before the tile
constexpr int kWindow = 32;                // fingerprint window
constexpr int kStage = kHalo + kTile + kWindow;
constexpr int kLow = 8;                    // first position: 8 bytes before

static_assert(kStage % 16 == 0, "the stage is whole 16-byte vectors");

struct Gear {
  uint32_t lo[256];                        // GEAR's low 32-bit words
};

// The 5-level tree hash of the 32 bytes at s (window_hashes_at): level k
// combines x[i] * m[k] with x[i + 2^k], 31, 29, 25, 17, 1 values wide.
template <uint32_t M0, uint32_t M1, uint32_t M2, uint32_t M3, uint32_t M4>
__device__ __forceinline__ uint32_t tree_hash(const uint8_t* s) {
  const uint32_t m[5] = {M0, M1, M2, M3, M4};
  uint32_t x[kWindow];
#pragma unroll
  for (int i = 0; i < kWindow; ++i) x[i] = s[i];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int half = 1 << k;
#pragma unroll
    for (int i = 0; i < kWindow + 1 - 2 * half; ++i)
      x[i] = x[i] * m[k] + x[i + half];
  }
  return x[0];
}

__global__ void __launch_bounds__(kThreads)
gear_anchors_kernel(const uint8_t* __restrict__ data, int64_t n, int64_t hi,
                    uint32_t mask, const Gear gear, int tiles,
                    unsigned long long* ws, int32_t* __restrict__ pos_out,
                    uint64_t* __restrict__ fp_out,
                    int32_t* __restrict__ n_out) {
  __shared__ __align__(16) uint8_t s_bytes[kStage];
  __shared__ uint32_t s_gear[256];
  __shared__ int s_warp[kWarps];
  __shared__ int s_tile;
  __shared__ int s_excl;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  s_gear[threadIdx.x] = gear.lo[threadIdx.x];
  const int tile = lookback::take_ticket(ws, &s_tile);
  const int64_t base = int64_t(tile) * kTile;
  const bool aligned = (reinterpret_cast<uintptr_t>(data) & 15u) == 0;
  for (int v = threadIdx.x; v < kStage / 16; v += kThreads)
    *reinterpret_cast<uint4*>(s_bytes + 16 * v) =
        lookback::load16(data, base - kHalo + 16 * v, n, aligned);
  __syncthreads();

  // the thread's bytes [j0 - 16, j0 + 32): byte i at bits 8 (i & 3) of
  // w[i >> 2]
  const int off = threadIdx.x * kP;
  uint32_t w[12];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const uint4 v = *reinterpret_cast<const uint4*>(s_bytes + off + 16 * q);
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
#define BYTE(i) ((w[(i) >> 2] >> (8 * ((i) & 3))) & 0xFFu)
  const int64_t j0 = base + off;
  uint32_t g = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) g += s_gear[BYTE(kHalo - 1 - k)] << k;
  unsigned bits = 0;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int64_t j = j0 + p;
    if ((g & mask) == mask && j >= kLow && j < hi) bits |= 1u << p;
    g = (g << 1) + s_gear[BYTE(kHalo + p)] -
        (s_gear[BYTE(kHalo - 8 + p)] << 8);
  }
#undef BYTE

  const int cnt = __popc(bits);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(lookback::kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int agg = lookback::warp_offsets<kWarps>(
        lane < kWarps ? s_warp[lane] : 0, s_warp);
    const int excl = lookback::look_back(ws + 1, tile, agg);
    if (lane == 0) {
      s_excl = excl;
      if (tile == tiles - 1) *n_out = excl + agg;
    }
  }
  __syncthreads();

  int64_t o = int64_t(s_excl) + s_warp[warp] + (incl - cnt);
  for (; bits; bits &= bits - 1, ++o) {
    const int p = __ffs(bits) - 1;
    const uint8_t* s = s_bytes + off + kHalo + p;
    pos_out[o] = int32_t(j0 + p);
    const uint32_t a = tree_hash<0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                 0x27D4EB2Fu, 0x165667B1u>(s);
    const uint32_t b = tree_hash<0xD1B54A33u, 0xABC98389u, 0x8CB92BA7u,
                                 0x2545F491u, 0x9E377F4Bu>(s);
    fp_out[o] = (uint64_t(a) << 32) | b;
  }
}

// Tiles of positions [0, n - 32): none where no position can be one.
int64_t tiles_of(int64_t n) {
  const int64_t hi = n - kWindow;
  return hi > kLow ? (hi + kTile - 1) / kTile : 0;
}

}  // namespace

// K11.  `data` holds the window's n < 2^31 bytes (read only in [0, n));
// `gear_lo` is a HOST pointer to the table's 256 low 32-bit words, passed
// to the kernel by value; `ws` holds `ws_slots` 8-byte slots, at least
// lrzt_gear_anchors_slots(n); `pos` (int32) and `fps` (uint64) have room
// for n - 40 entries, `count` is one int32 on the device.  A window with
// no possible position (n <= 40) launches nothing and returns 0: the
// caller writes its count.
extern "C" int lrzt_gear_anchors(const void* data, int64_t n, int mask_bits,
                                 const void* gear_lo, void* ws,
                                 int64_t ws_slots, void* pos, void* fps,
                                 void* count, void* stream) {
  if (n < 0 || n >= (int64_t(1) << 31) || mask_bits < 1 || mask_bits > 32)
    return int(cudaErrorInvalidValue);
  const int64_t tiles = tiles_of(n);
  if (tiles == 0) return 0;
  if (ws_slots < tiles + 1) return int(cudaErrorInvalidValue);
  Gear gear;
  const uint32_t* lo = static_cast<const uint32_t*>(gear_lo);
  for (int i = 0; i < 256; ++i) gear.lo[i] = lo[i];
  const uint32_t mask =
      mask_bits == 32 ? 0xFFFFFFFFu : (1u << mask_bits) - 1u;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      ws, 0, size_t(tiles + 1) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return int(err);
  gear_anchors_kernel<<<dim3(unsigned(tiles)), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(data), n, n - kWindow, mask, gear,
      int(tiles), static_cast<unsigned long long*>(ws),
      static_cast<int32_t*>(pos), static_cast<uint64_t*>(fps),
      static_cast<int32_t*>(count));
  return int(cudaGetLastError());
}

// Workspace slots a call on an n-byte window needs: the ticket counter
// and one descriptor a tile.
extern "C" int lrzt_gear_anchors_slots(int64_t n) {
  return int(tiles_of(n) + 1);
}
