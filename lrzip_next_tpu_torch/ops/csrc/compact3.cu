// K2 and K10: order-preserving compaction of three (K2) or two (K10) int32
// payloads at flagged positions, plus the count, in ONE launch: a
// single-pass compaction with a decoupled look-back (Merrill and
// Garland's scan; the ticket, the descriptors, load16 and the look-back
// are lookback.cuh's, shared with K3 in streampack.cu).  The payload count
// is a template parameter of the one kernel.
//
// Replaces: lrzip_next_tpu/ops/compact_pallas.py : compact_starts3_pallas
// (kernel _compact_kernel3) and compact_starts_pallas (kernel
// _compact_kernel2).  out_x[r] = x[i] for the r-th set flag i, in index
// order, for x in (a, b, c) or (a, b); *n = the number of set flags.
//
// Bound on the card (NVIDIA H100 80GB HBM3 at a 700 W power limit):
// device memory.  The function reads each flag once, each payload in the
// 32-byte sectors that hold a set flag only, and writes the kept records
// and the count: on the matcher's chain starts (6% of the seeds) about
// 2.7 (K10) or 3.5 (K2) bytes per element, against a few integer
// operations per element.  The TPU
// design does not carry over: it routed elements with log-shift concats
// inside a tile and relied on its grid running IN ORDER.  GPU blocks run
// in no order, so each block works out its tile's output offset itself:
//   1. ticket: thread 0 takes the tile index from an atomicAdd on the
//      zeroed workspace's counter, so a block waits only on tiles with
//      lower tickets, whose blocks are already running: the look-back
//      always makes progress, whatever order the blocks start in;
//   2. load and count: warp w owns the tile's flags [1024 w, 1024 w +
//      1024); each lane loads two 16-byte vectors of them (a 512-byte
//      coalesced row a load), stores them in shared memory and counts the
//      nonzero bytes with one bit trick and __popc a word.  A vector that
//      is not wholly inside [0, k) (the unaligned head of a slice such as
//      flag[1:], the tail) is loaded byte by byte, so no read leaves the
//      flags;
//   3. publish, then look back: the block's aggregate goes into its tile
//      descriptor at once (status and value in one 64-bit word, one
//      store, so no reader sees a status with a stale value); warp 0
//      then reads the descriptors of up to 32 predecessors at a time,
//      spins while any of them is unset, sums
//      aggregates back to the nearest inclusive prefix, and publishes its
//      own inclusive prefix.  The tile that holds element k-1 writes it
//      to *n;
//   4. scatter: each warp ranks its own 1024 flags from shared memory in
//      32 rounds of one ballot (no block barrier), reads the payloads at
//      the set flags only and writes them to their final slots, and
//      stops once its count is reached.  The rounds go in batches of 8:
//      the batch's ballots and payload loads first, its stores after, so
//      a warp waits on one memory latency a batch, not one a round (at
//      6% density most rounds of 32 flags hold a set one).
// Tile = 8192 flags (256 threads, 8 warps): the 64 MiB chunk's 8,388,604
// seeds make 1024 tiles, and each lane moves 32 flag bytes in two 16-byte
// loads.  At 40 registers (two payloads) and 62 (three) an SM holds 6 and
// 4 blocks, so those tiles take two waves.  Capping the kernel at 32
// registers for one wave, measured on an H100, made the flag pass faster
// but the scatter slower (a batch of 4 rounds) or spilled (a batch of 8),
// for no gain on two payloads at that size.  The
// workspace (ticket counter and one descriptor a tile) is the caller's,
// allocated per call on the launch stream, and zeroed here by one
// cudaMemsetAsync on that stream, so back-to-back calls and calls on
// other streams never share a ticket or a descriptor.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

using lookback::kFull;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8192;                // flags a block
constexpr int kSeg = kTile / kWarps;       // flags a warp
constexpr int kRounds = kSeg / 32;         // ballot rounds a warp
constexpr int kBatch = 8;                  // rounds whose loads overlap

template <int kPayloads>
struct Payloads {
  const int32_t* in[kPayloads];
  int32_t* out[kPayloads];
};

template <int kPayloads>
__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ flags, Payloads<kPayloads> p,
               int64_t k, int head, int tiles, unsigned long long* ws,
               int32_t* __restrict__ n_out) {
  __shared__ __align__(16) uint8_t s_flags[kTile];
  __shared__ int s_warp[kWarps];
  __shared__ int s_tile;
  __shared__ int s_excl;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = lookback::take_ticket(ws, &s_tile);
  // element index of the tile's first flag: tiles are cut at 16-byte
  // boundaries of the flags' addresses, the first one `head` bytes early
  const int64_t base = int64_t(tile) * kTile - head;

  int cnt = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int local = warp * kSeg + h * (kSeg / 2) + lane * 16;
    const uint4 v = lookback::load16(flags, base + local, k);
    *reinterpret_cast<uint4*>(s_flags + local) = v;
    cnt += lookback::count16(v);
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
      if (tile == tiles - 1) *n_out = excl + agg;
    }
  }
  __syncthreads();
  if (cnt == 0) return;

  int64_t out = int64_t(s_excl) + s_warp[warp];
  const unsigned below = (1u << lane) - 1u;
  int done = 0;
  for (int r0 = 0; r0 < kRounds && done < cnt; r0 += kBatch) {
    unsigned ballot[kBatch];
    int32_t v[kBatch][kPayloads];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int local = warp * kSeg + (r0 + u) * 32 + lane;
      const bool f = s_flags[local] != 0;
      ballot[u] = __ballot_sync(kFull, f);
      if (f) {
#pragma unroll
        for (int q = 0; q < kPayloads; ++q)
          v[u][q] = __ldg(p.in[q] + (base + local));
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if ((ballot[u] >> lane) & 1u) {
        const int64_t o = out + __popc(ballot[u] & below);
#pragma unroll
        for (int q = 0; q < kPayloads; ++q) p.out[q][o] = v[u][q];
      }
      const int c = __popc(ballot[u]);
      out += c;
      done += c;
    }
  }
}

template <int kPayloads>
int launch(const void* flags, const void* const (&in)[kPayloads],
           void* const (&out)[kPayloads], int64_t k, void* ws,
           int64_t ws_slots, void* n, void* stream) {
  if (k <= 0 || k >= (int64_t(1) << 31)) return int(cudaErrorInvalidValue);
  const int head = int(reinterpret_cast<uintptr_t>(flags) & 15u);
  const int64_t tiles = (head + k + kTile - 1) / kTile;
  if (ws_slots < tiles + 1) return int(cudaErrorInvalidValue);
  Payloads<kPayloads> p;
  for (int q = 0; q < kPayloads; ++q) {
    p.in[q] = static_cast<const int32_t*>(in[q]);
    p.out[q] = static_cast<int32_t*>(out[q]);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      ws, 0, size_t(tiles + 1) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return int(err);
  compact_kernel<kPayloads><<<dim3(unsigned(tiles)), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(flags), p, k, head, int(tiles),
      static_cast<unsigned long long*>(ws), static_cast<int32_t*>(n));
  return int(cudaGetLastError());
}

}  // namespace

// K2.  `ws` holds `ws_slots` 8-byte slots, at least lrzt_compact_slots(k);
// `n` is one int32 on the device.
extern "C" int lrzt_compact3(const void* flags, const void* a, const void* b,
                             const void* c, int64_t k, void* ws,
                             int64_t ws_slots, void* out_a, void* out_b,
                             void* out_c, void* n, void* stream) {
  const void* const in[3] = {a, b, c};
  void* const out[3] = {out_a, out_b, out_c};
  return launch<3>(flags, in, out, k, ws, ws_slots, n, stream);
}

// K10: the same kernel with two payloads.
extern "C" int lrzt_compact2(const void* flags, const void* a, const void* b,
                             int64_t k, void* ws, int64_t ws_slots,
                             void* out_a, void* out_b, void* n,
                             void* stream) {
  const void* const in[2] = {a, b};
  void* const out[2] = {out_a, out_b};
  return launch<2>(flags, in, out, k, ws, ws_slots, n, stream);
}

// Workspace slots a call with 0 < k < 2**31 flags needs at any alignment:
// the ticket counter and one descriptor a tile.
extern "C" int lrzt_compact_slots(int64_t k) {
  return int((k + 15 + kTile - 1) / kTile + 1);
}
