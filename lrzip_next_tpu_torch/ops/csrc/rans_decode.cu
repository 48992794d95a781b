// K7: the K-lane interleaved rANS decode, run forward over the span.
//
// Replaces: lrzip_next_tpu/ops/rans_decode_pallas.py : decode_scan_fused
// (kernel _make_kernel; XLA twin lrzip_next_tpu/ops/rans.py _decode_scan).
// Lane l owns the output bytes plane[l*T, (l+1)*T) and a uint32 state x.
// For t = 0 .. T-1, at a real position (l*T + t < n), with ctx the lane's
// previous symbol >> (8 - ctx_bits) (0 at t = 0 and for ctx_bits 0):
//   slot = x & 4095;  s = the symbol with cum[ctx][s] <= slot < cum[ctx][s+1];
//   x = (cum[ctx][s+1] - cum[ctx][s]) * (x >> 12) + slot - cum[ctx][s];
//   if (x < 2^16) x = x << 16 | next word of the stream;
// and plane[l*T + t] = s (0 at padding positions, whose lanes keep their
// state).  The lanes that take a word in one step take consecutive words
// in lane order: lane l reads words[ptr + (renormalising lanes below l)],
// and ptr advances by the step's count.  A read at or past n_words gives 0,
// so a corrupt stream can not read outside the tensor; it shows as a final
// state other than 2^16, which the caller checks.
//
// Bound on the card (NVIDIA H100 80GB HBM3): neither bytes nor operations
// but the dependent chain.  Step t+1's word offsets depend on the count of
// every lane's step t, so the T steps are serial, and each needs a prefix
// over all K lanes.  The bytes (2 per word in, 1 per symbol out) would take
// microseconds at the card's memory rate.
//
// Design: one block of up to 1024 threads; thread j owns the K/1024
// consecutive lanes from j*K/1024, states in registers, so the order inside
// a thread is lane order.  Per step every thread decodes its lanes, counts
// those that renormalise, a warp scan (__shfl_up_sync) and a scan of the
// warp totals through shared memory give its word offset, and all threads
// add the step's total to their copy of ptr.  The warp totals are double
// buffered, so one __syncthreads() a step suffices.  The cumulative table
// ((C, 257) uint16, 32 KB at ctx_bits 6 and 128.5 KB at ctx_bits 8, opt-in
// dynamic shared memory) is searched with an 8-step binary search.  The
// lane's context is the top byte of its 4-symbol output word, which is
// stored once every 4 steps when T is a multiple of 4 (bytes otherwise).
// One SM is busy; several blocks or a cluster are later work.
//
// The TPU kernel's (8, K/8) tiles, bf16 one-hot table fetches, coarse
// 4-entry table, 72-row DMA window and log-shift routing network are not
// carried over: integer loads from shared memory, a search, and a native
// gather words[ptr + rank] give the same integers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kRow = 257;  // cumulative entries per context
constexpr uint32_t kLInit = 1u << 16;

template <int kLanes>
__global__ void __launch_bounds__(kMaxThreads)
decode_kernel(const uint16_t* __restrict__ words, int64_t n_words,
              const uint32_t* __restrict__ states_in,
              const uint16_t* __restrict__ cum, int64_t n, int ctx_bits,
              int64_t t_len, uint8_t* __restrict__ plane,
              uint32_t* __restrict__ states_out) {
  extern __shared__ uint16_t s_cum[];
  __shared__ int s_tot[2][32];
  const int tid = threadIdx.x;
  const int lane_in_warp = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int cells = kRow << ctx_bits;
  for (int i = tid; i < cells; i += blockDim.x) s_cum[i] = cum[i];

  const int64_t lane0 = int64_t(tid) * kLanes;
  // lanes below n / T are real at every t, lane n / T for t < n % T, the
  // lanes above it never
  const int64_t full_lanes = n / t_len - lane0;
  const int64_t part_t = n % t_len;
  const int shift = 8 - ctx_bits;
  const bool word_store = (t_len & 3) == 0;

  uint32_t x[kLanes];
  uint32_t pack[kLanes];  // the lane's last 4 symbols, newest in the top byte
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    x[j] = states_in[lane0 + j];
    pack[j] = 0;
  }
  __syncthreads();

  int64_t ptr = 0;
  for (int64_t t = 0; t < t_len; ++t) {
    unsigned takes = 0;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      uint32_t sym = 0;
      if (j < full_lanes || (j == full_lanes && t < part_t)) {
        const uint32_t ctx = ctx_bits ? ((pack[j] >> 24) >> shift) : 0u;
        const uint16_t* row = s_cum + ctx * kRow;
        const uint32_t slot = x[j] & 4095u;
        int s = 0;
#pragma unroll
        for (int step = 128; step > 0; step >>= 1)
          if (row[s + step] <= slot) s += step;
        const uint32_t c = row[s];
        const uint32_t f = uint32_t(row[s + 1]) - c;
        x[j] = f * (x[j] >> 12) + slot - c;
        if (x[j] < kLInit) takes |= 1u << j;
        sym = uint32_t(s);
      }
      pack[j] = (pack[j] >> 8) | (sym << 24);
    }

    // exclusive prefix of the renormalising-lane counts over the block
    const int count = __popc(takes);
    int incl = count;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane_in_warp >= d) incl += v;
    }
    int* tot = s_tot[t & 1];
    if (lane_in_warp == 31) tot[warp] = incl;
    __syncthreads();
    const int mine = lane_in_warp < n_warps ? tot[lane_in_warp] : 0;
    int wincl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, wincl, d);
      if (lane_in_warp >= d) wincl += v;
    }
    const int total = __shfl_sync(0xFFFFFFFFu, wincl, 31);
    const int before = __shfl_sync(0xFFFFFFFFu, wincl - mine, warp);

    int64_t at = ptr + before + (incl - count);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      if (takes & (1u << j)) {
        const uint32_t w = at < n_words ? uint32_t(__ldg(words + at)) : 0u;
        x[j] = (x[j] << 16) | w;
        ++at;
      }
    }
    ptr += total;

    if (word_store) {
      if ((t & 3) == 3) {
#pragma unroll
        for (int j = 0; j < kLanes; ++j)
          *reinterpret_cast<uint32_t*>(plane + (lane0 + j) * t_len + t - 3) =
              pack[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < kLanes; ++j)
        plane[(lane0 + j) * t_len + t] = uint8_t(pack[j] >> 24);
    }
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) states_out[lane0 + j] = x[j];
}

template <int kLanes>
int launch(int threads, int smem, const uint16_t* words, int64_t n_words,
           const uint32_t* states_in, const uint16_t* cum, int64_t n,
           int ctx_bits, int64_t t_len, uint8_t* plane, uint32_t* states_out,
           cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<kLanes>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return int(err);
  decode_kernel<kLanes><<<1, threads, smem, s>>>(
      words, n_words, states_in, cum, n, ctx_bits, t_len, plane, states_out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int lrzt_rans_decode(const void* words, int64_t n_words,
                                const void* states_in, const void* cum,
                                int64_t n, int ctx_bits, int64_t t_len, int k,
                                void* plane, void* states_out, void* stream) {
  if (t_len <= 0 || n < 0 || n_words < 0 || k < 64 || k > 16384 ||
      (k & (k - 1)) != 0 ||
      (ctx_bits != 0 && ctx_bits != 4 && ctx_bits != 6 && ctx_bits != 8))
    return int(cudaErrorInvalidValue);
  const int threads = k < kMaxThreads ? k : kMaxThreads;
  const int smem = (kRow << ctx_bits) * int(sizeof(uint16_t));
  const auto* w = static_cast<const uint16_t*>(words);
  const auto* si = static_cast<const uint32_t*>(states_in);
  const auto* c = static_cast<const uint16_t*>(cum);
  auto* pl = static_cast<uint8_t*>(plane);
  auto* so = static_cast<uint32_t*>(states_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k / threads) {
    case 1:
      return launch<1>(threads, smem, w, n_words, si, c, n, ctx_bits, t_len,
                       pl, so, s);
    case 2:
      return launch<2>(threads, smem, w, n_words, si, c, n, ctx_bits, t_len,
                       pl, so, s);
    case 4:
      return launch<4>(threads, smem, w, n_words, si, c, n, ctx_bits, t_len,
                       pl, so, s);
    case 8:
      return launch<8>(threads, smem, w, n_words, si, c, n, ctx_bits, t_len,
                       pl, so, s);
    case 16:
      return launch<16>(threads, smem, w, n_words, si, c, n, ctx_bits, t_len,
                        pl, so, s);
  }
  return int(cudaErrorInvalidValue);
}
