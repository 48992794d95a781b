// K5: the K-lane interleaved rANS encode, run in reverse over the span.
//
// Replaces: lrzip_next_tpu/ops/rans_pallas.py : encode_scan_fused (kernel
// _make_kernel).  Lane l owns bytes lit[l*T, (l+1)*T) and a uint32 state
// x in [2^16, 2^32), starting at 2^16.  For t = T-1 down to 0, at a real
// position (l*T + t < n), with v = tab[ctx][sym] = cum * 4096 + (f - 1):
//   e = x >= f << 20;  word = e ? x & 0xFFFF : 0;  if (e) x >>= 16;
//   x = (x / f) * 4096 + cum + x % f;
// and plane[t*K + l] = word | e << 16 (0 at padding positions).  The final
// states are the decoder's initial ones.  ctx is the lane's previous byte
// >> (8 - ctx_bits), 0 at t = 0 and for ctx_bits 0.
//
// Bound on the card (NVIDIA H100 80GB HBM3 at a 700 W power limit):
// latency and occupancy, not bandwidth.  One thread per lane, so at most
// K = 16384 threads (about one 128-thread block per SM) each run T
// dependent steps: a table load, a 32-bit integer division and a store.
// Per step 1 byte is read and 4 written; the (T, K) plane store is
// coalesced across lanes, the lit[l*T + t] loads are not (lanes lie T
// bytes apart), and rely on L1 to hold each thread's last sector.
//
// The TPU kernel fetched (f, cum) with two-level one-hot bf16 matmuls and
// divided with two exact f32 divisions plus a +-1 fixup.  Here the packed
// table is an int32 load, from shared memory where it fits (64 KB at
// ctx_bits 6, dynamic shared memory) and from global memory, kept in L2,
// at ctx_bits 8 (256 KB), and the division is the native uint32 one.
// Both give the same integers.  f <= 3841 for every table quantize_freqs
// makes, so f << 20 fits in 32 bits (it wraps as on the TPU otherwise).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kM = 4096;
constexpr uint32_t kLInit = 1u << 16;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const uint8_t* __restrict__ lit, int64_t t_len, int k,
              int64_t n, int ctx_bits, const int32_t* __restrict__ tab,
              uint32_t* __restrict__ states, int32_t* __restrict__ plane) {
  extern __shared__ int32_t s_tab[];
  const int32_t* table = tab;
  if (kShared) {
    const int cells = 256 << ctx_bits;
    for (int i = threadIdx.x; i < cells; i += kThreads) s_tab[i] = tab[i];
    __syncthreads();
    table = s_tab;
  }
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= k) return;
  const int shift = 8 - ctx_bits;
  const uint8_t* span = lit + int64_t(lane) * t_len;
  const int64_t real = n - int64_t(lane) * t_len;  // t < real is real
  uint32_t x = kLInit;
  for (int64_t t = t_len - 1; t >= 0; --t) {
    const int sym = __ldg(span + t);
    const int ctx = (ctx_bits && t > 0) ? (__ldg(span + t - 1) >> shift) : 0;
    int32_t out = 0;
    if (t < real) {
      const uint32_t v = uint32_t(table[(ctx << 8) | sym]);
      const uint32_t f = (v & (kM - 1)) + 1;
      const uint32_t cum = v >> 12;
      if (x >= (f << 20)) {
        out = int32_t((x & 0xFFFFu) | 0x10000u);
        x >>= 16;
      }
      x = (x / f) * kM + cum + x % f;
    }
    plane[t * k + lane] = out;
  }
  states[lane] = x;
}

}  // namespace

extern "C" int lrzt_rans_encode(const void* lit, int64_t t_len, int k,
                                int64_t n, int ctx_bits, const void* tab,
                                void* states, void* plane, void* stream) {
  if (t_len <= 0 || k <= 0 ||
      (ctx_bits != 0 && ctx_bits != 4 && ctx_bits != 6 && ctx_bits != 8))
    return int(cudaErrorInvalidValue);
  const unsigned blocks = unsigned((k + kThreads - 1) / kThreads);
  const auto* src = static_cast<const uint8_t*>(lit);
  const auto* t = static_cast<const int32_t*>(tab);
  auto* st = static_cast<uint32_t*>(states);
  auto* pl = static_cast<int32_t*>(plane);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ctx_bits == 8) {
    encode_kernel<false><<<blocks, kThreads, 0, s>>>(
        src, t_len, k, n, ctx_bits, t, st, pl);
  } else {
    const int smem = (256 << ctx_bits) * int(sizeof(int32_t));
    const cudaError_t err = cudaFuncSetAttribute(
        encode_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return int(err);
    encode_kernel<true><<<blocks, kThreads, smem, s>>>(
        src, t_len, k, n, ctx_bits, t, st, pl);
  }
  return int(cudaGetLastError());
}
