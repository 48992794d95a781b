// K4: sampled (context, symbol) joint histogram of the rANS literal coder.
//
// Replaces: lrzip_next_tpu/ops/rans_pallas.py : joint_histogram_pallas
// (kernel _make_hist_kernel).  The block lies lane-major: lane l holds
// lit[l*T, (l+1)*T).  Over the leading r span positions t < r of every
// lane, position (l, t) counts when l*T + t < n, at
//   counts[ctx][sym],  sym = lit[l*T + t],
//   ctx = t > 0 ? lit[l*T + t - 1] >> (8 - ctx_bits) : 0  (0 if ctx_bits 0).
//
// Bound on the card (NVIDIA H100 80GB HBM3 at a 700 W power limit): the
// atomics, not the bytes.  About 2^20 samples of 1 byte each are read;
// each is one shared-memory atomic increment, and each block adds its
// nonzero counters to the global table once.
//
// The TPU kernel counted with one-hot bf16 matmuls on the MXU (exact,
// products 0/1).  Here integer atomics count exactly, and their order
// does not change the sum, so the result is bit-exact whatever order the
// blocks run in.  The table is (2^ctx_bits, 256) int32: 1 KB, 16 KB or
// 64 KB of shared memory for ctx_bits 0, 4 and 6 (64 KB needs the
// dynamic shared-memory opt-in); at ctx_bits 8 it is 256 KB, more than a
// block may have, so that case adds straight into the global table.
// Samples are walked lane by lane, t fastest, so neighbouring threads
// read neighbouring bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 264;       // two per SM on 132 SMs
constexpr int kSamplesPerBlock = 8192;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* __restrict__ lit, int64_t t_len, int k, int r,
            int64_t n, int ctx_bits, int32_t* __restrict__ counts) {
  extern __shared__ int32_t s_counts[];
  const int cells = 256 << ctx_bits;
  int32_t* table = counts;
  if (kShared) {
    for (int i = threadIdx.x; i < cells; i += kThreads) s_counts[i] = 0;
    __syncthreads();
    table = s_counts;
  }
  const int shift = 8 - ctx_bits;
  const int64_t total = int64_t(k) * r;
  for (int64_t e = int64_t(blockIdx.x) * kThreads + threadIdx.x; e < total;
       e += int64_t(gridDim.x) * kThreads) {
    const int64_t lane = e / r;
    const int64_t t = e - lane * r;
    const int64_t pos = lane * t_len + t;
    if (pos >= n) continue;
    const int sym = lit[pos];
    const int ctx = (ctx_bits && t > 0) ? (lit[pos - 1] >> shift) : 0;
    atomicAdd(&table[(ctx << 8) | sym], 1);
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      const int32_t c = s_counts[i];
      if (c) atomicAdd(&counts[i], c);
    }
  }
}

}  // namespace

// counts must be zeroed by the caller.
extern "C" int lrzt_rans_hist(const void* lit, int64_t t_len, int k, int r,
                              int64_t n, int ctx_bits, void* counts,
                              void* stream) {
  if (t_len <= 0 || k <= 0 || r <= 0 || r > t_len ||
      (ctx_bits != 0 && ctx_bits != 4 && ctx_bits != 6 && ctx_bits != 8))
    return int(cudaErrorInvalidValue);
  const int64_t total = int64_t(k) * r;
  int64_t blocks = (total + kSamplesPerBlock - 1) / kSamplesPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const auto* src = static_cast<const uint8_t*>(lit);
  auto* dst = static_cast<int32_t*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ctx_bits == 8) {
    hist_kernel<false><<<unsigned(blocks), kThreads, 0, s>>>(
        src, t_len, k, r, n, ctx_bits, dst);
  } else {
    const int smem = (256 << ctx_bits) * int(sizeof(int32_t));
    const cudaError_t err = cudaFuncSetAttribute(
        hist_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return int(err);
    hist_kernel<true><<<unsigned(blocks), kThreads, smem, s>>>(
        src, t_len, k, r, n, ctx_bits, dst);
  }
  return int(cudaGetLastError());
}
