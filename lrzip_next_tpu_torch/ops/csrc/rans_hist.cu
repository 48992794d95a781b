// K4: sampled (context, symbol) joint histogram of the rANS literal coder.
//
// Replaces: lrzip_next_tpu/ops/rans_pallas.py : joint_histogram_pallas
// (kernel _make_hist_kernel).  The block lies lane-major: lane l holds
// lit[l*T, (l+1)*T).  Over the leading r span positions t < r of every
// lane, position (l, t) counts when l*T + t < n, at
//   counts[ctx][sym],  sym = lit[l*T + t],
//   ctx = t > 0 ? lit[l*T + t - 1] >> (8 - ctx_bits) : 0  (0 if ctx_bits 0).
//
// The TPU kernel counted with one-hot bf16 matmuls on the MXU (exact,
// products 0/1).  Here integer atomics count exactly, and their order
// does not change the sum, so the result is bit-exact whatever order the
// blocks run in.
//
// Bound on the card (NVIDIA H100 80GB HBM3 at a 700 W power limit): not
// the bytes (the main path's 2^20 one-byte samples and its 64 KB table
// take 0.0003 ms at 3.35 TB/s) but the launch and the atomics: a
// shared-memory atomic a sample, and each CTA's table read and added to
// the output once.  The design:
//   - one C call: a cudaMemsetAsync of the output and one launch; the
//     kernel's attributes are set once a process and device;
//   - samples: a work item is one 16-byte vector of a lane's samples, on
//     the 16-byte grid of the lane's address; an item wholly inside the
//     lane's counted positions is one 16-byte load, any other is read
//     byte by byte.  Each sample's context is the previous byte in
//     registers; the item's first context is one byte load (0 at t = 0,
//     never the previous lane's byte).  No 64-bit division;
//   - the table: each CTA counts its samples into its own copy in shared
//     memory, two 16-bit counters a word (128 KB at ctx_bits 8, 32 KB at
//     6), so every sample is one shared-memory atomic, at ctx_bits 8 too
//     (an int32 table of 256 KB would not fit a CTA).  The grid is at
//     most kMaxCtas CTAs, grown where a thread would take more than
//     kMaxItems vectors, so no CTA takes 2^16 samples and no counter
//     overflows;
//   - flush: each CTA adds its copy's nonzero cells to the zeroed output
//     with one global atomic a cell.
// The variants measured and not kept are in PERF.md section 6.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSamples = 65535;  // a CTA's, below 16-bit overflow
constexpr int kMaxCtas = 128;       // the grid, unless kMaxItems binds
constexpr int kMaxItems = 7;        // 16-byte vectors a thread at most
static_assert(kMaxItems * kThreads * 16 <= kMaxSamples,
              "a CTA's samples must stay below 2^16");

__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* __restrict__ lit, int64_t t_len, int items,
            int vecs, int r, int64_t n, int shift, int cells,
            int32_t* __restrict__ counts) {
  // the CTA's copy of the table: two 16-bit counters a word, cell c in
  // half c & 1 of word c >> 1
  extern __shared__ __align__(16) uint32_t s_table[];
  const int words = cells / 2;
  for (int i = threadIdx.x; i < words / 4; i += kThreads)
    reinterpret_cast<uint4*>(s_table)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const uintptr_t base = reinterpret_cast<uintptr_t>(lit);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < items;
       i += gridDim.x * kThreads) {
    const int lane = i / vecs;
    const int64_t lane0 = int64_t(lane) * t_len;
    // vector i - lane * vecs of the lane's 16-byte grid
    const int t0 = 16 * (i - lane * vecs) - int((base + lane0) & 15u);
    const int64_t lim = n - lane0 < r ? n - lane0 : r;  // counted: t < lim
    if (t0 >= lim) continue;
    int prev = t0 > 0 ? lit[lane0 + t0 - 1] : 0;
    unsigned w[4] = {0u, 0u, 0u, 0u};
    unsigned valid = 0xFFFFu;
    if (t0 >= 0 && t0 + 16 <= lim) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(lit + lane0 + t0));
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {   // the lane's unaligned head, or the end of its samples
      valid = 0u;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int t = t0 + j;
        if (t >= 0 && t < lim) {
          w[j >> 2] |= unsigned(lit[lane0 + t]) << (8 * (j & 3));
          valid |= 1u << j;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int sym = int((w[j >> 2] >> (8 * (j & 3))) & 0xFFu);
      if ((valid >> j) & 1u) {
        const int cell = ((prev >> shift) << 8) | sym;
        atomicAdd(s_table + (cell >> 1), 1u << (16 * (cell & 1)));
      }
      prev = sym;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < words; q += kThreads) {
    const uint32_t v = s_table[q];
    if (v & 0xFFFFu) atomicAdd(counts + 2 * q, int(v & 0xFFFFu));
    if (v >> 16) atomicAdd(counts + 2 * q + 1, int(v >> 16));
  }
}

int smem_optin = 0;   // the device's per-block shared-memory limit

// The kernel's attributes, once a process and device.
cudaError_t configure() {
  static std::mutex mu;
  static uint64_t done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(mu);
  if (dev < 64 && ((done >> dev) & 1u)) return cudaSuccess;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(hist_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_optin);
  if (err != cudaSuccess) return err;
  if (dev < 64) done |= uint64_t(1) << dev;
  return cudaSuccess;
}

}  // namespace

// K4 into counts ((256 << ctx_bits) int32 on the device), which the call
// zeroes and the kernel adds into.
extern "C" int lrzt_rans_hist(const void* lit, int64_t t_len, int k, int r,
                              int64_t n, int ctx_bits, void* counts,
                              void* stream) {
  if (t_len <= 0 || k <= 0 || r <= 0 || r > t_len ||
      (ctx_bits != 0 && ctx_bits != 4 && ctx_bits != 6 && ctx_bits != 8))
    return int(cudaErrorInvalidValue);
  // vectors of a lane's 16-byte grid that hold its r samples
  const int64_t head = t_len % 16 == 0
                           ? int64_t(reinterpret_cast<uintptr_t>(lit) & 15u)
                           : 15;
  const int64_t vecs = (head + r + 15) / 16;
  const int64_t items = int64_t(k) * vecs;
  if (items >= (int64_t(1) << 31)) return int(cudaErrorInvalidValue);
  // a thread a vector, at most kMaxCtas CTAs unless a thread would take
  // more than kMaxItems vectors
  const int64_t ctas = std::max(
      std::min<int64_t>((items + kThreads - 1) / kThreads, kMaxCtas),
      (items + kThreads * kMaxItems - 1) / (kThreads * kMaxItems));
  cudaError_t err = configure();
  if (err != cudaSuccess) return int(err);
  const int cells = 256 << ctx_bits;
  const int smem = cells / 2 * int(sizeof(uint32_t));
  if (smem > smem_optin) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(counts, 0, size_t(cells) * sizeof(int32_t), s);
  if (err != cudaSuccess) return int(err);
  hist_kernel<<<unsigned(ctas), kThreads, smem, s>>>(
      static_cast<const uint8_t*>(lit), t_len, int(items), int(vecs), r, n,
      8 - ctx_bits, cells, static_cast<int32_t*>(counts));
  return int(cudaGetLastError());
}
