// K8a, K8b, K8c: the ragged replay of one chunk, three copy kernels.
//
// Replace: lrzip_next_tpu/ops/replay_ragged.py : _ragged_call (kernel
// _make_kernel), _layered_call (_make_kernel_prior) and _small_call
// (_make_kernel_small).  The host has flattened the chunk's tokens into
// fragments (dst, src, len), absolute byte offsets, each inside one
// destination cell, sorted by dst; frags is a (3, N) int64 table (row 0 the
// dsts, row 1 the srcs, row 2 the lens) and lo the fragment range of every
// cell: cell j owns fragments lo[j] .. lo[j+1].
//
//   K8a ragged:  out[cell j] = 0, then lit[src, src+len) at dst, for the
//                fragments of every 8 KiB cell j; every cell is written whole.
//   K8c small:   out[dst, dst+len) = lit[src, src+len), in place, for the
//                fragments of the touched 1 KiB cells only.
//   K8b layered: buf[dst, dst+len) = buf[src, src+len), in place, for the
//                fragments of the touched 8 KiB cells only; the sources of a
//                pass were completed by earlier passes and no fragment of
//                the pass writes them.
//
// Bound on the card (NVIDIA H100 80GB HBM3): bytes.  Every output byte is
// read once and written once, and a fragment's 24-byte record is read by one
// block or warp; there is no arithmetic beyond addresses.  Fragments of one
// pass have disjoint destinations and read-only sources, so blocks need no
// order and no fence.
//
// Design.  K8a gives one block of 256 threads to a cell: the cell is built in
// 8 KiB of shared memory, zero where no fragment lands, and stored once as
// 16-byte vectors, so the output needs no clearing pass and every global
// store is aligned whatever the fragments' offsets.  Its fragments are longer
// than 512 bytes, enough to keep the block's threads busy on one at a time.
// K8c gives a warp to a touched 1 KiB cell: its fragments are at most 512
// bytes (the median piece of a dense token stream is about a hundred), so a
// block's worth of threads would idle.  K8b is K8c's loop at K8a's width,
// reading the buffer it writes.  Neighbouring threads copy neighbouring bytes,
// so a warp's loads and stores coalesce into 32-byte sectors at any
// misalignment of source against destination.
//
// The TPU kernels' int32-per-byte staging, lead and trail padding rows,
// 16-row DMA windows at 8-aligned rows, row and lane rolls and masked merges
// exist because that machine has no byte-granular addressing; here a thread
// loads the byte.  Nothing is read or written outside the tensors whatever
// the table holds: a source byte outside its tensor reads as 0 in K8a and is
// skipped in K8b and K8c, and a destination outside its cell or tensor is
// skipped.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCellBits = 13;
constexpr int kCell = 1 << kCellBits;
constexpr int kCellVecs = kCell / 16;
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ int64_t clamp_index(int64_t v, int64_t n) {
  return v < 0 ? 0 : (v > n ? n : v);
}

__global__ void __launch_bounds__(kThreads)
ragged_kernel(const uint8_t* __restrict__ lit, int64_t lit_len,
              const int64_t* __restrict__ frags, int64_t n_frags,
              const int64_t* __restrict__ lo, uint8_t* __restrict__ out) {
  __shared__ uint4 s_cell[kCellVecs];
  uint8_t* cell = reinterpret_cast<uint8_t*>(s_cell);
  const int tid = threadIdx.x;
  for (int i = tid; i < kCellVecs; i += kThreads)
    s_cell[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const int64_t base = int64_t(blockIdx.x) << kCellBits;
  const int64_t f0 = clamp_index(lo[blockIdx.x], n_frags);
  const int64_t f1 = clamp_index(lo[blockIdx.x + 1], n_frags);
  for (int64_t i = f0; i < f1; ++i) {
    const int64_t d = frags[i] - base;
    const int64_t s = frags[n_frags + i];
    const int64_t len = frags[2 * n_frags + i];
    if (d < 0 || len <= 0 || len > kCell || d + len > kCell) continue;
    for (int64_t t = tid; t < len; t += kThreads) {
      const int64_t p = s + t;
      cell[d + t] = (p >= 0 && p < lit_len) ? __ldg(lit + p) : uint8_t(0);
    }
  }
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(out + base);
  for (int i = tid; i < kCellVecs; i += kThreads) dst[i] = s_cell[i];
}

// The fragments f0 .. f1 copied by `width` threads, this one being `tid`.
__device__ __forceinline__ void copy_fragments(
    const uint8_t* src_buf, int64_t src_len, const int64_t* __restrict__ frags,
    int64_t n_frags, int64_t f0, int64_t f1, uint8_t* out, int64_t out_len,
    int tid, int width) {
  for (int64_t i = f0; i < f1; ++i) {
    const int64_t d = frags[i];
    const int64_t s = frags[n_frags + i];
    const int64_t len = frags[2 * n_frags + i];
    if (d < 0 || s < 0 || len <= 0 || len > out_len - d || len > src_len - s)
      continue;
    for (int64_t t = tid; t < len; t += width) out[d + t] = src_buf[s + t];
  }
}

__global__ void __launch_bounds__(kThreads)
small_kernel(const uint8_t* __restrict__ lit, int64_t lit_len,
             const int64_t* __restrict__ frags, int64_t n_frags,
             const int64_t* __restrict__ lo, int64_t n_touched,
             uint8_t* __restrict__ out, int64_t out_len) {
  const int64_t j = int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (j >= n_touched) return;
  copy_fragments(lit, lit_len, frags, n_frags, clamp_index(lo[j], n_frags),
                 clamp_index(lo[j + 1], n_frags), out, out_len,
                 threadIdx.x & 31, 32);
}

// buf is read and written: no __restrict__.
__global__ void __launch_bounds__(kThreads)
layered_kernel(uint8_t* buf, int64_t buf_len,
               const int64_t* __restrict__ frags, int64_t n_frags,
               const int64_t* __restrict__ lo) {
  const int64_t j = blockIdx.x;
  copy_fragments(buf, buf_len, frags, n_frags, clamp_index(lo[j], n_frags),
                 clamp_index(lo[j + 1], n_frags), buf, buf_len, threadIdx.x,
                 kThreads);
}

constexpr int64_t kMaxGrid = 0x7FFFFFFF;

}  // namespace

// out holds n_cells * 8192 bytes, lo n_cells + 1 entries.
extern "C" int lrzt_replay_ragged(const void* lit, int64_t lit_len,
                                  const void* frags, int64_t n_frags,
                                  const void* lo, int64_t n_cells, void* out,
                                  void* stream) {
  if (lit_len < 0 || n_frags < 0 || n_cells < 1 || n_cells > kMaxGrid)
    return int(cudaErrorInvalidValue);
  ragged_kernel<<<unsigned(n_cells), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(lit), lit_len,
      static_cast<const int64_t*>(frags), n_frags,
      static_cast<const int64_t*>(lo), static_cast<uint8_t*>(out));
  return int(cudaGetLastError());
}

// lo holds n_touched + 1 entries.
extern "C" int lrzt_replay_small(const void* lit, int64_t lit_len,
                                 const void* frags, int64_t n_frags,
                                 const void* lo, int64_t n_touched, void* out,
                                 int64_t out_len, void* stream) {
  const int64_t blocks = (n_touched + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (lit_len < 0 || n_frags < 0 || out_len < 0 || n_touched < 1 ||
      blocks > kMaxGrid)
    return int(cudaErrorInvalidValue);
  small_kernel<<<unsigned(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(lit), lit_len,
      static_cast<const int64_t*>(frags), n_frags,
      static_cast<const int64_t*>(lo), n_touched, static_cast<uint8_t*>(out),
      out_len);
  return int(cudaGetLastError());
}

// lo holds n_touched + 1 entries.
extern "C" int lrzt_replay_layered(void* buf, int64_t buf_len,
                                   const void* frags, int64_t n_frags,
                                   const void* lo, int64_t n_touched,
                                   void* stream) {
  if (buf_len < 0 || n_frags < 0 || n_touched < 1 || n_touched > kMaxGrid)
    return int(cudaErrorInvalidValue);
  layered_kernel<<<unsigned(n_touched), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(buf), buf_len, static_cast<const int64_t*>(frags),
      n_frags, static_cast<const int64_t*>(lo));
  return int(cudaGetLastError());
}
