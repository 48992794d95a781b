// K1: anchor fingerprints and the local-minimum anchor mask.
//
// Replaces: lrzip_next_tpu/ops/anchor_pallas.py : anchor_fps_pallas
// (kernel _make_kernel).  Per position p < ma it computes the two 32-bit
// tree-hash fingerprints of bytes [p, p+32) (four shared multiply-add
// levels, then two top combinations, all mod 2^32) and keeps fpa where it
// is the minimum, in SIGNED int32 order, of fpa over the centered window
// [p-h, p+h], h = max(stride/2, 1); elsewhere fpa becomes INT32_MAX.
//
// Edge rule (the JAX package's CPU branch, matcher.py
// _anchor_candidates_fporder): window positions at or past ma count as
// INT32_MAX, and for p < h the left half [p-h, p) is left out entirely.
// Inside [h, ma-h) this equals anchor_fps_pallas exactly; the TPU kernel
// differs at the edges because its window reads hashes of zero padding.
//
// Bound on the card (NVIDIA H100 80GB HBM3 at a 700 W power limit, whose
// published HBM bandwidth is 3.35 TB/s): device memory.  Each position
// reads one byte and writes two int32, 9 bytes moved per position: 604 MB
// for the 64 MiB chunk, 0.18 ms.  The kernel this one replaced staged the
// bytes one a thread, hashed every window from shared memory with 32
// byte loads and 30 multiply-adds (two 16-byte tree hashes), and rescanned
// 2h + 1 shared words a position for the window minimum: about 43 shared
// loads a position, so the issue of shared loads (about 0.37 ms at one
// warp-wide load a clock on 132 SMs), not device memory, bound it.  Here:
//   1. one block hashes a span of 8192 positions and writes the 8160 in
//      its middle (a halo of 16 >= h on each side); the span's 8192 + 31
//      bytes come in as one TMA bulk copy (cp.async.bulk, completed on an
//      mbarrier) where the address allows (the spans are cut so that it is
//      16-byte aligned wherever the data pointer is; the size is a multiple
//      of 16), else as 16-byte loads with byte loads only where a vector
//      is not wholly inside [0, nbytes) (lookback.cuh's load16);
//   2. each thread owns P = 32 consecutive positions and reads its 63
//      bytes with four 16-byte shared loads; it rolls the tree levels in
//      registers (level k combines a[x] with a[x + 2^(k-1)], so
//      neighbouring positions share every level): 62 + 60 + 56 + 48
//      multiply-adds for the four levels and 64 for the two top
//      combinations, 9 a position instead of 30;
//   3. the window minimum is a forward minimum over h + 1 positions by
//      doubling in registers (about log2(h) + 1 minima a position), over
//      the thread's 32 fingerprints and h more on each side, read from
//      its neighbours' rows in shared memory; the minimum of [p-h, p+h] is
//      that of [p-h, p] and [p, p+h].  No position rescans 2h + 1 words;
//   4. fpa and fpb go to shared rows of 36 words (32 and 4 of padding, so
//      a quarter-warp's 16-byte stores hit distinct banks), and the block
//      writes its 8160 positions of each with coalesced 16-byte stores.
// h is a template parameter (1, 2, 4, 8, 16), so every register index is
// a constant.  No TPU tile layout (the (nb, 128, 128) blocks with
// neighbour rows) is carried over.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kP = 32;                     // positions a thread
constexpr int kThreads = 256;
constexpr int kSpan = kThreads * kP;       // positions hashed a block
constexpr int kMaxH = 16;                  // stride <= 32
constexpr int kTile = kSpan - 2 * kMaxH;   // positions written a block
constexpr int kHashW = 32;
constexpr int kStage = kSpan + kHashW;     // staged bytes: kSpan + 31, whole
                                           // 16-byte vectors
constexpr int kPitch = kP + 4;             // words of a thread's row
constexpr int kRows = kThreads * kPitch;   // words of s_fpa, of s_fpb
constexpr int kSmem = 2 * kRows * 4 + kStage + 16;

constexpr uint32_t kM0 = 0x9E3779B1u;
constexpr uint32_t kM1 = 0x85EBCA77u;
constexpr uint32_t kM2 = 0xC2B2AE3Du;
constexpr uint32_t kM3 = 0x27D4EB2Fu;
constexpr uint32_t kM4 = 0x165667B1u;

static_assert(kTile % 16 == 0, "spans must keep the data's alignment");
static_assert(kStage % 16 == 0 && kStage >= kSpan + kHashW - 1, "stage");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for the phase of parity `parity` of the mbarrier at `bar`.  A
// phase that never completes is a fault of this kernel: after about 2^26
// polls it traps (a launch error) rather than hanging the card.
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  for (uint32_t i = 0; i < (1u << 26); ++i) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

// n consecutive words from shared memory at `src` (16-byte aligned for n
// a multiple of 4, 8-byte aligned for n = 2) into d[0, n).
template <int n>
__device__ __forceinline__ void load_words(const int32_t* src, int32_t* d) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int i = 0; i < n; i += 4) {
      const int4 v = *reinterpret_cast<const int4*>(src + i);
      d[i] = v.x;
      d[i + 1] = v.y;
      d[i + 2] = v.z;
      d[i + 3] = v.w;
    }
  } else if constexpr (n == 2) {
    const int2 v = *reinterpret_cast<const int2*>(src);
    d[0] = v.x;
    d[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) d[i] = src[i];
  }
}

// g[k] = min(g[k, k + w)) for k <= n - w, in place, by doubling: on entry
// g[k] holds the minimum of the l values from k on.  A recursion over
// compile-time l, so that every index is a constant and g stays in
// registers.
template <int n, int w, int l = 1>
__device__ __forceinline__ void forward_min(int32_t (&g)[n]) {
  if constexpr (2 * l <= w) {
#pragma unroll
    for (int k = 0; k + 2 * l <= n; ++k) g[k] = min(g[k], g[k + l]);
    forward_min<n, w, 2 * l>(g);
  } else if constexpr (l < w) {
#pragma unroll
    for (int k = 0; k + w <= n; ++k) g[k] = min(g[k], g[k + w - l]);
  }
}

// Bit j of the result is set for j in [lo, hi), 0 <= lo, hi <= 32.
__device__ __forceinline__ uint32_t bit_range(int lo, int hi) {
  const uint32_t below_hi = hi >= 32 ? 0xFFFFFFFFu : (1u << hi) - 1u;
  const uint32_t below_lo = lo >= 32 ? 0xFFFFFFFFu : (1u << lo) - 1u;
  return hi > lo ? below_hi & ~below_lo : 0u;
}

__device__ __forceinline__ int clamp_run(int64_t x) {
  return int(x < 0 ? int64_t(0) : x > int64_t(kP) ? int64_t(kP) : x);
}

template <int H>
__global__ void __launch_bounds__(kThreads, 2)
anchor_fps_kernel(const uint8_t* __restrict__ data, int64_t nbytes,
                  int64_t ma, int head, int32_t* __restrict__ fpa_out,
                  int32_t* __restrict__ fpb_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* s_fpa = reinterpret_cast<int32_t*>(smem);
  int32_t* s_fpb = s_fpa + kRows;
  uint8_t* s_bytes = reinterpret_cast<uint8_t*>(s_fpb + kRows);
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_bytes + kStage);
  const int t = threadIdx.x;
  // the block writes positions [start, start + kTile) and hashes
  // [q_lo, q_lo + kSpan); s_bytes[i] = data[q_lo + i], 0 outside
  // [0, nbytes).  The spans are cut `head` bytes early, so data + q_lo is
  // 16-byte aligned.
  const int64_t start = int64_t(blockIdx.x) * kTile - head;
  const int64_t q_lo = start - kMaxH;

  // 1. stage the span's bytes
  if (q_lo >= 0 && q_lo + kStage <= nbytes) {
    const uint32_t bar = smem_addr(s_bar);
    if (t == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
          "r"(kStage)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem_addr(s_bytes)),
          "l"(data + q_lo), "r"(kStage), "r"(bar)
          : "memory");
    }
    __syncthreads();   // the mbarrier is initialised before anyone waits
    wait_phase(bar, 0);
  } else {
    for (int v = t; v < kStage / 16; v += kThreads)
      *reinterpret_cast<uint4*>(s_bytes + 16 * v) =
          lookback::load16(data, q_lo + 16 * v, nbytes);
    __syncthreads();
  }

  // 2. the tree levels of the thread's P positions, rolled in registers
  const int64_t q0 = q_lo + int64_t(kP) * t;   // the thread's first position
  int32_t* row_a = s_fpa + t * kPitch;
  // bit j: position q0 + j lies in [0, ma); in [H, ma) (the edge rule)
  const uint32_t in_range = bit_range(clamp_run(-q0), clamp_run(ma - q0));
  const uint32_t has_left = bit_range(clamp_run(H - q0), kP);
  {
    uint32_t a[kP + kHashW - 1];
    {
      uint32_t w[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(s_bytes + kP * t + 16 * i);
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kP + kHashW - 1; ++i)
        a[i] = (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
    }
#pragma unroll
    for (int x = 0; x < kP + 30; ++x) a[x] = a[x] * kM0 + a[x + 1];
#pragma unroll
    for (int x = 0; x < kP + 28; ++x) a[x] = a[x] * kM1 + a[x + 2];
#pragma unroll
    for (int x = 0; x < kP + 24; ++x) a[x] = a[x] * kM2 + a[x + 4];
#pragma unroll
    for (int x = 0; x < kP + 16; ++x) a[x] = a[x] * kM3 + a[x + 8];
    int32_t* row_b = s_fpb + t * kPitch;
#pragma unroll
    for (int i = 0; i < kP; i += 4) {
      int32_t va[4], vb[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = i + c;
        va[c] = (in_range >> j) & 1u ? int32_t(a[j] * kM4 + a[j + 16])
                                     : INT32_MAX;
        vb[c] = int32_t(a[j] * (kM4 ^ 1u) + a[j + 16]);
      }
      *reinterpret_cast<int4*>(row_a + i) =
          make_int4(va[0], va[1], va[2], va[3]);
      *reinterpret_cast<int4*>(row_b + i) =
          make_int4(vb[0], vb[1], vb[2], vb[3]);
    }
  }
  __syncthreads();

  // 3. the window minimum: g holds fpa at [q0 - H, q0 + kP + H); the
  //    neighbouring rows give the h on each side (INT32_MAX past the
  //    block's span, which only positions outside [start, start + kTile)
  //    would read)
  {
    int32_t g[kP + 2 * H];
    if (t > 0) {
      load_words<H>(row_a - kPitch + kP - H, g);
    } else {
#pragma unroll
      for (int i = 0; i < H; ++i) g[i] = INT32_MAX;
    }
    load_words<kP>(row_a, g + H);
    if (t < kThreads - 1) {
      load_words<H>(row_a + kPitch, g + H + kP);
    } else {
#pragma unroll
      for (int i = 0; i < H; ++i) g[H + kP + i] = INT32_MAX;
    }
    __syncthreads();   // every row read before any is overwritten below
    // g[k] = min of fpa over [q0 + k - H, q0 + k]: the back half of
    // position q0 + k's window at g[k], its front half at g[k + H]
    forward_min<kP + 2 * H, H + 1>(g);
#pragma unroll
    for (int i = 0; i < kP; i += 4) {
      int32_t v[4];
      load_words<4>(row_a + i, v);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = i + c;
        // edge rule: for p < h the left half is left out
        const int32_t m =
            (has_left >> j) & 1u ? min(g[j], g[j + H]) : g[j + H];
        v[c] = v[c] == m ? v[c] : INT32_MAX;
      }
      *reinterpret_cast<int4*>(row_a + i) =
          make_int4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();

  // 4. coalesced stores of positions [lo, hi); position p is word
  //    (j / 32) * kPitch + j % 32 of a row array, j = p - q_lo
  const int64_t lo = start > 0 ? start : 0;
  const int64_t hi = start + kTile < ma ? start + kTile : ma;
  int64_t p_scalar = lo;
  if ((head & 3) == 0) {   // lo and q_lo are multiples of 4
    const int64_t hi4 = lo + ((hi - lo) & ~int64_t(3));
    for (int64_t p = lo + 4 * t; p < hi4; p += 4 * kThreads) {
      const int j = int(p - q_lo);
      const int w = (j >> 5) * kPitch + (j & 31);
      *reinterpret_cast<int4*>(fpa_out + p) =
          *reinterpret_cast<const int4*>(s_fpa + w);
      *reinterpret_cast<int4*>(fpb_out + p) =
          *reinterpret_cast<const int4*>(s_fpb + w);
    }
    p_scalar = hi4;
  }
  for (int64_t p = p_scalar + t; p < hi; p += kThreads) {
    const int j = int(p - q_lo);
    const int w = (j >> 5) * kPitch + (j & 31);
    fpa_out[p] = s_fpa[w];
    fpb_out[p] = s_fpb[w];
  }
}

template <int H>
int launch(const uint8_t* data, int64_t nbytes, int64_t ma, int head,
           int32_t* fpa, int32_t* fpb, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      anchor_fps_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return int(err);
  const int64_t blocks = (ma + head + kTile - 1) / kTile;
  anchor_fps_kernel<H><<<dim3(unsigned(blocks)), kThreads, kSmem, s>>>(
      data, nbytes, ma, head, fpa, fpb);
  return int(cudaGetLastError());
}

}  // namespace

// fpa_out and fpb_out hold ma int32 each and are 16-byte aligned.
extern "C" int lrzt_anchor_fps(const void* data, int64_t nbytes, int64_t ma,
                               int h, void* fpa_out, void* fpb_out,
                               void* stream) {
  if (ma < 0 || ma + kHashW - 1 > nbytes ||
      ((reinterpret_cast<uintptr_t>(fpa_out) |
        reinterpret_cast<uintptr_t>(fpb_out)) & 15u) != 0)
    return int(cudaErrorInvalidValue);
  if (ma == 0) return int(cudaGetLastError());
  const uint8_t* d = static_cast<const uint8_t*>(data);
  const int head = int(reinterpret_cast<uintptr_t>(d) & 15u);
  int32_t* a = static_cast<int32_t*>(fpa_out);
  int32_t* b = static_cast<int32_t*>(fpb_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 1: return launch<1>(d, nbytes, ma, head, a, b, s);
    case 2: return launch<2>(d, nbytes, ma, head, a, b, s);
    case 4: return launch<4>(d, nbytes, ma, head, a, b, s);
    case 8: return launch<8>(d, nbytes, ma, head, a, b, s);
    case 16: return launch<16>(d, nbytes, ma, head, a, b, s);
    default: return int(cudaErrorInvalidValue);
  }
}
