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
// Bound on the card (NVIDIA H100 80GB HBM3, 700 W power limit): the
// dependent chain of T steps a lane, not bytes (the block in, the (T, K)
// int32 plane out: 0.031 ms at the 64 MiB chunk's K = 16384, T = 1280).
// The K lanes are the only parallelism (the chains are independent), so
// more threads can not help: one thread a lane, 128-thread blocks, about
// one block of four warps an SM, one warp a scheduler, and nothing hides a
// latency.  So the design shortens what each step waits on:
// - Bytes: a lane's bytes are loaded 16 at a time, back to front, one
//   16-byte load per 16 steps where T % 16 == 0 and the block is 16-byte
//   aligned (byte loads otherwise), two groups ahead of the chain; the
//   context byte of a group's first position is the last byte of the group
//   below, which is already loaded.
// - Table entries: a first launch packs the frequencies into one int32
//   entry a (context, symbol), cum * 4096 + (f - 1), a block-wide scan a
//   row; the 16 packed entries of a group and their reciprocals
//   depend only on the bytes, not on x, so they are looked up one group
//   ahead of the state chain: the packed table from shared memory at
//   ctx_bits <= 6 (64 KB at 6) and from global memory, held in L2, at
//   ctx_bits 8 (256 KB); the reciprocals from shared memory.
// - Division: x / f is a multiply by R = ceil(2^64 / f), q = (x * R) >> 64,
//   exact for every x < 2^32 and f <= 4096 (x * R / 2^64 exceeds x / f by
//   less than 2^-32, and the fraction of x / f is at most 1 - 1/f).  The
//   reciprocal depends on f alone, so one 4096-entry table (32 KB, shared
//   memory) serves every context: row f-1 holds R's low word and its high
//   word less one, so that f = 1 (R = 2^64) fits too, and
//   q = (x * (hi - 1) + x + umulhi(x, lo)) >> 32.  The remainder folds in:
//   x' = q * 4096 + cum + (x - q * f) = x + q * (4096 - f) + cum.
// The (T, K) plane store stays coalesced across lanes.
//
// The TPU kernel fetched (f, cum) with two-level one-hot bf16 matmuls and
// divided with two exact f32 divisions plus a +-1 fixup.  Here the table
// is an int32 load and the division an integer multiply; both give the
// same integers.  f <= 3841 for every table quantize_freqs makes, so
// f << 20 fits in 32 bits (it wraps as on the TPU otherwise).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 16;       // span positions looked up together
constexpr uint32_t kM = 4096;
constexpr uint32_t kLInit = 1u << 16;
constexpr int kRcpBytes = 4096 * 8;  // reciprocals of f = 1 .. 4096

struct Bytes {
  uint32_t w[4];  // byte j of the group in w[j / 4] at bit 8 * (j % 4)
};

struct Entry {
  uint32_t v;    // cum * 4096 + (f - 1)
  uint32_t lo;   // low word of R = ceil(2^64 / f)
  uint32_t hi1;  // high word of R, less one
};

__device__ __forceinline__ uint32_t byte_at(const Bytes& b, int j) {
  return (b.w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
}

// span[base, base + 16); positions below 0 read as 0
template <bool kVec>
__device__ __forceinline__ Bytes load_group(const uint8_t* span,
                                            int64_t base) {
  Bytes b = {{0u, 0u, 0u, 0u}};
  if (kVec) {
    if (base >= 0) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(span + base));
      b.w[0] = v.x;
      b.w[1] = v.y;
      b.w[2] = v.z;
      b.w[3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if (base + j >= 0)
        b.w[j >> 2] |= uint32_t(__ldg(span + base + j)) << (8 * (j & 3));
  }
  return b;
}

// the entries of a group's 16 positions; `below` is the group under it,
// whose last byte is the context of the group's first position
template <bool kShared>
__device__ __forceinline__ void lookup_group(
    const Bytes& cur, const Bytes& below, int shift,
    const int32_t* __restrict__ table, const uint2* __restrict__ rcp,
    Entry* out) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const uint32_t prev = j ? byte_at(cur, j - 1) : byte_at(below, kGroup - 1);
    const uint32_t idx = ((prev >> shift) << 8) | byte_at(cur, j);
    const uint32_t v =
        kShared ? uint32_t(table[idx]) : uint32_t(__ldg(table + idx));
    const uint2 r = rcp[v & (kM - 1)];
    out[j] = Entry{v, r.x, r.y};
  }
}

template <bool kShared, bool kVec>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const uint8_t* __restrict__ lit, int64_t t_len, int k,
              int64_t n, int ctx_bits, const int32_t* __restrict__ tab,
              const uint2* __restrict__ rcp_g, uint32_t* __restrict__ states,
              int32_t* __restrict__ plane) {
  extern __shared__ uint4 s_mem[];
  const uint4* rsrc = reinterpret_cast<const uint4*>(rcp_g);
  for (int i = threadIdx.x; i < kRcpBytes / 16; i += kThreads)
    s_mem[i] = rsrc[i];
  const uint2* rcp = reinterpret_cast<const uint2*>(s_mem);
  const int32_t* table = tab;
  if (kShared) {
    uint4* dst = s_mem + kRcpBytes / 16;
    const uint4* src = reinterpret_cast<const uint4*>(tab);
    const int vecs = (256 << ctx_bits) / 4;
    for (int i = threadIdx.x; i < vecs; i += kThreads) dst[i] = src[i];
    table = reinterpret_cast<const int32_t*>(dst);
  }
  __syncthreads();
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= k) return;
  const int shift = 8 - ctx_bits;  // 8: every context is 0
  const uint8_t* span = lit + int64_t(lane) * t_len;
  const int64_t real = n - int64_t(lane) * t_len;  // t < real is real
  const int64_t groups = (t_len + kGroup - 1) / kGroup;
  // group g holds positions [t_len - 16 (g + 1), t_len - 16 g)
  Bytes nxt = load_group<kVec>(span, t_len - 2 * kGroup);
  Bytes nn = load_group<kVec>(span, t_len - 3 * kGroup);
  Entry cur_e[kGroup], nxt_e[kGroup];
  lookup_group<kShared>(load_group<kVec>(span, t_len - kGroup), nxt, shift,
                        table, rcp, cur_e);
  uint32_t x = kLInit;
  for (int64_t g = 0; g < groups; ++g) {
    const int64_t base = t_len - kGroup * (g + 1);
    const Bytes n3 = load_group<kVec>(span, base - 3 * kGroup);
    lookup_group<kShared>(nxt, nn, shift, table, rcp, nxt_e);
#pragma unroll
    for (int j = kGroup - 1; j >= 0; --j) {
      const int64_t t = base + j;
      if (t < 0) break;
      int32_t out = 0;
      if (t < real) {
        const Entry e = cur_e[j];
        const uint32_t f = (e.v & (kM - 1)) + 1;
        if (x >= (f << 20)) {
          out = int32_t((x & 0xFFFFu) | 0x10000u);
          x >>= 16;
        }
        const uint32_t p = __umulhi(x, e.lo);
        const uint64_t w = uint64_t(x) * e.hi1 + (uint64_t(x) + p);
        const uint32_t q = uint32_t(w >> 32);
        x += q * (kM - f) + (e.v >> 12);
      }
      plane[t * k + lane] = out;
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) cur_e[j] = nxt_e[j];
    nxt = nn;
    nn = n3;
  }
  states[lane] = x;
}

// Row c of the packed table from row c of the frequencies, one thread an
// entry: tab = cum * 4096 + (f - 1), cum the exclusive prefix of the row
// (uint32 arithmetic: the low 32 bits of the plain version's int64 sums).
__global__ void __launch_bounds__(256)
pack_table_kernel(const int32_t* __restrict__ freqs,
                  int32_t* __restrict__ tab) {
  __shared__ uint32_t s_warp[8];
  const int i = blockIdx.x * 256 + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t f = uint32_t(freqs[i]);
  uint32_t incl = f;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t u = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  uint32_t cum = incl - f;
  for (int w = 0; w < warp; ++w) cum += s_warp[w];
  tab[i] = int32_t(cum * kM + f - 1u);
}

template <bool kShared, bool kVec>
int launch(unsigned blocks, int smem, const uint8_t* lit, int64_t t_len,
           int k, int64_t n, int ctx_bits, const int32_t* tab,
           const uint2* rcp, uint32_t* st, int32_t* pl, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      encode_kernel<kShared, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  encode_kernel<kShared, kVec><<<blocks, kThreads, smem, s>>>(
      lit, t_len, k, n, ctx_bits, tab, rcp, st, pl);
  return int(cudaGetLastError());
}

}  // namespace

// freqs: (2^ctx_bits, 256) int32; tab: a workspace of the same shape,
// 16-byte aligned, that receives the packed table; rcp: the (4096, 2)
// reciprocals.
extern "C" int lrzt_rans_encode(const void* lit, int64_t t_len, int k,
                                int64_t n, int ctx_bits, const void* freqs,
                                void* tab, const void* rcp, void* states,
                                void* plane, void* stream) {
  if (t_len <= 0 || k <= 0 ||
      (ctx_bits != 0 && ctx_bits != 4 && ctx_bits != 6 && ctx_bits != 8) ||
      reinterpret_cast<uintptr_t>(tab) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(rcp) % 16 != 0)
    return int(cudaErrorInvalidValue);
  const unsigned blocks = unsigned((k + kThreads - 1) / kThreads);
  const auto* src = static_cast<const uint8_t*>(lit);
  const auto* t = static_cast<const int32_t*>(tab);
  const auto* r = static_cast<const uint2*>(rcp);
  auto* st = static_cast<uint32_t*>(states);
  auto* pl = static_cast<int32_t*>(plane);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pack_table_kernel<<<1u << ctx_bits, 256, 0, s>>>(
      static_cast<const int32_t*>(freqs), static_cast<int32_t*>(tab));
  const bool vec =
      t_len % kGroup == 0 && reinterpret_cast<uintptr_t>(lit) % 16 == 0;
  if (ctx_bits == 8) {
    return vec ? launch<false, true>(blocks, kRcpBytes, src, t_len, k, n,
                                     ctx_bits, t, r, st, pl, s)
               : launch<false, false>(blocks, kRcpBytes, src, t_len, k, n,
                                      ctx_bits, t, r, st, pl, s);
  }
  const int smem = kRcpBytes + (256 << ctx_bits) * int(sizeof(int32_t));
  return vec ? launch<true, true>(blocks, smem, src, t_len, k, n, ctx_bits, t,
                                  r, st, pl, s)
             : launch<true, false>(blocks, smem, src, t_len, k, n, ctx_bits,
                                   t, r, st, pl, s);
}
