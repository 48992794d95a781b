// K7: the K-lane interleaved rANS decode, run forward over the span, its
// lanes spread over one thread-block cluster.
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
// Bound on the card (NVIDIA H100 80GB HBM3, 700 W power limit): neither
// bytes nor operations but the dependent chain.  Step t+1's word offsets
// depend on the count of every lane's step t, so the T steps are serial,
// and each needs a prefix over all K lanes: the stream carries no per-group
// counts and the word order is fixed, so the lanes are one prefix domain a
// step and can not be split into independent launches.  The bytes (2 per
// word in, 1 per symbol out) would take about 0.011 ms at the 64 MiB
// chunk's shapes (K = 16384, T = 1280); 1280 steps at the 64-lane step of
// the single-block design (0.91 us) take 1.16 ms.
//
// Design: the lanes of a step are spread over one cluster of C CTAs, so
// that C SMs, not one, do the lane work.  K <= 1024: one CTA of K threads
// (C = 1).  K >= 2048: C = K / 1024 CTAs of 1024 threads, one lane a
// thread (C = 16 at K = 16384, a non-portable cluster size); where 16 such
// CTAs can not be resident at once, C = 8 with 2 lanes a thread; where
// neither can, the caller raises (lrzt_rans_decode_cluster reports C = 0).
// CTA r owns lanes [r K/C, (r+1) K/C), thread j of it kLanes consecutive
// ones from there, states in registers, so the order inside a CTA is lane
// order.  Every CTA builds its own copy of the cumulative table from the
// frequencies ((C, 257) uint16, 32 KB at ctx_bits 6, 128.5 KB at ctx_bits
// 8, opt-in dynamic shared memory, a warp scan a row), searched with an
// 8-step binary search.  One step:
//   1. every lane decodes its symbol and notes whether it renormalises;
//   2. a ballot and a popcount per lane slot count the warp's lanes below
//      each thread; the warp totals go through shared memory, and two warp
//      reductions (__reduce_add_sync) give the lower warps' sum and the
//      CTA total;
//   3. thread i < C stores the CTA total into slot [t & 1][r] of CTA i's
//      shared memory (st.async), which counts its 4 bytes on CTA i's
//      mbarrier [t & 1]; thread 0 arms the CTA's own mbarrier [t & 1] for
//      C totals (mbarrier.arrive.expect_tx);
//   4. every thread waits for that phase of its CTA's mbarrier: the C
//      totals of step t are in its own shared memory;
//   5. lane i < C of every warp reads slot i; two warp reductions give the
//      totals of the lower ranks and of the whole cluster;
//   6. the thread's first word is at ptr + (lower ranks) + (lower warps of
//      the CTA) + (lower threads of the warp); ptr += the cluster total.
// No cluster-wide barrier a step: each CTA waits only for the C stores it
// needs.  Two slots and two mbarriers make that safe: slot and mbarrier b
// serve steps t, t+2, ...; CTA A stores for step t+2 only after its wait
// of step t+1 completed, which needs every CTA B's step-(t+1) store, and B
// makes that only after it has read its slots of step t (its step-(t+1)
// total depends on them) and seen its mbarrier b complete step t's phase.
// So no store overwrites a slot still to be read or lands in an earlier
// phase.  The warp totals s_tot[t & 1] and the __syncthreads() between
// their write and their reads follow the same argument inside a CTA.  A
// cluster barrier after the mbarriers are initialised comes before any
// store, and a last one keeps every CTA alive until the others' stores to
// it are done.  (On an NVIDIA H100 80GB HBM3 at a 700 W limit, with one
// cluster barrier a step and the totals read through distributed shared
// memory, the step took 4.0 us at C = 16, against 1.9 us this way.)  The words a step can reach lie in
// [ptr, ptr + K); each warp asks L2 to prefetch its share of
// [ptr + 2K, ptr + 3K), so the word loads of a step hit L2.  The lane's
// context is the top byte of its 4-symbol output word, which is stored once
// every 4 steps when T is a multiple of 4 (bytes otherwise).
//
// The TPU kernel's (8, K/8) tiles, bf16 one-hot table fetches, coarse
// 4-entry table, 72-row DMA window and log-shift routing network are not
// carried over: integer loads from shared memory, a search, and a native
// gather words[ptr + rank] give the same integers.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kRow = 257;  // cumulative entries per context
constexpr uint32_t kLInit = 1u << 16;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the address of the same shared variable in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
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

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <int kLanes>
__global__ void __launch_bounds__(kMaxThreads)
decode_kernel(const uint16_t* __restrict__ words, int64_t n_words,
              const uint32_t* __restrict__ states_in,
              const int32_t* __restrict__ freqs, int64_t n, int ctx_bits,
              int64_t t_len, uint8_t* __restrict__ plane,
              uint32_t* __restrict__ states_out) {
  extern __shared__ uint16_t s_cum[];
  __shared__ int s_tot[2][32];
  __shared__ int s_all[2][kMaxCluster];              // the CTA totals
  __shared__ __align__(8) uint64_t s_bar[2];         // their mbarriers
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = int(cluster.dim_blocks().x);
  const int rank = int(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane_in_warp = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  // the cumulative table, row c the exclusive prefix of freqs[c] and then
  // its total, in uint16 (the low 16 bits of the sums): warp w builds rows
  // w, w + n_warps, ..., lane i the entries from 8 i
  for (int c = warp; c < (1 << ctx_bits); c += n_warps) {
    const int32_t* f = freqs + c * 256 + 8 * lane_in_warp;
    int32_t v[8];
    uint32_t sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = __ldg(f + j);
      sum += uint32_t(v[j]);
    }
    uint32_t incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t u = __shfl_up_sync(kFull, incl, d);
      if (lane_in_warp >= d) incl += u;
    }
    uint32_t run = incl - sum;
    uint16_t* row = s_cum + c * kRow + 8 * lane_in_warp;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      row[j] = uint16_t(run);
      run += uint32_t(v[j]);
    }
    if (lane_in_warp == 31) row[8] = uint16_t(run);
  }

  const unsigned lanes_below = (1u << lane_in_warp) - 1u;
  const int64_t k = int64_t(n_cta) * blockDim.x * kLanes;
  const int64_t lane0 = (int64_t(rank) * blockDim.x + tid) * kLanes;
  // lanes below n / T are real at every t, lane n / T for t < n % T, the
  // lanes above it never
  const int64_t full_lanes = n / t_len - lane0;
  const int64_t part_t = n % t_len;
  const int shift = 8 - ctx_bits;
  const bool word_store = (t_len & 3) == 0;
  // this warp's share of a K-word prefetch window
  const int64_t warp_words =
      (int64_t(rank) * n_warps + warp) * 32 * kLanes;

  uint32_t x[kLanes];
  uint32_t pack[kLanes];  // the lane's last 4 symbols, newest in the top byte
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    x[j] = states_in[lane0 + j];
    pack[j] = 0;
  }
  // a warp's share is 64 * kLanes bytes: one 32-byte sector a lane
  const int64_t sector = lane_in_warp * 16;
  if (lane_in_warp < 2 * kLanes) {
    for (int64_t a = warp_words + sector; a < 2 * k; a += k)
      if (a < n_words) prefetch_l2(words + a);
  }
  if (tid == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          smem_addr(&s_bar[b])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // every CTA has started and armed its mbarriers before any store to it
  if (n_cta > 1) cluster.sync();

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

    // exclusive prefix of the renormalising lanes over the CTA: in the
    // warp a ballot and a popcount per lane slot, then the warp totals
    // through shared memory and two warp reductions
    int below = 0, wtotal = 0;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const unsigned b = __ballot_sync(kFull, (takes >> j) & 1u);
      below += __popc(b & lanes_below);
      wtotal += __popc(b);
    }
    int* tot = s_tot[t & 1];
    if (lane_in_warp == 0) tot[warp] = wtotal;
    __syncthreads();
    const int mine = lane_in_warp < n_warps ? tot[lane_in_warp] : 0;
    const int before =
        __reduce_add_sync(kFull, lane_in_warp < warp ? mine : 0);
    const int cta_total = __reduce_add_sync(kFull, mine);
    int64_t at = ptr + before + below;
    int step_total = cta_total;
    if (n_cta > 1) {
      // ... and over the cluster: thread i < C stores the CTA total into
      // slot [b][rank] of CTA i, counted on CTA i's mbarrier b; thread 0
      // arms the local mbarrier b for the C totals; all wait for them
      const int b = int(t & 1);
      const uint32_t bar = smem_addr(&s_bar[b]);
      if (tid == 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                bar),
            "r"(4 * n_cta)
            : "memory");
      if (tid < n_cta)
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 "
            "[%0], %1, [%2];" ::"r"(
                cluster_addr(smem_addr(&s_all[b][rank]), tid)),
            "r"(cta_total), "r"(cluster_addr(bar, tid))
            : "memory");
      wait_phase(bar, uint32_t(t >> 1) & 1u);
      const int v = lane_in_warp < n_cta ? s_all[b][lane_in_warp] : 0;
      at += __reduce_add_sync(kFull, lane_in_warp < rank ? v : 0);
      step_total = __reduce_add_sync(kFull, v);
    }

#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      if (takes & (1u << j)) {
        const uint32_t w = at < n_words ? uint32_t(__ldg(words + at)) : 0u;
        x[j] = (x[j] << 16) | w;
        ++at;
      }
    }
    ptr += step_total;
    if (lane_in_warp < 2 * kLanes) {
      const int64_t a = ptr + 2 * k + warp_words + sector;
      if (a < n_words) prefetch_l2(words + a);
    }

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
  if (n_cta > 1) cluster.sync();  // no CTA leaves with a store in flight
}

int table_bytes(int ctx_bits) {  // the cumulative table in shared memory
  return (kRow << ctx_bits) * int(sizeof(uint16_t));
}

template <int kLanes>
cudaError_t configure(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<kLanes>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(decode_kernel<kLanes>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

cudaLaunchConfig_t launch_config(int ctas, int threads, int smem,
                                 cudaStream_t s, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = unsigned(ctas);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(ctas));
  cfg.blockDim = dim3(unsigned(threads));
  cfg.dynamicSmemBytes = size_t(smem);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Whether one cluster of `ctas` CTAs of `threads` threads with the table in
// shared memory can be resident on this device.
template <int kLanes>
bool fits(int ctas, int threads, int smem) {
  if (configure<kLanes>(smem) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(ctas, threads, smem, 0, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, decode_kernel<kLanes>,
                                     &cfg) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return clusters > 0;
}

bool valid_shape(int k, int ctx_bits) {
  return k >= 64 && k <= 16384 && (k & (k - 1)) == 0 &&
         (ctx_bits == 0 || ctx_bits == 4 || ctx_bits == 6 || ctx_bits == 8);
}

}  // namespace

// The cluster size K7 takes for K lanes on the current device: 1 for
// K <= 1024; K / 1024 where that many CTAs of 1024 threads fit; 8 (two lanes
// a thread) where K = 16384 and 16 do not; 0 where nothing fits.
extern "C" int lrzt_rans_decode_cluster(int k, int ctx_bits, int* ctas) {
  *ctas = 0;
  if (!valid_shape(k, ctx_bits)) return int(cudaErrorInvalidValue);
  const int smem = table_bytes(ctx_bits);
  if (k <= kMaxThreads) {
    if (fits<1>(1, k, smem)) *ctas = 1;
  } else if (fits<1>(k / kMaxThreads, kMaxThreads, smem)) {
    *ctas = k / kMaxThreads;
  } else if (k / kMaxThreads == kMaxCluster &&
             fits<2>(kMaxCluster / 2, kMaxThreads, smem)) {
    *ctas = kMaxCluster / 2;
  }
  return 0;
}

extern "C" int lrzt_rans_decode(const void* words, int64_t n_words,
                                const void* states_in, const void* freqs,
                                int64_t n, int ctx_bits, int64_t t_len, int k,
                                int ctas, void* plane, void* states_out,
                                void* stream) {
  if (t_len <= 0 || n < 0 || n_words < 0 || !valid_shape(k, ctx_bits) ||
      ctas < 1 || ctas > kMaxCluster || (ctas & (ctas - 1)) != 0 ||
      k % ctas != 0)
    return int(cudaErrorInvalidValue);
  const int per_cta = k / ctas;
  const int threads = per_cta < kMaxThreads ? per_cta : kMaxThreads;
  const int lanes = per_cta / threads;
  // one CTA holds every lane only up to K = 1024; at most 2 lanes a thread
  if ((ctas == 1 && k > kMaxThreads) || lanes > 2)
    return int(cudaErrorInvalidValue);
  const int smem = table_bytes(ctx_bits);
  const auto* w = static_cast<const uint16_t*>(words);
  const auto* si = static_cast<const uint32_t*>(states_in);
  const auto* c = static_cast<const int32_t*>(freqs);
  auto* pl = static_cast<uint8_t*>(plane);
  auto* so = static_cast<uint32_t*>(states_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(ctas, threads, smem, s, &attr);
  cudaError_t err;
  if (lanes == 1) {
    err = configure<1>(smem);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, decode_kernel<1>, w, n_words, si, c, n,
                               ctx_bits, t_len, pl, so);
  } else {
    err = configure<2>(smem);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, decode_kernel<2>, w, n_words, si, c, n,
                               ctx_bits, t_len, pl, so);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return int(err);
  }
  return int(cudaGetLastError());
}
