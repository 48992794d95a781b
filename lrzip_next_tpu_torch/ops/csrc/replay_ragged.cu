// K8a, K8b, K8c: the ragged replay of one chunk, three copy kernels.
//
// Replace: lrzip_next_tpu/ops/replay_ragged.py : _ragged_call (kernel
// _make_kernel), _small_call (_make_kernel_small) and _layered_call
// (_make_kernel_prior).
//
//   K8a ragged:  out = 0, then lit[src, src+len) at dst for every piece of
//                the (3, P) int64 piece table (rows dst, src, len; absolute
//                byte offsets; ascending by dst and disjoint); out holds
//                n_cells * 8192 bytes and is written whole.  A source byte
//                outside lit reads as 0.
//   K8c small:   out[dst, dst+len) = lit[src, src+len), in place, for every
//                piece of its (3, P) table (any order, disjoint).
//   K8b layered: buf[dst, dst+len) = buf[src, src+len), in place, for every
//                piece of one layer's (3, P) table (ascending by dst and
//                disjoint, as K8a's); the sources of a pass were completed
//                by earlier passes and no piece of the pass writes them.
//
// Bound on the card (NVIDIA H100 80GB HBM3): bytes.  Every piece byte is
// read once and written once, K8a writes its whole output once, and a
// piece's 24-byte record is read about once; there is no arithmetic beyond
// addresses.  Pieces have disjoint destinations and read-only sources, so
// blocks need no order and no fence.
//
// K8a design: a block of 256 threads owns eight 8 KiB cells (64 KiB), and
// writes each of their 16-byte words once.  It finds the first piece that
// reaches into its cells by itself: probe rounds of 256 piece ends, counted
// with __syncthreads_count, cut the range 256-fold a round (one round for
// the 64 MiB chunk's 50 thousand long pieces), and a window of the next
// 256 records is loaded into shared memory, clipped to the block's bytes,
// in one round trip (again from the block's first piece where the first
// load does not hold all the block's pieces).  Long pieces are longer than
// 512 bytes, so at most 130 of them meet 64 KiB and the window holds them
// all; a thread then
// takes the block's words two at a time (t, t + 256, then t + 512, ...):
// a binary search over the window finds each word's first piece, the two
// aligned 16-byte words of lit that hold its source bytes are loaded for
// both words before either is built, and the word is built in registers,
// 0 merged under a byte mask with the source realigned to the destination
// grid by funnel shifts, and stored once, a coalesced 16-byte store.  Bytes
// no piece covers stay 0: no zeroing pass, no cell in shared memory, no
// barrier after the copy, and one piece over the whole block keeps all its
// threads busy.  Where the window does not hold every piece of the block
// (pieces of a few bytes, which the replay never hands K8a), each cell is
// built on its own from as many windows as it needs.  The byte loads at a
// tensor's edge live out of line: inlined, they took the kernel from 64 to
// 118 registers and it ran at 0.064 ms instead of 0.046 (PERF.md).
//
// K8b design: K8c's word numbering over a block, on K8a's spans.  The
// layer's bytes run from its first record's dst to its last record's end;
// the grid (sized for 8 blocks a multiprocessor; at the kernel's 60
// registers 4 are resident, so it runs in two waves) walks them in spans
// of 16 KiB, a span a block at a time.  The block finds the span's first piece
// by K8a's probe rounds, loads a window of 256 records clipped to the span
// (again from the first piece where the first load does not hold all of
// them, and window after window where 256 do not), and numbers the 16-byte
// destination words its slots touch by a block prefix sum; thread t copies
// words t, t + 256, and so on, two at a time with all loads issued before
// either store, each found by a binary search over the slots' prefixes.
// So one long piece keeps every thread of every block busy, and hundreds
// of short ones share a block.  A word wholly inside its piece is one
// 16-byte store, an edge word K8c's widest aligned stores: two pieces (or a
// piece and a byte this pass does not write) that share a word never lose
// each other's bytes.  A source word may hold bytes that another block is
// writing in the same pass (a destination next to the source); realign and
// store take only the source's own bytes.  The buffer is read and written
// through one pointer, so its loads are plain loads, never __ldg, and the
// kernel waits on nothing.
//
// K8c design: no cells.  A warp takes 32 consecutive pieces, one record a
// lane (three coalesced loads), and numbers the 16-byte destination words
// that its pieces touch by a warp prefix sum; lane l copies words l,
// l + 32, and so on, two at a time with both words' loads issued before
// either store.  A lane finds
// its word's piece by a binary search over the lanes' prefixes
// (__shfl_sync) and its record likewise.  A word wholly inside its piece is
// one 16-byte store; an edge word is written by the widest aligned stores
// (8, 4, 2, 1 bytes) that stay inside the piece, so a byte of a neighbouring
// piece or of K8a's output that shares the word is never written.
//
// Nothing is read or written outside the tensors whatever the table holds.
// Source words that are not wholly inside their tensor are read byte by
// byte, bounded; a K8a piece with len <= 0, dst < 0 or dst + len past the
// output is skipped, a K8c piece outside either tensor is skipped whole.
// Every loop and search is bounded by the table's length.  On a table that
// is not ascending and disjoint K8a stays inside its tensors, but which
// bytes land is unspecified; K8b likewise (a K8b piece outside the buffer,
// as a source or a destination, is skipped whole).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // K8c
constexpr int kCellThreads = 256;  // K8a and K8b
constexpr int kCellBits = 13;
constexpr int kCell = 1 << kCellBits;
constexpr int kWords = kCell / 16 / kCellThreads;  // words a K8a thread owns
constexpr int kWindow = kCellThreads - 32;  // the last probe round's range
constexpr int kCellsPerBlock = 8;  // cells a K8a block writes
constexpr int kGroup = 2;          // words a K8a thread has in flight
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kSmallUnroll = 2;   // K8c words a lane has in flight
constexpr int64_t kHuge = int64_t(1) << 61;
constexpr int kSpan = 16384;       // bytes of output a K8b block takes a turn
constexpr int kLayerGroup = 2;     // K8b words a thread has in flight
constexpr int kLayerBlocksPerSm = 8;

__device__ __forceinline__ int64_t clamp_huge(int64_t v) {
  return v < -kHuge ? -kHuge : (v > kHuge ? kHuge : v);
}

__device__ __forceinline__ int64_t clamp_index(int64_t v, int64_t n) {
  return v < 0 ? 0 : (v > n ? n : v);
}

__device__ __forceinline__ uint32_t word_at(const uint4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// The loads of a tensor that the kernel only reads go through the
// read-only cache (kReadOnly); K8b's buffer, which the kernel also writes,
// takes plain loads.
template <bool kReadOnly>
__device__ __forceinline__ uint8_t load_byte(const uint8_t* p) {
  if constexpr (kReadOnly) {
    return __ldg(p);
  } else {
    return *p;
  }
}

template <bool kReadOnly>
__device__ __forceinline__ uint4 load_word(const uint8_t* p) {
  if constexpr (kReadOnly) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    return *reinterpret_cast<const uint4*>(p);
  }
}

// The bytes buf[first .. first + 16) one at a time, 0 where the index is
// outside [0, len): a word at the edge of its tensor, rare, so kept out of
// line where it costs the callers no registers.
template <bool kReadOnly>
__device__ __noinline__ uint4 edge_word(const uint8_t* buf, int64_t len,
                                        int64_t first) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int64_t p = first + i;
    if (p >= 0 && p < len)
      w[i >> 2] |= uint32_t(load_byte<kReadOnly>(buf + p)) << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Aligned 16-byte word g of buf, counted from the 16-byte boundary at or
// below buf (m = buf's address mod 16): bytes buf[16g - m .. 16g - m + 16),
// 0 where that index is outside [0, len).
template <bool kReadOnly>
__device__ __forceinline__ uint4 aligned_word(const uint8_t* buf, int64_t len,
                                              int m, int64_t g) {
  const int64_t first = 16 * g - m;
  if (first >= 0 && first <= len - 16)
    return load_word<kReadOnly>(buf + first);
  return edge_word<kReadOnly>(buf, len, first);
}

// Bytes r .. r + 16 of the 32 bytes a:b.
__device__ __forceinline__ uint4 realign(const uint4& a, const uint4& b,
                                         int r) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int q = r >> 2;
  const uint32_t s = 8u * uint32_t(r & 3);
  uint32_t o[5];
#pragma unroll
  for (int k = 0; k < 5; ++k)
    o[k] = q == 0 ? w[k] : (q == 1 ? w[k + 1] : (q == 2 ? w[k + 2]
                                                       : w[k + 3]));
  return make_uint4(__funnelshift_r(o[0], o[1], s),
                    __funnelshift_r(o[1], o[2], s),
                    __funnelshift_r(o[2], o[3], s),
                    __funnelshift_r(o[3], o[4], s));
}

// The mask of bytes [lo, hi) of a 16-byte word, 0 <= lo <= hi <= 16.
__device__ __forceinline__ uint4 byte_mask(int lo, int hi) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int a = min(max(lo - 4 * k, 0), 4);
    const int b = min(max(hi - 4 * k, 0), 4);
    w[k] = uint32_t((1ull << (8 * max(a, b))) - (1ull << (8 * a)));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The 16 source bytes of a destination word whose byte 0 maps to buf index
// sp0, of which bytes [lo, hi) are needed (0 <= lo < hi <= 16): the aligned
// words that hold them, realigned.
struct SourceWord {
  uint4 a, b;
  int r;
};

template <bool kReadOnly = true>
__device__ __forceinline__ SourceWord load_source(const uint8_t* buf,
                                                  int64_t len, int m,
                                                  int64_t sp0, int lo,
                                                  int hi) {
  SourceWord s;
  const int64_t x = sp0 + m;
  const int64_t g = x >> 4;
  s.r = int(x & 15);
  s.a = s.r + lo < 16 ? aligned_word<kReadOnly>(buf, len, m, g)
                      : make_uint4(0, 0, 0, 0);
  s.b = (s.r != 0 && s.r + hi > 16) ? aligned_word<kReadOnly>(buf, len, m,
                                                              g + 1)
                                    : make_uint4(0, 0, 0, 0);
  return s;
}

__device__ __forceinline__ uint4 merge(const uint4& v, const uint4& x,
                                       const uint4& k) {
  return make_uint4((v.x & ~k.x) | (x.x & k.x), (v.y & ~k.y) | (x.y & k.y),
                    (v.z & ~k.z) | (x.z & k.z), (v.w & ~k.w) | (x.w & k.w));
}

// ---------------------------------------------------------------------------
// K8a

// The end of a piece as the search orders it (clamped so no sum overflows).
__device__ __forceinline__ int64_t end_key(int64_t d, int64_t l) {
  return clamp_huge(d) + (l < 0 ? 0 : clamp_huge(l));
}

struct Pieces {
  const int64_t* dst;
  const int64_t* src;
  const int64_t* len;
  int64_t n;
  int64_t out_size;
};

// A window of kCellThreads records in shared memory, clipped to a region
// of the output: bytes [lo, hi) of the region take lit[origin + byte +
// delta]; empty where lo == hi.
struct Window {
  int lo[kCellThreads], hi[kCellThreads];
  int64_t delta[kCellThreads];
};

// The probe rounds (every thread): narrow [lo, hi) to at most kWindow
// pieces around the first piece whose end passes ``origin``, 256 probes a
// round; returns lo.
__device__ __forceinline__ int64_t probe_first(const Pieces& p,
                                               int64_t origin) {
  int64_t lo = 0, hi = p.n;
  while (hi - lo > kWindow) {
    const int64_t step = (hi - lo + kCellThreads - 1) / kCellThreads;
    const int64_t q = lo + threadIdx.x * step;
    const bool below = q < hi && end_key(p.dst[q], p.len[q]) <= origin;
    const int cnt = __syncthreads_count(below);
    if (cnt == 0) {
      hi = lo;
    } else {
      const int64_t cut = lo + cnt * step;
      hi = cut < hi ? cut : hi;
      lo = lo + (cnt - 1) * step + 1;
    }
  }
  return lo;
}

// Records base .. base + kCellThreads into the window, one a thread,
// clipped to [origin, origin + span).  Returns the count of records that
// end at or before origin; *more says whether pieces after the window
// reach into the region.
__device__ __forceinline__ int load_window(const Pieces& p, int64_t base,
                                           int64_t origin, int span,
                                           Window& w, bool* more) {
  const int tid = threadIdx.x;
  const int64_t q = base + tid;
  int a = span, b = span;
  int64_t delta = 0;
  bool below = false, reaches = false;
  if (q < p.n) {
    const int64_t d = p.dst[q], s = p.src[q], l = p.len[q];
    below = end_key(d, l) <= origin;
    reaches = clamp_huge(d) < origin + span;
    const bool ok = l > 0 && d >= 0 && l <= p.out_size - d;
    a = b = int(clamp_index(clamp_huge(d) - origin, span));
    if (ok) b = int(clamp_index(d + l - origin, span));
    delta = clamp_huge(s) - d;
  }
  w.lo[tid] = a;
  w.hi[tid] = max(a, b);
  w.delta[tid] = delta;
  const int cnt = __syncthreads_count(below);
  *more = __syncthreads_or(tid == kCellThreads - 1 && reaches &&
                           q + 1 < p.n);
  return cnt;
}

// One 16-byte word of a region, in two steps so that several words' loads
// are in flight together: start() finds the word's first piece in the
// window (a binary search from slot ``first``) and loads its source
// words; finish() merges them, then the pieces that start inside the word.
struct WordJob {
  int slot, bl, bh;
  SourceWord sw;

  __device__ __forceinline__ void start(const Window& w, int first, int w0,
                                        const uint8_t* __restrict__ lit,
                                        int64_t lit_len, int m,
                                        int64_t origin) {
    int i = first, j = kCellThreads;
    while (i < j) {
      const int mid = (i + j) >> 1;
      if (w.hi[mid] <= w0) i = mid + 1; else j = mid;
    }
    slot = i;
    bl = bh = 0;
    if (i < kCellThreads) {
      bl = max(w.lo[i], w0) - w0;
      bh = min(w.hi[i], w0 + 16) - w0;
    }
    if (bl < bh) sw = load_source(lit, lit_len, m, origin + w0 + w.delta[i],
                                  bl, bh);
  }

  __device__ __forceinline__ uint4 finish(uint4 v, const Window& w, int w0,
                                          const uint8_t* __restrict__ lit,
                                          int64_t lit_len, int m,
                                          int64_t origin) const {
    if (bl < bh) v = merge(v, realign(sw.a, sw.b, sw.r), byte_mask(bl, bh));
    for (int i = slot + 1; i < kCellThreads && w.lo[i] < w0 + 16; ++i) {
      const int a = max(w.lo[i], w0) - w0;
      const int b = min(w.hi[i], w0 + 16) - w0;
      if (a >= b) continue;
      const SourceWord x =
          load_source(lit, lit_len, m, origin + w0 + w.delta[i], a, b);
      v = merge(v, realign(x.a, x.b, x.r), byte_mask(a, b));
    }
    return v;
  }
};

__global__ void __launch_bounds__(kCellThreads)
ragged_kernel(const uint8_t* __restrict__ lit, int64_t lit_len,
              const int64_t* __restrict__ pieces, int64_t n, int64_t n_cells,
              uint8_t* __restrict__ out) {
  __shared__ Window w;
  const int tid = threadIdx.x;
  const Pieces p{pieces, pieces + n, pieces + 2 * n, n, n_cells * kCell};
  const int m = int(reinterpret_cast<uintptr_t>(lit) & 15);
  const int64_t cell0 = int64_t(blockIdx.x) * kCellsPerBlock;
  const int cells = int(n_cells - cell0 < kCellsPerBlock ? n_cells - cell0
                                                         : kCellsPerBlock);
  const int64_t origin = cell0 << kCellBits;
  const int span = cells << kCellBits;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  bool more;
  int64_t base = probe_first(p, origin);
  int first = load_window(p, base, origin, span, w, &more);
  if (more && first > 0) {
    // the window again from the block's first piece, so that it holds as
    // many of the block's pieces as it can
    __syncthreads();
    base += first;
    first = load_window(p, base, origin, span, w, &more);
  }
  if (!more) {
    // Every piece that meets the block's cells is in the window: each
    // thread's words, kGroup at a time, each stored once.
    uint4* dst = reinterpret_cast<uint4*>(out + origin);
    const int words = span / 16;
    for (int k0 = 0; k0 < words; k0 += kGroup * kCellThreads) {
      WordJob job[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int k = k0 + u * kCellThreads + tid;
        if (k < words) job[u].start(w, first, 16 * k, lit, lit_len, m, origin);
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int k = k0 + u * kCellThreads + tid;
        if (k < words)
          dst[k] = job[u].finish(zero, w, 16 * k, lit, lit_len, m, origin);
      }
    }
    return;
  }
  // More pieces meet the block than a window holds (pieces of a few
  // bytes): each cell on its own, with as many windows as it needs.
  for (int c = 0; c < cells; ++c) {
    const int64_t cell = origin + (int64_t(c) << kCellBits);
    uint4 v[kWords];
#pragma unroll
    for (int u = 0; u < kWords; ++u) v[u] = zero;
    __syncthreads();       // the window is read before it is refilled
    base = probe_first(p, cell);
    for (int from = -1;; base += kCellThreads) {
      bool again;
      const int cnt = load_window(p, base, cell, kCell, w, &again);
      if (from < 0) from = cnt;
      WordJob job[kWords];
#pragma unroll
      for (int u = 0; u < kWords; ++u)
        job[u].start(w, from, 16 * (u * kCellThreads + tid), lit, lit_len, m,
                     cell);
#pragma unroll
      for (int u = 0; u < kWords; ++u)
        v[u] = job[u].finish(v[u], w, 16 * (u * kCellThreads + tid), lit,
                             lit_len, m, cell);
      if (!again) break;
      from = 0;
      __syncthreads();     // the window is read before it is refilled
    }
    uint4* dst = reinterpret_cast<uint4*>(out + cell);
#pragma unroll
    for (int u = 0; u < kWords; ++u) dst[u * kCellThreads + tid] = v[u];
  }
}

// ---------------------------------------------------------------------------
// K8c

// Bytes [lo, hi) of v stored at base (16-byte aligned), by the widest
// aligned stores that stay inside the range.
__device__ __forceinline__ void store_bytes(uint8_t* base, const uint4& v,
                                            int lo, int hi) {
  if (lo == 0 && hi == 16) {
    *reinterpret_cast<uint4*>(base) = v;
    return;
  }
  for (int b = lo; b < hi;) {
    const uint32_t w = word_at(v, b >> 2);
    if ((b & 7) == 0 && b + 8 <= hi) {
      *reinterpret_cast<uint2*>(base + b) =
          make_uint2(w, word_at(v, (b >> 2) + 1));
      b += 8;
    } else if ((b & 3) == 0 && b + 4 <= hi) {
      *reinterpret_cast<uint32_t*>(base + b) = w;
      b += 4;
    } else if ((b & 1) == 0 && b + 2 <= hi) {
      *reinterpret_cast<uint16_t*>(base + b) = uint16_t(w >> (8 * (b & 3)));
      b += 2;
    } else {
      base[b] = uint8_t(w >> (8 * (b & 3)));
      b += 1;
    }
  }
}

__device__ __forceinline__ int clamp16(int64_t v) {
  return v < 0 ? 0 : (v > 16 ? 16 : int(v));
}

__global__ void __launch_bounds__(kThreads)
small_kernel(const uint8_t* __restrict__ lit, int64_t lit_len,
             const int64_t* __restrict__ pieces, int64_t n,
             uint8_t* __restrict__ out, int64_t out_len) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t p = warp * 32 + lane;
  const int m = int(reinterpret_cast<uintptr_t>(lit) & 15);
  const int mo = int(reinterpret_cast<uintptr_t>(out) & 15);
  uint8_t* out_base = out - mo;  // aligned; written only inside the pieces
  int64_t d = 0, s = 0, l = 0;
  if (p < n) {
    d = pieces[p];
    s = pieces[n + p];
    l = pieces[2 * n + p];
  }
  const bool ok = p < n && d >= 0 && s >= 0 && l > 0 && l <= out_len - d &&
                  l <= lit_len - s;
  // the piece's destination words, counted from out_base: the first, the
  // piece's first byte in it, the bytes from its start to the piece's end
  const int64_t dw = ok ? (d + mo) >> 4 : 0;
  const int head = ok ? int((d + mo) & 15) : 0;
  const int64_t tail = ok ? d + mo + l - 16 * dw : 0;
  const int64_t nw = (tail + 15) >> 4;
  const int64_t delta = ok ? s - d : 0;       // source index - dest index
  int64_t incl = nw;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const int64_t t = __shfl_up_sync(0xffffffffu, incl, k);
    if (lane >= k) incl += t;
  }
  const int64_t excl = incl - nw;
  const int64_t total = __shfl_sync(0xffffffffu, incl, 31);

  for (int64_t x0 = 0; x0 < total; x0 += 32 * kSmallUnroll) {
    SourceWord sw[kSmallUnroll];
    int64_t word[kSmallUnroll];
    int lo[kSmallUnroll], hi[kSmallUnroll];
#pragma unroll
    for (int u = 0; u < kSmallUnroll; ++u) {
      const int64_t x = x0 + 32 * u + lane;
      // the last lane whose first word is at or before x
      int i = 0;
#pragma unroll
      for (int k = 16; k > 0; k >>= 1)
        if (__shfl_sync(0xffffffffu, excl, i + k) <= x) i += k;
      // the word's place in its piece
      const int64_t j = x - __shfl_sync(0xffffffffu, excl, i);
      word[u] = __shfl_sync(0xffffffffu, dw, i) + j;
      lo[u] = clamp16(__shfl_sync(0xffffffffu, head, i) - 16 * j);
      hi[u] = clamp16(__shfl_sync(0xffffffffu, tail, i) - 16 * j);
      const int64_t pd = __shfl_sync(0xffffffffu, delta, i);
      if (x >= total) hi[u] = lo[u];
      if (lo[u] < hi[u])
        sw[u] = load_source(lit, lit_len, m, 16 * word[u] - mo + pd, lo[u],
                            hi[u]);
    }
#pragma unroll
    for (int u = 0; u < kSmallUnroll; ++u) {
      if (lo[u] < hi[u])
        store_bytes(out_base + 16 * word[u],
                    realign(sw[u].a, sw[u].b, sw[u].r), lo[u], hi[u]);
    }
  }
}

// ---------------------------------------------------------------------------
// K8b

// One window of records clipped to a span of the output: slot t copies
// bytes [a, b) of the span (offsets from its aligned start) from
// buf[its index + delta]; excl is the count of the span's words that the
// slots before t touch.
struct LayerWindow {
  int a[kCellThreads], b[kCellThreads], excl[kCellThreads];
  int64_t delta[kCellThreads];
  int warp_total[kCellThreads / 32];
};

// buf is read and written through this one pointer: no __restrict__ and
// no __ldg on it.
__global__ void __launch_bounds__(kCellThreads)
layered_span_kernel(uint8_t* buf, int64_t buf_len,
                    const int64_t* __restrict__ pieces, int64_t n) {
  __shared__ LayerWindow w;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Pieces p{pieces, pieces + n, pieces + 2 * n, n, buf_len};
  const int mo = int(reinterpret_cast<uintptr_t>(buf) & 15);
  uint8_t* const base = buf - mo;  // aligned; written only inside the pieces
  // the layer's bytes as aligned offsets (buf index + mo), from its first
  // and its last record: [lo, hi)
  const int64_t size = buf_len + mo;
  const int64_t lo = clamp_index(clamp_huge(p.dst[0]) + mo, size) &
                     ~int64_t(15);
  const int64_t hi = clamp_index(end_key(p.dst[n - 1], p.len[n - 1]) + mo,
                                 size);
  for (int64_t o = lo + int64_t(blockIdx.x) * kSpan; o < hi;
       o += int64_t(gridDim.x) * kSpan) {
    const int64_t origin = o - mo;    // buf index of the span's byte 0
    int64_t first = probe_first(p, origin);
    bool again = true;
    for (;;) {
      // the window: one record a thread, clipped to the span
      const int64_t q = first + tid;
      int a = 0, b = 0;
      int64_t delta = 0;
      bool below = false, reaches = false;
      if (q < n) {
        const int64_t d = p.dst[q], s = p.src[q], l = p.len[q];
        below = end_key(d, l) <= origin;
        reaches = clamp_huge(d) < origin + kSpan;
        if (d >= 0 && s >= 0 && l > 0 && l <= buf_len - d &&
            l <= buf_len - s) {
          a = int(clamp_index(d - origin, kSpan));
          b = int(clamp_index(d + l - origin, kSpan));
          delta = s - d;
        }
      }
      const int cnt = __syncthreads_count(below);
      const bool more = __syncthreads_or(tid == kCellThreads - 1 && reaches &&
                                         q + 1 < n);
      if (more && cnt > 0 && again) {
        // again from the span's first piece, so that the window holds as
        // many of the span's pieces as it can
        again = false;
        first += cnt;
        continue;
      }
      // number the span's words that the slots touch, across the block
      const int nw = a < b ? ((b - 1) >> 4) - (a >> 4) + 1 : 0;
      int incl = nw;
#pragma unroll
      for (int k = 1; k < 32; k <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, k);
        if (lane >= k) incl += t;
      }
      if (lane == 31) w.warp_total[warp] = incl;
      w.a[tid] = a;
      w.b[tid] = b;
      w.delta[tid] = delta;
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int i = 0; i < kCellThreads / 32; ++i) {
        const int t = w.warp_total[i];
        before += i < warp ? t : 0;
        total += t;
      }
      w.excl[tid] = before + incl - nw;
      __syncthreads();
      // the words, kLayerGroup a thread in flight: all their loads are
      // issued before any store
      int slot = 0;                 // w.excl[slot] <= every x still to come
      for (int x0 = 0; x0 < total; x0 += kLayerGroup * kCellThreads) {
        SourceWord sw[kLayerGroup];
        int64_t at[kLayerGroup];
        int wl[kLayerGroup], wh[kLayerGroup];
#pragma unroll
        for (int u = 0; u < kLayerGroup; ++u) {
          const int x = x0 + u * kCellThreads + tid;
          wl[u] = wh[u] = 0;
          at[u] = 0;
          if (x < total) {
            // the last slot whose first word is at or before x
            int j = kCellThreads;
            while (j - slot > 1) {
              const int mid = (slot + j) >> 1;
              if (w.excl[mid] <= x) slot = mid; else j = mid;
            }
            const int word = (w.a[slot] >> 4) + (x - w.excl[slot]);
            wl[u] = clamp16(w.a[slot] - 16 * word);
            wh[u] = clamp16(w.b[slot] - 16 * word);
            at[u] = o + 16 * int64_t(word);
            if (wl[u] < wh[u])
              sw[u] = load_source<false>(buf, buf_len, mo,
                                         at[u] - mo + w.delta[slot], wl[u],
                                         wh[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kLayerGroup; ++u) {
          if (wl[u] < wh[u])
            store_bytes(base + at[u], realign(sw[u].a, sw[u].b, sw[u].r),
                        wl[u], wh[u]);
        }
      }
      __syncthreads();     // the window is read before it is refilled
      if (!more) break;
      first += kCellThreads;
      again = false;
    }
  }
}

constexpr int64_t kMaxGrid = 0x7FFFFFFF;

}  // namespace

// out holds n_cells * 8192 bytes; pieces is (3, n) int64.
extern "C" int lrzt_replay_ragged(const void* lit, int64_t lit_len,
                                  const void* pieces, int64_t n,
                                  int64_t n_cells, void* out, void* stream) {
  const int64_t blocks = (n_cells + kCellsPerBlock - 1) / kCellsPerBlock;
  if (lit_len < 0 || n < 0 || n_cells < 1 || blocks > kMaxGrid ||
      n_cells > (int64_t(1) << 40))
    return int(cudaErrorInvalidValue);
  ragged_kernel<<<unsigned(blocks), kCellThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(lit), lit_len,
      static_cast<const int64_t*>(pieces), n, n_cells,
      static_cast<uint8_t*>(out));
  return int(cudaGetLastError());
}

// pieces is (3, n) int64, n >= 1.
extern "C" int lrzt_replay_small(const void* lit, int64_t lit_len,
                                 const void* pieces, int64_t n, void* out,
                                 int64_t out_len, void* stream) {
  const int64_t per_block = int64_t(kThreads);
  const int64_t blocks = (n + per_block - 1) / per_block;
  if (lit_len < 0 || n < 1 || out_len < 0 || blocks > kMaxGrid)
    return int(cudaErrorInvalidValue);
  small_kernel<<<unsigned(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(lit), lit_len,
      static_cast<const int64_t*>(pieces), n, static_cast<uint8_t*>(out),
      out_len);
  return int(cudaGetLastError());
}

// pieces is (3, n) int64, n >= 1.
extern "C" int lrzt_replay_layered(void* buf, int64_t buf_len,
                                   const void* pieces, int64_t n,
                                   void* stream) {
  if (buf_len < 0 || n < 1) return int(cudaErrorInvalidValue);
  // the device's multiprocessor count, asked once a process and device
  static std::atomic<int> sm_count[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  int sms = dev < 64 ? sm_count[dev].load(std::memory_order_relaxed) : 0;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return int(err);
    if (dev < 64) sm_count[dev].store(sms, std::memory_order_relaxed);
  }
  // enough blocks to fill the card, no more than the buffer has spans
  const int64_t spans = (buf_len + 15) / kSpan + 1;
  const int64_t fill = int64_t(sms) * kLayerBlocksPerSm;
  const int64_t blocks = spans < fill ? spans : fill;
  layered_span_kernel<<<unsigned(blocks), kCellThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(buf), buf_len,
      static_cast<const int64_t*>(pieces), n);
  return int(cudaGetLastError());
}
