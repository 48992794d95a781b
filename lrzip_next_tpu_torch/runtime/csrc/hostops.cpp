// Native host runtime for lrzip_next_tpu.
//
// The serial tails that resist vectorisation live here, mirroring how the
// reference keeps its serial coders native (LZMA SDK range coder,
// src/lzma/C/LzmaEnc.c; libzpaq arithmetic coder):
//
//  - greedy_cover: frontier walk over verified match runs (the only
//    sequential stage of the TPU matcher pipeline, see
//    lrzip_next_tpu/ops/matcher.py)
//  - lzo1x encode/decode: byte-oriented LZ with sequential state
//    (replaces liblzo2, which the reference links at configure.ac:146)
//  - token replay: sequential fallback decoder for rzip token streams
//    (reference src/runzip.c:129-241 semantics)
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstddef>
#include <functional>
#include <queue>
#include <vector>

extern "C" {

// --------------------------------------------------------------- greedy

// Walk verified chain runs left to right, emitting (kind, len, dist)
// tokens. Returns number of tokens written, or -1 when `cap` would
// overflow (callers size cap at 2*(n/min_match) + 2*n_runs + 4, which
// cannot overflow: emitted matches are >= min_match disjoint bytes).
//
// Each run (s, r, src) comes from fingerprint-equal window chains
// (lrzip_next_tpu/ops/matcher.py): it certifies same-distance seed
// windows across [s, s + r + min_match).  When `data` is provided this
// walk is also the exact verifier: emitted spans are re-derived with
// byte compares (extending left into the literal gap and right past
// the chain break - the reference extends both ways too,
// src/rzip.c:431-534), so a fingerprint collision can only shrink or
// drop a match, never corrupt the output.  Chains may be GAPPY (seed
// merging tolerates unmatched stretches between same-distance seeds,
// matcher._CHAIN_GAP): after a mismatch ends a match, the walk
// RESYNCS by scanning forward for the next min_match-byte agreement at
// the same distance, up to the chain's certified end - the role the
// reference's per-position hash probes play across a long repeat
// (src/rzip.c:586-762).  Scanning is bounded by a global budget so
// degenerate chain sets stay O(n).
int64_t greedy_cover(const int64_t* run_start, const int64_t* run_len,
                     const int64_t* run_src, int64_t n_runs, int64_t n,
                     int64_t min_match, const uint8_t* data,
                     uint8_t* out_kind, int64_t* out_len,
                     int64_t* out_dist, int64_t cap,
                     int64_t* out_hole_bytes) {
    int64_t f = 0;  // emission frontier
    int64_t t = 0;
    int64_t hole_bytes = 0;
    int64_t scan_budget = 16 * n + (1 << 20);

    auto emit = [&](int64_t kind, int64_t len, int64_t dist) -> bool {
        if (t + 1 > cap) return false;
        out_kind[t] = (uint8_t)kind;
        out_len[t] = len;
        out_dist[t] = dist;
        t++;
        return true;
    };

    if (data == nullptr) {
        // unverified mode (tests): trust each certified span once
        for (int64_t i = 0; i < n_runs && f < n; i++) {
            int64_t s0 = run_start[i];
            int64_t cert_end = s0 + run_len[i] + min_match - 1;
            if (cert_end > n) cert_end = n;
            if (cert_end <= f) continue;
            int64_t dist = run_start[i] - run_src[i];
            int64_t start_at = s0 > f ? s0 : f;
            if (dist < 1 || start_at - dist < 0) continue;
            if (cert_end - start_at < min_match) continue;
            if (start_at > f && !emit(0, start_at - f, 0)) return -1;
            if (!emit(1, cert_end - start_at, dist)) return -1;
            f = cert_end;
        }
        if (f < n && !emit(0, n - f, 0)) return -1;
        if (out_hole_bytes) *out_hole_bytes = 0;
        return t;
    }

    // Multi-way frontier walk: every chain contributes its NEXT
    // verified match (exact byte scan at the chain's distance inside
    // its certified span); a min-heap on match start picks the
    // earliest available match - chains never lock their whole span,
    // so an overlapping chain at a better distance wins wherever it
    // matches earlier.  This is the behavior an exhaustive
    // per-position probe (the reference's hash loop,
    // src/rzip.c:586-762) exhibits across interleaved repeats.
    struct Cand {
        int64_t q, e, dist, cert_end;
    };
    struct Cmp {
        bool operator()(const Cand& a, const Cand& b) const {
            if (a.q != b.q) return a.q > b.q;            // earliest
            return (a.e - a.q) < (b.e - b.q);            // longest
        }
    };
    std::priority_queue<Cand, std::vector<Cand>, Cmp> heap;

    // word-wise common-prefix length (the scan and the right
    // extension both ride this; the byte-at-a-time loop was ~60% of
    // the walk at 64MB - two dependent loads per byte, one of them a
    // cold line dist bytes back)
    auto match_fwd = [&](int64_t a, int64_t b, int64_t maxlen)
        -> int64_t {
        int64_t i = 0;
        while (i + 8 <= maxlen) {
            uint64_t x, y;
            std::memcpy(&x, data + a + i, 8);
            std::memcpy(&y, data + b + i, 8);
            uint64_t d = x ^ y;
            if (d) return i + (__builtin_ctzll(d) >> 3);
            i += 8;
        }
        while (i < maxlen && data[a + i] == data[b + i]) i++;
        return i;
    };

    // next verified match of a chain scanning from `from`; the found
    // candidate is already fully right-extended
    auto next_match = [&](int64_t dist, int64_t cert_end,
                          int64_t from, Cand* out) -> bool {
        int64_t scan_lim = cert_end - min_match;  // last allowed start
        int64_t p = from;
        if (p - dist < 0) p = dist;  // source must be in-bounds
        int64_t from0 = p;
        while (p <= scan_lim) {
            if (scan_budget < 0) break;
            int64_t l = match_fwd(p, p - dist, n - p);
            scan_budget -= l + 1;
            if (l >= min_match) {
                hole_bytes += p - from0;
                *out = Cand{p, p + l, dist, cert_end};
                return true;
            }
            p += l + 1;
        }
        hole_bytes += (p < from0 ? 0 : p - from0);
        return false;
    };

    int64_t i = 0;  // next unactivated chain (inputs sorted by start)
    while (true) {
        // activate chains that could start at or before the heap top
        int64_t horizon = heap.empty() ? ((i < n_runs)
                          ? run_start[i] : n) : heap.top().q;
        while (i < n_runs && run_start[i] <= horizon) {
            int64_t s0 = run_start[i];
            int64_t cert_end = s0 + run_len[i] + min_match - 1;
            if (cert_end > n) cert_end = n;
            int64_t dist = run_start[i] - run_src[i];
            i++;
            if (dist < 1 || cert_end <= f) continue;
            Cand c;
            // NOTE: never shrink `horizon` here - stopping activation
            // at a newly found earlier candidate can leave a chain
            // unactivated while an emitted match jumps the frontier
            // past its whole span (found as a 28KB coverage loss on a
            // mid-file copy boundary)
            if (next_match(dist, cert_end, s0 > f ? s0 : f, &c))
                heap.push(c);
        }
        if (heap.empty()) {
            if (i >= n_runs) break;
            continue;  // skip ahead to the next chain's start
        }
        if (i < n_runs && run_start[i] <= heap.top().q)
            continue;  // a candidate pushed mid-sweep may sit past
                       // still-unactivated chains: activate everything
                       // up to the heap top before ANY pop, or an
                       // emitted long match jumps the frontier over
                       // chains that were never given a candidate
        Cand c = heap.top();
        heap.pop();
        if (c.e <= f || c.q >= n) {
            // stale: frontier moved past it; rescan from f
            Cand nc;
            if (c.cert_end > f && next_match(c.dist, c.cert_end, f, &nc))
                heap.push(nc);
            continue;
        }
        int64_t m_start = c.q > f ? c.q : f;
        // left extension over the literal gap
        while (m_start > f && m_start - c.dist > 0 &&
               data[m_start - 1] == data[m_start - 1 - c.dist])
            m_start--;
        if (c.e - m_start >= min_match) {
            if (m_start > f && !emit(0, m_start - f, 0)) return -1;
            if (!emit(1, c.e - m_start, c.dist)) return -1;
            f = c.e;
            if (f >= n) break;
        }
        // reinsert this chain's next match past the frontier
        Cand nc;
        if (c.cert_end > f && next_match(c.dist, c.cert_end, f, &nc))
            heap.push(nc);
    }
    if (f < n && !emit(0, n - f, 0)) return -1;
    if (out_hole_bytes) *out_hole_bytes = hole_bytes;
    return t;
}

// ------------------------------------------------------------- finalize

// Byte-verify + extend device-selected match pieces into the final
// token stream (the host half of the round-5 device greedy: the
// prefix-max selection on device emits disjoint, start-sorted pieces
// whose spans are fingerprint-certified; this pass makes them exact).
// Per piece: extend the start left across the literal gap, then scan
// the span emitting maximal byte-verified matches (resyncing over any
// interior hole at the same distance), letting the last match extend
// right past the span end.  A fingerprint collision can only shrink or
// split a match here, never corrupt the output - mirroring how the
// reference's hash hits are always verified by byte compares before
// emission (src/rzip.c:431-534).
//
// Returns the token count, or -1 when `cap` would overflow.
// out_hole_bytes counts bytes scanned inside selected spans that did
// NOT verify at the piece's distance - the signal that the device
// selection shadowed alternative chains (hole-dense text), on which
// the caller falls back to the full-record heap walk (greedy_cover).
int64_t finalize_tokens(const int64_t* m_start, const int64_t* m_len,
                        const int64_t* m_dist, int64_t k,
                        const uint8_t* data, int64_t n,
                        int64_t min_match, uint8_t* out_kind,
                        int64_t* out_len, int64_t* out_dist,
                        int64_t cap, int64_t* out_hole_bytes) {
    int64_t f = 0;  // emission frontier
    int64_t t = 0;
    int64_t hole_bytes = 0;

    auto emit = [&](int64_t kind, int64_t len, int64_t dist) -> bool {
        if (t + 1 > cap) return false;
        out_kind[t] = (uint8_t)kind;
        out_len[t] = len;
        out_dist[t] = dist;
        t++;
        return true;
    };

    auto match_fwd = [&](int64_t a, int64_t b, int64_t maxlen)
        -> int64_t {
        int64_t i = 0;
        while (i + 8 <= maxlen) {
            uint64_t x, y;
            std::memcpy(&x, data + a + i, 8);
            std::memcpy(&y, data + b + i, 8);
            uint64_t d = x ^ y;
            if (d) return i + (__builtin_ctzll(d) >> 3);
            i += 8;
        }
        while (i < maxlen && data[a + i] == data[b + i]) i++;
        return i;
    };

    for (int64_t i = 0; i < k && f < n; i++) {
        int64_t d = m_dist[i];
        int64_t e0 = m_start[i] + m_len[i];
        if (e0 > n) e0 = n;
        if (d < 1 || e0 <= f) continue;
        int64_t s = m_start[i] > f ? m_start[i] : f;
        if (s - d < 0) continue;
        // left extension across the literal gap
        while (s > f && s > d && data[s - 1] == data[s - 1 - d]) s--;
        int64_t p = s;
        while (p < e0) {
            int64_t l = match_fwd(p, p - d, n - p);
            if (l >= min_match) {
                if (p > f && !emit(0, p - f, 0)) return -1;
                if (!emit(1, l, d)) return -1;
                f = p + l;
                p = f;  // past e0 ends the span loop naturally
            } else {
                int64_t step = l + 1;
                if (p + step > e0) step = e0 - p;
                hole_bytes += step;
                p += step;  // resync over an interior hole
            }
        }
    }
    if (f < n && !emit(0, n - f, 0)) return -1;
    if (out_hole_bytes) *out_hole_bytes = hole_bytes;
    return t;
}

// ---------------------------------------------------------------- parse

// Parse a stream-0 token byte sequence into columnar arrays.
// Returns the number of tokens, writing the CRC and consumed length via
// out-params; -1 on malformed input. Capacities must be >= n/3 + 1.
int64_t parse_token_stream(const uint8_t* s, int64_t n, int64_t chunk_bytes,
                           uint8_t* out_kind, int64_t* out_len,
                           int64_t* out_dist, uint32_t* out_crc,
                           int64_t* out_consumed) {
    int64_t p = 0, t = 0;
    for (;;) {
        if (p + 3 > n) return -1;
        uint8_t kind = s[p];
        int64_t len = (int64_t)s[p + 1] | ((int64_t)s[p + 2] << 8);
        p += 3;
        if (kind == 0 && len == 0) break;  // terminator
        int64_t dist = 0;
        if (kind != 0) {
            if (p + chunk_bytes > n) return -1;
            for (int64_t b = 0; b < chunk_bytes; b++)
                dist |= (int64_t)s[p + b] << (8 * b);
            p += chunk_bytes;
        }
        out_kind[t] = kind != 0;
        out_len[t] = len;
        out_dist[t] = dist;
        t++;
    }
    if (p + 4 > n) return -1;
    *out_crc = (uint32_t)s[p] | ((uint32_t)s[p + 1] << 8)
             | ((uint32_t)s[p + 2] << 16) | ((uint32_t)s[p + 3] << 24);
    *out_consumed = p + 4;
    return t;
}

// --------------------------------------------------------------- replay

// Sequential rzip token replay with full history semantics
// (reference src/runzip.c:184-241): matches copy from the already
// written output, overlap-safe. Returns bytes written or -1 on error.
//
// History is a *separate* read-only buffer (the fd_hist analog): the
// caller passes the already-written output prefix - typically a memmap
// of the output file, so multi-chunk decode never copies or even
// pages-in history it does not touch.
int64_t replay_tokens(const uint8_t* kinds, const int64_t* lens,
                      const int64_t* dists, int64_t n_tokens,
                      const uint8_t* literals, int64_t n_literals,
                      const uint8_t* hist, int64_t hist_len,
                      uint8_t* out, int64_t out_cap) {
    int64_t op = 0;
    int64_t lp = 0;
    for (int64_t i = 0; i < n_tokens; i++) {
        int64_t len = lens[i];
        if (op + len > out_cap) return -1;
        if (kinds[i] == 0) {
            if (lp + len > n_literals) return -1;
            std::memcpy(out + op, literals + lp, (size_t)len);
            lp += len;
            op += len;
        } else {
            int64_t dist = dists[i];
            if (dist < 1 || dist > op + hist_len) return -1;
            int64_t src = op - dist;  // may land in history (< 0)
            if (src < 0) {
                int64_t h = -src < len ? -src : len;
                std::memcpy(out + op, hist + hist_len + src, (size_t)h);
                op += h;
                len -= h;
                src = 0;  // continuation reads from out start
            }
            while (len > 0) {  // overlap-safe within out
                int64_t c = op - src;
                if (c > len) c = len;
                std::memcpy(out + op, out + src, (size_t)c);
                op += c;
                src += c;
                len -= c;
            }
        }
    }
    return op;
}

// Flatten rzip tokens into literal-source pieces: every output byte
// attributed to a literal-stream range, match chains resolved at token
// granularity (match-of-match follows the already-flattened plan).
// This is the host half of the device replay: with all sources literal,
// the per-byte literal index is a dense device computation and the
// byte materialization becomes one batched reorder instead of
// pointer-chasing gathers (ops/replay.py gather_by_sort).
//
// out_len/out_lit receive piece lengths / literal offsets in output
// order.  Returns the piece count, or -1 when the plan would exceed
// ``cap`` (pathological overlap chains, e.g. byte-RLE - the caller
// falls back to sequential replay).
int64_t flatten_replay(const uint8_t* kinds, const int64_t* lens,
                       const int64_t* dists, int64_t n_tokens,
                       int64_t* out_len, int64_t* out_lit, int64_t cap) {
    std::vector<int64_t> pstart;  // piece output start
    pstart.reserve((size_t)n_tokens);
    int64_t np = 0;
    int64_t op = 0;
    int64_t lp = 0;

    auto append = [&](int64_t lit, int64_t len) -> bool {
        if (np > 0 && out_lit[np - 1] + out_len[np - 1] == lit) {
            out_len[np - 1] += len;  // coalesce lit-continuous pieces
            op += len;
            return true;
        }
        if (np >= cap) return false;
        pstart.resize((size_t)np + 1);
        pstart[np] = op;
        out_lit[np] = lit;
        out_len[np] = len;
        np++;
        op += len;
        return true;
    };

    for (int64_t i = 0; i < n_tokens; i++) {
        int64_t len = lens[i];
        if (len <= 0) continue;
        if (kinds[i] == 0) {
            if (!append(lp, len)) return -1;
            lp += len;
            continue;
        }
        int64_t dist = dists[i];
        if (dist < 1 || dist > op) return -1;  // cross-chunk reach
        int64_t s = op - dist;
        int64_t remaining = len;
        while (remaining > 0) {
            // chunk bounded by dist so sources precede current op
            int64_t m = remaining < dist ? remaining : dist;
            int64_t e = s + m;
            // pieces overlapping [s, e): binary search by output start
            size_t j = (size_t)(std::upper_bound(pstart.begin(),
                                                 pstart.begin() + np, s)
                                - pstart.begin()) - 1;
            int64_t cur = s;
            while (cur < e) {
                int64_t pb = pstart[j];
                int64_t pe = pb + out_len[j];
                int64_t take = (e < pe ? e : pe) - cur;
                if (!append(out_lit[j] + (cur - pb), take)) return -1;
                cur += take;
                j++;
            }
            s += m;
            remaining -= m;
        }
    }
    return np;
}

// -------------------------------------------------- layered flatten

// Layered replay plan: like flatten_replay, but a match whose
// expansion would exceed a length-scaled piece budget (or whose
// source region is itself deferred) becomes ONE output-sourced copy
// resolved in a later kernel pass over the already-materialized
// output - the wavefront form of the reference's self-referential
// fd_hist replay (src/runzip.c:184-241; SURVEY 7.3).  Long matches
// over fragmented regions would otherwise DUPLICATE the region's
// whole piece structure (measured 568K pieces for 157K tokens on the
// 64MB bench chunk; the replay kernel pays ~0.6us per piece).
//
// Per piece: out_len, out_src, out_layer.  layer 0 => src is a
// literal-plane offset; layer k>0 => src is an absolute OUTPUT offset
// whose bytes are complete after pass k-1.  Returns the piece count
// and writes the layer count via *out_layers; -1 on cap overflow or
// layer blowup (caller falls back to the flat plan / sequential).
int64_t flatten_replay_layered(
        const uint8_t* kinds, const int64_t* lens, const int64_t* dists,
        int64_t n_tokens, int64_t frag_num, int64_t frag_den,
        int64_t* out_len, int64_t* out_src, int32_t* out_layer,
        int64_t cap, int32_t* out_layers) {
    const int32_t MAXL = 16;
    std::vector<int64_t> pstart;
    pstart.reserve((size_t)n_tokens);
    int64_t np = 0;
    int64_t op = 0;
    int64_t lp = 0;
    int32_t max_layer = 0;

    auto append = [&](int64_t src, int64_t len, int32_t layer) -> bool {
        if (np > 0 && out_layer[np - 1] == 0 && layer == 0 &&
            out_src[np - 1] + out_len[np - 1] == src) {
            out_len[np - 1] += len;
            op += len;
            return true;
        }
        if (np >= cap) return false;
        pstart.resize((size_t)np + 1);
        pstart[np] = op;
        out_src[np] = src;
        out_len[np] = len;
        out_layer[np] = layer;
        np++;
        op += len;
        return true;
    };

    for (int64_t i = 0; i < n_tokens; i++) {
        int64_t len = lens[i];
        if (len <= 0) continue;
        if (kinds[i] == 0) {
            if (!append(lp, len, 0)) return -1;
            lp += len;
            continue;
        }
        int64_t dist = dists[i];
        if (dist < 1 || dist > op) return -1;
        // resolve the source range to literal runs, TRANSLATING
        // through deferred pieces (bytes at a deferred piece's dst
        // equal bytes at its src): a short match into a copied region
        // inlines via the copy's origin instead of stacking layers.
        // Deferral wins only when the expansion would cost more
        // pieces than the deferred copy's own cell cuts (a deferred
        // range costs ~2 pieces per 8KB cell: dummy + copy), so the
        // inline budget is ~break-even with that: 8 + len/frag_den.
        int64_t budget = 8 + len / frag_den * frag_num;
        if (len > dist) {
            // overlap (RLE-ish) matches MUST inline chunk by chunk
            // (each chunk reads the previous one's bytes; deferring
            // would stack one kernel pass per chunk).  Budget covers
            // the chunk count; pathological byte-RLE falls back to
            // the non-layered paths, as the flat planner always has.
            int64_t chunks = (len + dist - 1) / dist;
            if (chunks > 4096) return -1;
            budget += chunks;
        }
        std::vector<std::pair<int64_t, int64_t>> runs;
        std::function<bool(int64_t, int64_t, int64_t&, int)> resolve =
            [&](int64_t s, int64_t e, int64_t& left, int depth) {
            if (depth > 48) return false;
            size_t j = (size_t)(std::upper_bound(pstart.begin(),
                                                 pstart.begin() + np, s)
                                - pstart.begin()) - 1;
            int64_t cur = s;
            while (cur < e) {
                int64_t pb = pstart[j];
                int64_t pe = pb + out_len[j];
                int64_t take = (e < pe ? e : pe) - cur;
                if (--left < 0) return false;
                int64_t off = out_src[j] + (cur - pb);
                if (out_layer[j] == 0) {
                    runs.emplace_back(off, take);
                } else if (!resolve(off, off + take, left, depth + 1)) {
                    return false;
                }
                cur += take;
                j++;
            }
            return true;
        };
        int64_t left = budget;
        int64_t s = op - dist;
        int64_t remaining = len;
        bool defer_mode = false;
        int32_t next_layer = 0;
        while (remaining > 0) {
            int64_t mm = remaining < dist ? remaining : dist;
            if (!defer_mode) {
                runs.clear();
                if (resolve(s, s + mm, left, 0)) {
                    for (auto& r : runs)
                        if (!append(r.first, r.second, 0)) return -1;
                } else {
                    // switch to deferral from this chunk on; layer =
                    // 1 + max layer over the directly overlapped
                    // pieces, stacking for later RLE chunks (each
                    // reads the previous chunk's bytes)
                    defer_mode = true;
                    int32_t maxl = 0;
                    size_t j = (size_t)(std::upper_bound(
                                            pstart.begin(),
                                            pstart.begin() + np, s)
                                        - pstart.begin()) - 1;
                    int64_t cur = s;
                    while (cur < s + mm) {
                        if (out_layer[j] > maxl) maxl = out_layer[j];
                        int64_t pe = pstart[j] + out_len[j];
                        cur = pe < s + mm ? pe : s + mm;
                        j++;
                    }
                    next_layer = maxl + 1;
                }
            }
            if (defer_mode) {
                if (next_layer > MAXL) return -1;
                if (!append(s, mm, next_layer)) return -1;
                if (next_layer > max_layer) max_layer = next_layer;
                next_layer++;
            }
            s += mm;
            remaining -= mm;
        }
    }
    *out_layers = max_layer;
    return np;
}

// ------------------------------------------------------- defragment

// Fragmentation-aware token selection (encode side): replay cost on
// the accelerator is ~per-PIECE, not per-byte (each fragment of the
// flattened plan costs an aligned-window DMA + merge regardless of
// length - ops/replay_ragged.py), so a short match that copies an
// already-fragmented region can cost far more decode time than the
// few archive bytes it saves.  This pass walks the token stream
// maintaining the same literal-source piece structure flatten_replay
// builds, and DEMOTES to literal any match whose piece expansion
// exceeds a length-scaled budget.  Demoted bytes merge into the
// neighboring literal run, so the rewritten stream stays valid and
// the decoder's plan stays near-linear in output size.
//
// Returns the rewritten token count (<= n_tokens + 1), or -1 when the
// internal piece list would exceed `pcap` (caller keeps the original
// tokens).
int64_t demote_fragmenting_matches(
        const uint8_t* kinds, const int64_t* lens, const int64_t* dists,
        int64_t n_tokens, int64_t frag_num, int64_t frag_den,
        uint8_t* out_kind, int64_t* out_len, int64_t* out_dist,
        int64_t* plen_buf, int64_t* plit_buf, int64_t pcap) {
    std::vector<int64_t> pstart;
    pstart.reserve((size_t)n_tokens);
    int64_t np = 0;
    int64_t op = 0;
    int64_t lp = 0;
    int64_t t = 0;

    auto append_piece = [&](int64_t lit, int64_t len) -> bool {
        if (np > 0 && plit_buf[np - 1] + plen_buf[np - 1] == lit) {
            plen_buf[np - 1] += len;
            op += len;
            return true;
        }
        if (np >= pcap) return false;
        pstart.resize((size_t)np + 1);
        pstart[np] = op;
        plit_buf[np] = lit;
        plen_buf[np] = len;
        np++;
        op += len;
        return true;
    };

    auto emit_token = [&](uint8_t kind, int64_t len, int64_t dist) {
        if (kind == 0 && t > 0 && out_kind[t - 1] == 0) {
            out_len[t - 1] += len;  // merge adjacent literals
            return;
        }
        out_kind[t] = kind;
        out_len[t] = len;
        out_dist[t] = dist;
        t++;
    };

    for (int64_t i = 0; i < n_tokens; i++) {
        int64_t len = lens[i];
        if (len <= 0) continue;
        if (kinds[i] == 0) {
            if (!append_piece(lp, len)) return -1;
            lp += len;
            emit_token(0, len, 0);
            continue;
        }
        int64_t dist = dists[i];
        if (dist < 1 || dist > op) return -1;
        // count the pieces this match would add (same chunking as
        // flatten_replay), against a budget that scales with length:
        // long matches may fragment (their per-byte cost is amortized),
        // short ones must stay near-monolithic
        int64_t budget = 1 + len / frag_den * frag_num;
        int64_t s = op - dist;
        int64_t remaining = len;
        int64_t count = 0;
        bool over = false;
        while (remaining > 0 && !over) {
            int64_t mm = remaining < dist ? remaining : dist;
            int64_t e = s + mm;
            size_t j = (size_t)(std::upper_bound(pstart.begin(),
                                                 pstart.begin() + np, s)
                                - pstart.begin()) - 1;
            int64_t cur = s;
            while (cur < e) {
                int64_t pb = pstart[j];
                int64_t pe = pb + plen_buf[j];
                int64_t take = (e < pe ? e : pe) - cur;
                count++;
                if (count > budget) { over = true; break; }
                cur += take;
                j++;
            }
            s += mm;
            remaining -= mm;
        }
        if (over) {
            // demote: bytes join the literal stream
            if (!append_piece(lp, len)) return -1;
            lp += len;
            emit_token(0, len, 0);
            continue;
        }
        // keep: materialize its pieces (mirrors flatten_replay)
        s = op - dist;
        remaining = len;
        while (remaining > 0) {
            int64_t mm = remaining < dist ? remaining : dist;
            int64_t e = s + mm;
            size_t j = (size_t)(std::upper_bound(pstart.begin(),
                                                 pstart.begin() + np, s)
                                - pstart.begin()) - 1;
            int64_t cur = s;
            while (cur < e) {
                int64_t pb = pstart[j];
                int64_t pe = pb + plen_buf[j];
                int64_t take = (e < pe ? e : pe) - cur;
                if (!append_piece(plit_buf[j] + (cur - pb), take))
                    return -1;
                cur += take;
                j++;
            }
            s += mm;
            remaining -= mm;
        }
        emit_token(1, len, dist);
    }
    return t;
}

// ----------------------------------------------------------------- lzo

// LZO1X-1-style greedy encoder (valid LZO1X bitstream: literal runs,
// M2/M3/M4 matches, trailing-literal folding, EOS marker).
// Returns compressed length, or -1 if output would exceed out_cap.
int64_t lzo1x_encode(const uint8_t* in, int64_t n, uint8_t* out,
                     int64_t out_cap, int32_t* work /* 1<<17 ints */) {
    if (n < 16) return -1;
    const int HASH_BITS = 17;
    const int64_t HSIZE = (int64_t)1 << HASH_BITS;
    for (int64_t i = 0; i < HSIZE; i++) work[i] = -1;

    int64_t op = 0, ip = 0, lit_start = 0;
    bool first = true;
    int64_t trailing_pos = -1;  // byte holding trailing-literal bits

    auto emit_literals_standalone = [&](int64_t from, int64_t count) -> bool {
        if (first && count <= 238) {
            if (op + 1 + count > out_cap) return false;
            out[op++] = (uint8_t)(count + 17);
        } else if (count <= 18) {
            if (op + 1 + count > out_cap) return false;
            out[op++] = (uint8_t)(count - 3);
        } else {
            int64_t tt = count - 18;
            if (op + 4 + count + tt / 255 > out_cap) return false;
            out[op++] = 0;
            while (tt > 255) { out[op++] = 0; tt -= 255; }
            out[op++] = (uint8_t)tt;
        }
        std::memcpy(out + op, in + from, (size_t)count);
        op += count;
        first = false;
        return true;
    };

    const int64_t limit = n - 4;
    while (ip < limit) {
        uint32_t key;
        std::memcpy(&key, in + ip, 4);
        uint32_t h = (key * 2654435761u) >> (32 - HASH_BITS);
        int64_t j = work[h];
        work[h] = (int32_t)ip;
        int64_t mlen = 0, dist = 0;
        if (j >= 0 && j < ip) {
            dist = ip - j;
            if (dist <= 49151 && std::memcmp(in + j, in + ip, 4) == 0) {
                mlen = 4;
                int64_t maxm = n - ip;
                while (mlen < maxm && in[j + mlen] == in[ip + mlen]) mlen++;
            }
        }
        if (mlen >= 4) {
            int64_t pend = ip - lit_start;
            if (pend > 0) {
                if (!first && pend <= 3 && trailing_pos >= 0) {
                    out[trailing_pos] |= (uint8_t)pend;
                    if (op + pend > out_cap) return -1;
                    std::memcpy(out + op, in + lit_start, (size_t)pend);
                    op += pend;
                } else if (pend >= 4 || first) {
                    if (!emit_literals_standalone(lit_start, pend)) return -1;
                } else {
                    // cannot represent 1..3 standalone literals after a
                    // zero-trailing match: emit them via the previous
                    // instruction is impossible; fall back to skipping
                    // the match by one byte
                    ip++;
                    continue;
                }
            }
            if (op + 8 > out_cap) return -1;
            if (mlen <= 8 && dist <= 2048) {
                int64_t d = dist - 1;
                trailing_pos = op;
                out[op++] = (uint8_t)(((mlen - 1) << 5) | ((d & 7) << 2));
                out[op++] = (uint8_t)(d >> 3);
            } else if (dist <= 16384) {
                int64_t d = dist - 1, ml2 = mlen - 2;
                if (ml2 <= 31) {
                    out[op++] = (uint8_t)(32 | ml2);
                } else {
                    out[op++] = 32;
                    int64_t rem = ml2 - 31;
                    while (rem > 255) {
                        if (op + 4 > out_cap) return -1;
                        out[op++] = 0; rem -= 255;
                    }
                    out[op++] = (uint8_t)rem;
                }
                trailing_pos = op;
                out[op++] = (uint8_t)((d << 2) & 0xFF);
                out[op++] = (uint8_t)(d >> 6);
            } else {
                int64_t d = dist - 16384, ml2 = mlen - 2;
                uint8_t hi = (uint8_t)(16 | ((d >> 11) & 8));
                if (ml2 <= 7) {
                    out[op++] = (uint8_t)(hi | ml2);
                } else {
                    out[op++] = hi;
                    int64_t rem = ml2 - 7;
                    while (rem > 255) {
                        if (op + 4 > out_cap) return -1;
                        out[op++] = 0; rem -= 255;
                    }
                    out[op++] = (uint8_t)rem;
                }
                trailing_pos = op;
                out[op++] = (uint8_t)((d << 2) & 0xFF);
                out[op++] = (uint8_t)((d >> 6) & 0xFF);
            }
            // insert a few hash entries inside the match for better chains
            int64_t step = mlen > 64 ? 16 : 4;
            for (int64_t k = ip + 1; k + 4 <= ip + mlen && k < limit;
                 k += step) {
                uint32_t kk;
                std::memcpy(&kk, in + k, 4);
                work[(kk * 2654435761u) >> (32 - HASH_BITS)] = (int32_t)k;
            }
            ip += mlen;
            lit_start = ip;
            first = false;
        } else {
            ip++;
        }
    }
    // tail literals
    int64_t pend = n - lit_start;
    if (pend > 0) {
        if (!first && pend <= 3 && trailing_pos >= 0) {
            out[trailing_pos] |= (uint8_t)pend;
            if (op + pend > out_cap) return -1;
            std::memcpy(out + op, in + lit_start, (size_t)pend);
            op += pend;
        } else {
            if (!emit_literals_standalone(lit_start, pend)) return -1;
        }
    }
    if (op + 3 > out_cap) return -1;
    out[op++] = 17;  // M4 EOS marker: dist 16384, len 3
    out[op++] = 0;
    out[op++] = 0;
    return op;
}

// Full LZO1X decoder (same instruction set as lzo1x_decompress_safe).
// Returns decompressed length or -1 on malformed input / overflow.
int64_t lzo1x_decode(const uint8_t* in, int64_t n, uint8_t* out,
                     int64_t out_cap) {
    int64_t ip = 0, op = 0;
    int state = 0;
    if (n < 3) return -1;
    uint32_t t = in[ip];
    if (t > 17) {
        ip++;
        t -= 17;
        if (ip + (int64_t)t > n || op + (int64_t)t > out_cap) return -1;
        std::memcpy(out + op, in + ip, t);
        ip += t; op += t;
        state = t >= 4 ? 4 : (int)t;
    }
    for (;;) {
        if (ip >= n) return -1;
        t = in[ip++];
        int64_t trailing;
        if (t < 16) {
            if (state == 0) {
                if (t == 0) {
                    while (ip < n && in[ip] == 0) { t += 255; ip++; }
                    if (ip >= n) return -1;
                    t += 15 + in[ip++];
                }
                t += 3;
                if (ip + (int64_t)t > n || op + (int64_t)t > out_cap)
                    return -1;
                std::memcpy(out + op, in + ip, t);
                ip += t; op += t;
                state = 4;
                continue;
            }
            int64_t d;
            int64_t len;
            if (state == 4) {
                if (ip >= n) return -1;
                d = (t >> 2) + ((int64_t)in[ip++] << 2) + 2049;
                len = 3;
            } else {
                if (ip >= n) return -1;
                d = (t >> 2) + ((int64_t)in[ip++] << 2) + 1;
                len = 2;
            }
            if (d > op || op + len > out_cap) return -1;
            for (int64_t k = 0; k < len; k++) out[op + k] = out[op - d + k];
            op += len;
            trailing = t & 3;
        } else if (t >= 64) {
            int64_t len = (t >> 5) + 1;
            if (ip >= n) return -1;
            int64_t d = ((t >> 2) & 7) + ((int64_t)in[ip++] << 3) + 1;
            if (d > op || op + len > out_cap) return -1;
            for (int64_t k = 0; k < len; k++) out[op + k] = out[op - d + k];
            op += len;
            trailing = t & 3;
        } else if (t >= 32) {
            int64_t len = t & 31;
            if (len == 0) {
                while (ip < n && in[ip] == 0) { len += 255; ip++; }
                if (ip >= n) return -1;
                len += 31 + in[ip++];
            }
            if (ip + 2 > n) return -1;
            uint32_t ds = in[ip] | ((uint32_t)in[ip + 1] << 8);
            ip += 2;
            int64_t d = (ds >> 2) + 1;
            len += 2;
            if (d > op || op + len > out_cap) return -1;
            for (int64_t k = 0; k < len; k++) out[op + k] = out[op - d + k];
            op += len;
            trailing = ds & 3;
        } else {
            int64_t len = t & 7;
            int64_t dbits = ((int64_t)(t & 8)) << 11;
            if (len == 0) {
                while (ip < n && in[ip] == 0) { len += 255; ip++; }
                if (ip >= n) return -1;
                len += 7 + in[ip++];
            }
            if (ip + 2 > n) return -1;
            uint32_t ds = in[ip] | ((uint32_t)in[ip + 1] << 8);
            ip += 2;
            int64_t d = 16384 + dbits + (ds >> 2);
            if (d == 16384) break;  // EOS
            len += 2;
            if (d > op || op + len > out_cap) return -1;
            for (int64_t k = 0; k < len; k++) out[op + k] = out[op - d + k];
            op += len;
            trailing = ds & 3;
        }
        if (trailing) {
            if (ip + trailing > n || op + trailing > out_cap) return -1;
            std::memcpy(out + op, in + ip, (size_t)trailing);
            ip += trailing; op += trailing;
            state = (int)trailing;
        } else {
            state = 0;
        }
    }
    return op;
}

}  // extern "C"

extern "C" {

// ------------------------------------------------------- host matcher

// Native greedy rzip matcher - the host-CPU fast path for
// models/rzip_host.rzip_encode_chunk (no TPU present).  Design mirrors
// the reference's hash_search (src/rzip.c:586-762): a rolling hash over
// 32-byte windows feeds a direct-mapped last-occurrence table; hits are
// verified with byte compares, extended both ways, and emitted greedily
// left to right.  Buzhash rolling (rotate/XOR) replaces the reference's
// Zobrist tag roll; the direct-mapped table replaces its open-addressed
// chains (we keep only the most recent occurrence - nearest-previous is
// what the greedy wants anyway).
//
// Returns token count (kind/len/dist filled), or -1 if cap is too
// small.  cap >= n / 16 + 3 always suffices: every match token covers
// >= min_match bytes and literals coalesce.
int64_t rzip_encode_host(const uint8_t* data, int64_t n,
                         int64_t min_match, int hash_bits,
                         uint32_t* table /* 1 << hash_bits, zeroed */,
                         uint8_t* out_kind, int64_t* out_len,
                         int64_t* out_dist, int64_t cap) {
    const int W = 32;  // rolling window (covers min_match = 31)
    int64_t t = 0;
    auto emit = [&](int kind, int64_t len, int64_t dist) -> bool {
        if (t >= cap) return false;
        out_kind[t] = (uint8_t)kind;
        out_len[t] = len;
        out_dist[t] = dist;
        t++;
        return true;
    };
    if (n <= W) {
        if (n > 0 && !emit(0, n, 0)) return -1;
        return t;
    }

    // Buzhash table: deterministic pseudo-random 64-bit values
    uint64_t G[256];
    uint64_t seed = 0x9E3779B97F4A7C15ull;
    for (int i = 0; i < 256; i++) {
        seed ^= seed >> 30; seed *= 0xBF58476D1CE4E5B9ull;
        seed ^= seed >> 27; seed *= 0x94D049BB133111EBull;
        seed ^= seed >> 31;
        G[i] = seed;
    }
    auto rotl = [](uint64_t v, int r) {
        return (v << r) | (v >> (64 - r));
    };
    auto seed_hash = [&](int64_t p) {
        uint64_t h = 0;
        for (int i = 0; i < W; i++)
            h = rotl(h, 1) ^ G[data[p + i]];
        return h;
    };

    const uint64_t mask = ((uint64_t)1 << hash_bits) - 1;
    const int64_t m = n - W + 1;
    int64_t lit_start = 0;   // start of the pending literal run
    int64_t p = 0;
    uint64_t h = seed_hash(0);
    while (p < m) {
        uint64_t slot = (h * 0x9E3779B97F4A7C15ull) >> 1;
        slot &= mask;
        uint32_t prev = table[slot];
        table[slot] = (uint32_t)(p + 1);  // 0 = empty
        if (prev != 0) {
            int64_t q = (int64_t)prev - 1;
            if (q < p) {
                // verify + extend forward
                int64_t len = 0;
                int64_t maxl = n - p;
                while (len < maxl && data[q + len] == data[p + len])
                    len++;
                if (len >= min_match) {
                    int64_t dist = p - q;
                    int64_t start = p;
                    // extend left into the pending literal run
                    while (start > lit_start && start - dist > 0 &&
                           data[start - 1] == data[start - 1 - dist]) {
                        start--;
                        len++;
                    }
                    if (start > lit_start &&
                        !emit(0, start - lit_start, 0))
                        return -1;
                    if (!emit(1, len, dist)) return -1;
                    p = start + len;
                    lit_start = p;
                    if (p >= m) break;
                    h = seed_hash(p);
                    continue;
                }
            }
        }
        // roll one byte forward
        h = rotl(h, 1) ^ rotl(G[data[p]], W & 63) ^ G[data[p + W]];
        p++;
    }
    if (lit_start < n && !emit(0, n - lit_start, 0)) return -1;
    return t;
}

}  // extern "C"
