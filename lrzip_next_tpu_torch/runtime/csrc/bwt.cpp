// BWT-family block codec for the bzip3 backend slot (CTYPE 9).
//
// The reference links an external libbz3 (configure.ac:123-178; calls at
// src/stream.c:231-274 via bz3_new/bz3_encode_block).  No libbz3 source
// or test vectors exist in this environment, so bit-compatibility with
// libbz3 cannot be established; this is a from-scratch BWT codec of the
// same family and strength class (block-sorting + MTF + zero-run coding
// + adaptive range coder), self-interoperable and guarded by its own
// block magic.  See lrzip_next_tpu/backends/bzip3_codec.py for the
// framing and the compatibility note.
//
// Pipeline per block:
//   SA-IS suffix array (linear time, any alphabet)  ->  BWT with an
//   explicit virtual sentinel (row index stored)    ->  move-to-front
//   ->  RUNA/RUNB zero-run coding (the bzip2 trick) ->  binary range
//   coder with an adaptive bit-tree model conditioned on symbol class.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ------------------------------------------------------------- SA-IS

// Generic SA-IS over an int32 string `s` of length n with alphabet
// size K (values 0..K-1).  Writes suffix array into sa.
void sais_int(const int32_t* s, int32_t* sa, int32_t n, int32_t K,
              std::vector<int32_t>& scratch) {
    if (n == 0) return;
    if (n == 1) { sa[0] = 0; return; }
    // comb[j] = (s[j] << 1) | is_s[j]: the induce scans read s[j-1] and
    // is_s[j-1] at random j - one fused array halves their cache misses.
    // Built branchless in one backward pass (no separate is_s array).
    std::vector<int32_t> comb(n);
    comb[n - 1] = (s[n - 1] << 1) | 1;  // last suffix: the sentinel
    {
        uint32_t t = 1;
        for (int32_t i = n - 2; i >= 0; i--) {
            t = (uint32_t)(s[i] < s[i + 1]) |
                ((uint32_t)(s[i] == s[i + 1]) & t);
            comb[i] = (s[i] << 1) | (int32_t)t;
        }
    }
    auto is_lms = [&](int32_t i) {
        return i > 0 && (comb[i] & 1) && !(comb[i - 1] & 1);
    };

    std::vector<int32_t> bkt(K + 1), tail(K), head(K);
    auto bucket_bounds = [&]() {
        std::fill(bkt.begin(), bkt.end(), 0);
        for (int32_t i = 0; i < n; i++) bkt[s[i] + 1]++;
        for (int32_t c = 0; c < K; c++) bkt[c + 1] += bkt[c];
    };
    bucket_bounds();

    auto induce = [&](const std::vector<int32_t>& lms) {
        std::fill(sa, sa + n, -1);
        // place LMS suffixes at ends of their buckets (reverse order)
        for (int32_t c = 0; c < K; c++) tail[c] = bkt[c + 1];
        for (int32_t j = (int32_t)lms.size() - 1; j >= 0; j--) {
            int32_t i = lms[j];
            sa[--tail[s[i]]] = i;
        }
        // induce L-type from left
        for (int32_t c = 0; c < K; c++) head[c] = bkt[c];
        for (int32_t k = 0; k < n; k++) {
            int32_t jp = sa[k + 48 < n ? k + 48 : n - 1];
            if (jp > 0) __builtin_prefetch(&comb[jp - 1], 0, 1);
            int32_t j = sa[k];
            if (j > 0) {
                int32_t cb = comb[j - 1];
                if (!(cb & 1)) sa[head[cb >> 1]++] = j - 1;
            }
        }
        // induce S-type from right
        for (int32_t c = 0; c < K; c++) tail[c] = bkt[c + 1];
        for (int32_t k = n - 1; k >= 0; k--) {
            int32_t jp = sa[k >= 48 ? k - 48 : 0];
            if (jp > 0) __builtin_prefetch(&comb[jp - 1], 0, 1);
            int32_t j = sa[k];
            if (j > 0) {
                int32_t cb = comb[j - 1];
                if (cb & 1) sa[--tail[cb >> 1]] = j - 1;
            }
        }
    };

    std::vector<int32_t> lms;
    for (int32_t i = 1; i < n; i++)
        if (is_lms(i)) lms.push_back(i);

    induce(lms);

    // compact sorted LMS suffixes and name their substrings
    std::vector<int32_t> sorted_lms;
    sorted_lms.reserve(lms.size());
    for (int32_t k = 0; k < n; k++) {
        int32_t jp = sa[k + 16 < n ? k + 16 : n - 1];
        if (jp >= 0) __builtin_prefetch(&comb[jp], 0, 1);
        if (is_lms(sa[k])) sorted_lms.push_back(sa[k]);
    }

    // scalar LMS-substring equality on the fused comb array (equal comb
    // entries == equal (char, type) pairs)
    auto lms_eq_scalar = [&](int32_t p, int32_t q, int32_t d) -> bool {
        for (;; d++) {
            if (p + d >= n || q + d >= n ||
                comb[p + d] != comb[q + d]) return false;
            bool le = is_lms(p + d), lj = is_lms(q + d);
            if (d > 0 && (le || lj)) return le && lj;
        }
    };
    // word-wise: 2 comb entries per 8-byte load (the int32 twin of
    // sais_u8's u16 version; see the boundary-bit derivation there)
    const uint64_t kLSB32 = 0x0000000100000001ull;
    auto lms_eq = [&](int32_t p, int32_t q) -> bool {
        uint64_t carry = (uint64_t)(comb[p - 1] & 1);  // p is LMS: 0
        for (int32_t d = 0;;) {
            if (p + d + 2 > n || q + d + 2 > n)
                return lms_eq_scalar(p, q, d);
            uint64_t x, y;
            std::memcpy(&x, &comb[p + d], 8);
            std::memcpy(&y, &comb[q + d], 8);
            uint64_t m = x & kLSB32;
            uint64_t rises = m & ~((m << 32) | carry);
            if (d == 0) rises &= ~0xFFFFFFFFull;  // offset 0 is the start
            uint64_t diff = x ^ y;
            if (rises) {
                if (!diff) return true;
                int t = __builtin_ctzll(rises) >> 5;
                int db = __builtin_ctzll(diff) >> 5;
                return db > t;
            }
            if (diff) return false;
            carry = (x >> 32) & 1;
            d += 2;
        }
    };

    std::vector<int32_t> name(n, -1);
    int32_t names = 0;
    int32_t prev = -1;
    const size_t n_sl = sorted_lms.size();
    for (size_t ki = 0; ki < n_sl; ki++) {
        if (ki + 4 < n_sl) {
            int32_t f = sorted_lms[ki + 4];
            __builtin_prefetch(&comb[f], 0, 1);
            __builtin_prefetch((const char*)&comb[f] + 64, 0, 1);
        }
        int32_t j = sorted_lms[ki];
        if (prev < 0) {
            name[j] = names++;
        } else {
            name[j] = lms_eq(prev, j) ? names - 1 : names++;
        }
        prev = j;
    }

    if (names < (int32_t)lms.size()) {
        // recurse on the named LMS string
        std::vector<int32_t> s1(lms.size()), sa1(lms.size());
        for (size_t k = 0; k < lms.size(); k++) s1[k] = name[lms[k]];
        sais_int(s1.data(), sa1.data(), (int32_t)lms.size(), names,
                 scratch);
        std::vector<int32_t> ordered(lms.size());
        for (size_t k = 0; k < lms.size(); k++)
            ordered[k] = lms[sa1[k]];
        induce(ordered);
    } else {
        // names unique: LMS substring order == LMS suffix order
        induce(sorted_lms);
    }
}

// Byte-specialized top level of SA-IS: suffix array of S' = in +
// [virtual sentinel] written into sa (n+1 slots).  Same algorithm as
// sais_int, but never materialises the int32 copy of the text: types
// and characters live in one uint16 array (halving the random-read
// cache footprint of the induce scans, the pass that dominates), the
// sentinel is virtual (always sa[0]), and the scans software-prefetch
// the comb word of the suffix a few sa slots ahead.  Recursion levels
// still use the generic sais_int (their strings are ~n/3 and shrink).
void sais_u8(const uint8_t* in, int32_t* sa, int32_t n) {
    if (n <= 0) { if (n == 0) sa[0] = 0; return; }
    if (n == 1) { sa[0] = 1; sa[1] = 0; return; }
    // comb[i] = (in[i] << 1) | is_s[i]; virtual comb(n) = 0xFFFF
    std::vector<uint16_t> comb(n);
    comb[n - 1] = (uint16_t)(in[n - 1] << 1);  // > sentinel: L-type
    {
        // branchless: t_i = (s_i < s_{i+1}) | ((s_i == s_{i+1}) & t_{i+1})
        uint32_t t = 0;
        for (int32_t i = n - 2; i >= 0; i--) {
            t = (uint32_t)(in[i] < in[i + 1]) |
                ((uint32_t)(in[i] == in[i + 1]) & t);
            comb[i] = (uint16_t)(((uint32_t)in[i] << 1) | t);
        }
    }
    auto is_lms = [&](int32_t i) {
        return i > 0 && (i == n ||
                         ((comb[i] & 1) && !(comb[i - 1] & 1)));
    };
    int32_t bkt[257];
    std::memset(bkt, 0, sizeof(bkt));
    for (int32_t i = 0; i < n; i++) bkt[in[i] + 1]++;
    for (int32_t c = 0; c < 256; c++) bkt[c + 1] += bkt[c];
    int32_t head[256], tail[256];

    auto induce = [&](const std::vector<int32_t>& lms) {
        std::fill(sa, sa + n + 1, -1);
        sa[0] = n;  // sentinel suffix: smallest, own bucket
        // place LMS suffixes at ends of their buckets (reverse order)
        for (int32_t c = 0; c < 256; c++) tail[c] = 1 + bkt[c + 1];
        for (int32_t j = (int32_t)lms.size() - 1; j >= 0; j--) {
            int32_t i = lms[j];
            if (i < n) sa[--tail[in[i]]] = i;
        }
        // induce L-type from left
        for (int32_t c = 0; c < 256; c++) head[c] = 1 + bkt[c];
        for (int32_t k = 0; k <= n; k++) {
            int32_t jp = sa[k + 48 <= n ? k + 48 : n];
            if (jp > 0) __builtin_prefetch(&comb[jp - 1], 0, 1);
            int32_t j = sa[k];
            if (j > 0) {
                uint16_t cb = comb[j - 1];
                if (!(cb & 1)) sa[head[cb >> 1]++] = j - 1;
            }
        }
        // induce S-type from right
        for (int32_t c = 0; c < 256; c++) tail[c] = 1 + bkt[c + 1];
        for (int32_t k = n; k >= 0; k--) {
            int32_t jp = sa[k >= 48 ? k - 48 : 0];
            if (jp > 0) __builtin_prefetch(&comb[jp - 1], 0, 1);
            int32_t j = sa[k];
            if (j > 0) {
                uint16_t cb = comb[j - 1];
                if (cb & 1) sa[--tail[cb >> 1]] = j - 1;
            }
        }
    };

    std::vector<int32_t> lms;  // ascending; includes the sentinel (n)
    for (int32_t i = 1; i <= n; i++)
        if (is_lms(i)) lms.push_back(i);

    induce(lms);

    // compact sorted LMS suffixes and name their substrings.  sa[k] is
    // random, so is_lms's comb reads miss; prefetch a few slots ahead.
    std::vector<int32_t> sorted_lms;
    sorted_lms.reserve(lms.size());
    for (int32_t k = 0; k <= n; k++) {
        int32_t jp = sa[k + 16 <= n ? k + 16 : n];
        if (jp > 0 && jp <= n) __builtin_prefetch(&comb[jp - 1], 0, 1);
        if (is_lms(sa[k])) sorted_lms.push_back(sa[k]);
    }

    auto cmb = [&](int32_t i) -> uint32_t {
        return i < n ? comb[i] : 0xFFFFu;  // unique sentinel marker
    };
    // scalar LMS-substring equality (chars+types through the
    // terminating LMS position); the sentinel marker can only match
    // itself, and only one substring reaches it
    auto lms_eq_scalar = [&](int32_t p, int32_t q, int32_t d) -> bool {
        for (;; d++) {
            if (cmb(p + d) != cmb(q + d)) return false;
            bool le = is_lms(p + d), lj = is_lms(q + d);
            if (d > 0 && (le || lj)) return le && lj;
        }
    };
    // word-wise version: compare 4 comb entries per step.  A substring
    // boundary is a 0->1 transition of the S-type bit (bit 0 of each
    // u16); within an equal prefix both substrings share it, so the
    // check reduces to "no XOR difference at or before the first
    // boundary".  Naming touches 2 random streams per pair, so halving
    // the touched words matters (~2x on the 8MB text naming pass).
    const uint64_t kLSB = 0x0001000100010001ull;
    auto lms_eq = [&](int32_t p, int32_t q) -> bool {
        uint64_t carry = (uint64_t)(comb[p - 1] & 1);  // p is LMS: 0
        for (int32_t d = 0;;) {
            if (p + d + 4 > n || q + d + 4 > n)
                return lms_eq_scalar(p, q, d);
            uint64_t x, y;
            std::memcpy(&x, &comb[p + d], 8);
            std::memcpy(&y, &comb[q + d], 8);
            uint64_t m = x & kLSB;
            uint64_t rises = m & ~((m << 16) | carry);
            if (d == 0) rises &= ~0xFFFFull;  // offset 0 is the start
            uint64_t diff = x ^ y;
            if (rises) {
                if (!diff) return true;
                int t = __builtin_ctzll(rises) >> 4;
                int db = __builtin_ctzll(diff) >> 4;
                return db > t;
            }
            if (diff) return false;
            carry = (x >> 48) & 1;
            d += 4;
        }
    };
    std::vector<int32_t> name(n + 1, -1);
    int32_t names = 0;
    int32_t prev = -1;
    const size_t n_sl = sorted_lms.size();
    for (size_t ki = 0; ki < n_sl; ki++) {
        // each compare walks comb at two random positions; prefetch the
        // start (2 lines) of the pair 4 iterations out
        if (ki + 4 < n_sl) {
            int32_t f = sorted_lms[ki + 4];
            if (f < n) {
                __builtin_prefetch(&comb[f], 0, 1);
                __builtin_prefetch((const char*)&comb[f] + 64, 0, 1);
            }
        }
        int32_t j = sorted_lms[ki];
        if (prev < 0) {
            name[j] = names++;
        } else {
            bool same = prev < n && j < n ? lms_eq(prev, j)
                                          : lms_eq_scalar(prev, j, 0);
            name[j] = same ? names - 1 : names++;
        }
        prev = j;
    }

    if (names < (int32_t)lms.size()) {
        // recurse on the named LMS string (generic int path)
        std::vector<int32_t> s1(lms.size()), sa1(lms.size());
        for (size_t k = 0; k < lms.size(); k++) s1[k] = name[lms[k]];
        std::vector<int32_t> scratch;
        sais_int(s1.data(), sa1.data(), (int32_t)lms.size(), names,
                 scratch);
        std::vector<int32_t> ordered(lms.size());
        for (size_t k = 0; k < lms.size(); k++) {
            if (k + 16 < lms.size())
                __builtin_prefetch(&lms[sa1[k + 16]], 0, 1);
            ordered[k] = lms[sa1[k]];
        }
        induce(ordered);
    } else {
        induce(sorted_lms);
    }
}

// BWT with explicit sentinel: conceptual string S' = S + [256].
// Returns primary row q (where the sentinel character would sit in the
// BWT column); out gets the n remaining BWT bytes.
int32_t bwt_forward(const uint8_t* in, uint8_t* out, int32_t n) {
    std::vector<int32_t> sa(n + 1);
    sais_u8(in, sa.data(), n);
    // rotations of S' sorted = suffix order (sentinel ends the string)
    int32_t q = -1, w = 0;
    for (int32_t i = 0; i <= n; i++) {
        int32_t j = sa[i];
        if (j == 0) { q = i; continue; }  // char before suffix 0 = sentinel
        out[w++] = in[j - 1];
    }
    return q;
}

// BWT with checkpoint extraction: like bwt_forward, but also records
// the row of suffix k (the inverse suffix array) at the c-1 interior
// chain split points k = L, 2L, ... ((c-1)L), L = ceil(n/c).  The
// decoder starts chain t at ckpt[t-1] and walks its output range
// independently - c interleaved LF chains overlap the dependent-load
// latency that makes the single-chain walk ~16 MB/s.
int32_t bwt_forward_ck(const uint8_t* in, uint8_t* out, int32_t n,
                       int c, uint32_t* ckpt) {
    std::vector<int32_t> sa(n + 1);
    sais_u8(in, sa.data(), n);
    const int64_t L = ((int64_t)n + c - 1) / c;
    int32_t q = -1, w = 0;
    for (int32_t i = 0; i <= n; i++) {
        int32_t j = sa[i];
        if (j == 0) { q = i; continue; }
        if (c > 1 && j % L == 0 && j / L <= c - 1)
            ckpt[j / L - 1] = (uint32_t)i;
        out[w++] = in[j - 1];
    }
    return q;
}

// Multi-chain inverse BWT: each chain t reconstructs output range
// [tL, min((t+1)L, n)) walking backward from its checkpoint row; the
// last chain starts at row 0 (the sentinel rotation).  lf and symbol
// are packed into one word per row to halve the walk's cache footprint.
void bwt_inverse_mc(const uint8_t* bwt, uint8_t* out, int32_t n,
                    int32_t q, int c, const uint32_t* ckpt) {
    const int64_t L = ((int64_t)n + c - 1) / c;
    int32_t cnt[258] = {0};
    {
        // symbol counts (sentinel = 0, byte b = b+1)
        cnt[0 + 1]++;
        for (int32_t i = 0; i < n; i++) cnt[bwt[i] + 2]++;
        for (int32_t ch = 0; ch < 257; ch++) cnt[ch + 1] += cnt[ch];
    }
    auto run_walk = [&](auto* pk, auto pack, auto unpack_lf,
                        auto unpack_sym) {
        for (int32_t i = 0, w = 0; i <= n; i++) {
            int32_t sym = (i == q) ? 0 : (int32_t)bwt[w++] + 1;
            pk[i] = pack(cnt[sym]++, sym);
        }
        int32_t p[64];
        int64_t kc[64], ks[64];
        for (int t = 0; t < c; t++) {
            int64_t kend = (t == c - 1) ? n : (t + 1) * L;
            ks[t] = t * L;
            kc[t] = kend - 1;
            p[t] = (t == c - 1) ? 0 : (int32_t)ckpt[t];
        }
        for (;;) {
            bool any = false;
            for (int t = 0; t < c; t++) {
                if (kc[t] < ks[t]) continue;
                any = true;
                auto v = pk[p[t]];
                out[kc[t]--] = (uint8_t)(unpack_sym(v) - 1);
                p[t] = unpack_lf(v);
            }
            if (!any) break;
        }
    };
    if ((int64_t)n + 1 < ((int64_t)1 << 23)) {
        std::vector<uint32_t> pk(n + 1);
        run_walk(pk.data(),
                 [](int32_t lf, int32_t sym) {
                     return (uint32_t)((lf << 9) | sym); },
                 [](uint32_t v) { return (int32_t)(v >> 9); },
                 [](uint32_t v) { return (int32_t)(v & 511); });
    } else {
        std::vector<uint64_t> pk(n + 1);
        run_walk(pk.data(),
                 [](int32_t lf, int32_t sym) {
                     return ((uint64_t)lf << 9) | (uint64_t)sym; },
                 [](uint64_t v) { return (int32_t)(v >> 9); },
                 [](uint64_t v) { return (int32_t)(v & 511); });
    }
}

// Inverse BWT for the explicit-sentinel formulation.
void bwt_inverse(const uint8_t* bwt, uint8_t* out, int32_t n,
                 int32_t q) {
    // reinsert sentinel (symbol 256) at row q; alphabet 0..256 where
    // byte b is symbol b+1 and sentinel is 0
    std::vector<int32_t> col(n + 1);
    for (int32_t i = 0, w = 0; i <= n; i++)
        col[i] = (i == q) ? 0 : (int32_t)bwt[w++] + 1;
    int32_t cnt[258] = {0};
    for (int32_t i = 0; i <= n; i++) cnt[col[i] + 1]++;
    for (int32_t c = 0; c < 257; c++) cnt[c + 1] += cnt[c];
    std::vector<int32_t> lf(n + 1);
    for (int32_t i = 0; i <= n; i++) lf[i] = cnt[col[i]]++;
    // row 0 is the sentinel-first rotation "$S"; its BWT char is
    // S[n-1], and LF steps walk the string right-to-left
    int32_t p = 0;
    for (int32_t k = n - 1; k >= 0; k--) {
        int32_t c = col[p];
        out[k] = (uint8_t)(c - 1);
        p = lf[p];
    }
}

// ------------------------------------------------------- range coder

struct RangeEncoder {
    std::vector<uint8_t>& out;
    uint64_t low = 0;
    uint32_t range = 0xFFFFFFFFu;
    uint8_t cache = 0;
    int64_t cache_size = 1;
    explicit RangeEncoder(std::vector<uint8_t>& o) : out(o) {}
    void shift_low() {
        if ((uint32_t)(low >> 32) != 0 || (uint32_t)low < 0xFF000000u) {
            uint8_t carry = (uint8_t)(low >> 32);
            while (cache_size) {
                out.push_back((uint8_t)(cache + carry));
                cache = 0xFF;
                cache_size--;
            }
            cache = (uint8_t)(low >> 24);
        }
        cache_size++;
        low = (low << 8) & 0xFFFFFFFFu;
    }
    void encode_bit(uint16_t& prob, int bit) {
        uint32_t bound = (range >> 12) * prob;
        if (!bit) {
            range = bound;
            prob += (uint16_t)((4096 - prob) >> 5);
        } else {
            low += bound;
            range -= bound;
            prob -= (uint16_t)(prob >> 5);
        }
        while (range < (1u << 24)) { range <<= 8; shift_low(); }
    }
    void flush() { for (int i = 0; i < 5; i++) shift_low(); }
};

struct RangeDecoder {
    const uint8_t* in;
    int64_t n, p = 0;
    uint32_t range = 0xFFFFFFFFu, code = 0;
    RangeDecoder(const uint8_t* i, int64_t len) : in(i), n(len) {
        p = 1;  // first byte from the encoder cache is always 0
        for (int k = 0; k < 4; k++)
            code = (code << 8) | (p < n ? in[p++] : 0);
    }
    int decode_bit(uint16_t& prob) {
        uint32_t bound = (range >> 12) * prob;
        int bit;
        if (code < bound) {
            range = bound;
            prob += (uint16_t)((4096 - prob) >> 5);
            bit = 0;
        } else {
            code -= bound;
            range -= bound;
            prob -= (uint16_t)(prob >> 5);
            bit = 1;
        }
        while (range < (1u << 24)) {
            range <<= 8;
            code = (code << 8) | (p < n ? in[p++] : 0);
        }
        return bit;
    }
};

// ------------------------------------------------- MTF + RLE + model
//
// Post-MTF symbols: runs of zeros become RUNA/RUNB bijective base-2
// digits (bzip2's trick, vendored reference analog huffman.c); other
// MTF values v become symbol v+1.  Alphabet: 0=RUNA, 1=RUNB,
// 2..256=v+1, 257=EOB.
constexpr int NSYM = 258;
constexpr int SYM_BITS = 9;

// adaptive bit-tree over 9-bit symbols, conditioned on a 3-way class
// of the previous symbol (run digit / small / large) - cheap context
// that buys most of an order-1 model's gain on BWT output.
struct SymModel {
    uint16_t tree[3][1 << SYM_BITS];
    SymModel() {
        for (int c = 0; c < 3; c++)
            for (int i = 0; i < (1 << SYM_BITS); i++)
                tree[c][i] = 2048;
    }
    static int clas(int prev_sym) {
        if (prev_sym <= 1) return 0;
        if (prev_sym <= 9) return 1;
        return 2;
    }
    void encode(RangeEncoder& rc, int ctx, int sym) {
        int node = 1;
        for (int b = SYM_BITS - 1; b >= 0; b--) {
            int bit = (sym >> b) & 1;
            rc.encode_bit(tree[ctx][node], bit);
            node = (node << 1) | bit;
        }
    }
    int decode(RangeDecoder& rc, int ctx) {
        int node = 1;
        for (int b = 0; b < SYM_BITS; b++)
            node = (node << 1) | rc.decode_bit(tree[ctx][node]);
        return node - (1 << SYM_BITS);
    }
};

void mtf_rle_encode(const uint8_t* in, int32_t n,
                    std::vector<uint8_t>& out) {
    uint8_t order[256];
    for (int i = 0; i < 256; i++) order[i] = (uint8_t)i;
    RangeEncoder rc(out);
    SymModel model;
    int ctx = 0;
    int64_t zrun = 0;
    auto flush_run = [&]() {
        // bijective base-2: run r >= 1 emits digits d in {1,2} with
        // r = sum d_i * 2^i (RUNA=1, RUNB=2)
        int64_t r = zrun;
        while (r > 0) {
            int d = (r & 1) ? 0 : 1;  // odd -> RUNA(1), even -> RUNB(2)
            model.encode(rc, ctx, d);
            ctx = 0;
            r = (r - (d == 0 ? 1 : 2)) >> 1;
        }
        zrun = 0;
    };
    for (int32_t i = 0; i < n; i++) {
        uint8_t c = in[i];
        int j = 0;
        while (order[j] != c) j++;
        std::memmove(order + 1, order, j);
        order[0] = c;
        if (j == 0) { zrun++; continue; }
        flush_run();
        int sym = j + 1;
        model.encode(rc, ctx, sym);
        ctx = SymModel::clas(sym);
    }
    flush_run();
    model.encode(rc, ctx, 257);  // EOB
    rc.flush();
}

// returns bytes written or -1 on corrupt stream
int32_t mtf_rle_decode(const uint8_t* in, int64_t n, uint8_t* out,
                       int32_t cap) {
    uint8_t order[256];
    for (int i = 0; i < 256; i++) order[i] = (uint8_t)i;
    RangeDecoder rc(in, n);
    SymModel model;
    int ctx = 0;
    int32_t w = 0;
    int64_t zrun = 0, zmult = 1;
    auto flush_run = [&]() -> bool {
        for (int64_t k = 0; k < zrun; k++) {
            if (w >= cap) return false;
            out[w++] = order[0];
        }
        zrun = 0;
        zmult = 1;
        return true;
    };
    for (;;) {
        int sym = model.decode(rc, ctx);
        if (sym == 257) break;
        if (sym <= 1) {
            zrun += (sym == 0 ? 1 : 2) * zmult;
            zmult <<= 1;
            if (zrun > cap) return -1;
            ctx = 0;
            continue;
        }
        if (!flush_run()) return -1;
        int j = sym - 1;
        if (j > 255) return -1;
        uint8_t c = order[j];
        std::memmove(order + 1, order, j);
        order[0] = c;
        if (w >= cap) return -1;
        out[w++] = c;
        ctx = SymModel::clas(sym);
    }
    if (!flush_run()) return -1;
    return w;
}

// ------------------------------------------- v2 structured coder ------
//
// The flat 9-bit symbol tree costs 9 adaptive-bit operations for every
// symbol - including the RUNA/RUNB digits that dominate BWT+MTF output.
// The v2 layout decomposes the alphabet so common symbols are cheap:
//
//   [is-run bit]                       run digits: +1 bit (RUNA/RUNB)
//   else [is-EOB bit]                  almost always 0
//        [3-bit tree: nb = bit_length(v)]
//        [per-nb bit tree: nb-1 mantissa bits]
//
// Identical modeling power to the flat tree for large values, ~2 coder
// bits for run digits and ~5 for v=1: ~2.5x faster on typical output.

struct SymModel2 {
    uint16_t p_isrun[3];
    uint16_t p_runv[3];
    uint16_t p_eob[3];
    uint16_t p_nb[3][8];        // 3-bit tree (indices 1..7)
    uint16_t p_mant[3][8][128]; // per-nb bit tree over mantissa
    SymModel2() {
        uint16_t* p = (uint16_t*)this;
        size_t total = sizeof(SymModel2) / sizeof(uint16_t);
        for (size_t i = 0; i < total; i++) p[i] = 2048;
    }
    static int clas(int v) {  // v = MTF index (0 handled as run)
        if (v <= 1) return 0;
        if (v <= 8) return 1;
        return 2;
    }
    void encode_run(RangeEncoder& rc, int ctx, int digit) {
        rc.encode_bit(p_isrun[ctx], 1);
        rc.encode_bit(p_runv[ctx], digit);
    }
    void encode_val(RangeEncoder& rc, int ctx, int v) {  // v in 1..255
        rc.encode_bit(p_isrun[ctx], 0);
        rc.encode_bit(p_eob[ctx], 0);
        int nb = 32 - __builtin_clz((unsigned)v);  // 1..8
        int node = 1;
        for (int b = 2; b >= 0; b--) {
            int bit = ((nb - 1) >> b) & 1;
            rc.encode_bit(p_nb[ctx][node], bit);
            node = (node << 1) | bit;
        }
        int mant = v - (1 << (nb - 1));
        uint16_t* tree = p_mant[ctx][nb - 1];
        node = 1;
        for (int b = nb - 2; b >= 0; b--) {
            int bit = (mant >> b) & 1;
            rc.encode_bit(tree[node], bit);
            node = (node << 1) | bit;
        }
    }
    void encode_eob(RangeEncoder& rc, int ctx) {
        rc.encode_bit(p_isrun[ctx], 0);
        rc.encode_bit(p_eob[ctx], 1);
    }
    // returns -1 EOB, 0/1 run digit as -2/-3, else value 1..255
    int decode(RangeDecoder& rc, int ctx) {
        if (rc.decode_bit(p_isrun[ctx]))
            return -2 - rc.decode_bit(p_runv[ctx]);
        if (rc.decode_bit(p_eob[ctx])) return -1;
        int node = 1;
        for (int b = 0; b < 3; b++)
            node = (node << 1) | rc.decode_bit(p_nb[ctx][node]);
        int nb = (node - 8) + 1;
        uint16_t* tree = p_mant[ctx][nb - 1];
        node = 1;
        for (int b = 0; b < nb - 1; b++)
            node = (node << 1) | rc.decode_bit(tree[node]);
        int mant = node - (1 << (nb - 1));
        return (1 << (nb - 1)) + mant;
    }
};

void mtf_rle_encode2(const uint8_t* in, int32_t n,
                     std::vector<uint8_t>& out) {
    uint8_t order[256];
    for (int i = 0; i < 256; i++) order[i] = (uint8_t)i;
    RangeEncoder rc(out);
    SymModel2 model;
    int ctx = 0;
    int64_t zrun = 0;
    auto flush_run = [&]() {
        int64_t r = zrun;
        while (r > 0) {
            int d = (r & 1) ? 0 : 1;  // odd -> RUNA, even -> RUNB
            model.encode_run(rc, ctx, d);
            ctx = 0;
            r = (r - (d == 0 ? 1 : 2)) >> 1;
        }
        zrun = 0;
    };
    for (int32_t i = 0; i < n; i++) {
        uint8_t c = in[i];
        int j = 0;
        while (order[j] != c) j++;
        std::memmove(order + 1, order, j);
        order[0] = c;
        if (j == 0) { zrun++; continue; }
        flush_run();
        model.encode_val(rc, ctx, j);
        ctx = SymModel2::clas(j);
    }
    flush_run();
    model.encode_eob(rc, ctx);
    rc.flush();
}

int32_t mtf_rle_decode2(const uint8_t* in, int64_t n, uint8_t* out,
                        int32_t cap) {
    uint8_t order[256];
    for (int i = 0; i < 256; i++) order[i] = (uint8_t)i;
    RangeDecoder rc(in, n);
    SymModel2 model;
    int ctx = 0;
    int32_t w = 0;
    int64_t zrun = 0, zmult = 1;
    auto flush_run = [&]() -> bool {
        for (int64_t k = 0; k < zrun; k++) {
            if (w >= cap) return false;
            out[w++] = order[0];
        }
        zrun = 0;
        zmult = 1;
        return true;
    };
    for (;;) {
        int sym = model.decode(rc, ctx);
        if (sym == -1) break;  // EOB
        if (sym <= -2) {       // run digit
            zrun += (sym == -2 ? 1 : 2) * zmult;
            zmult <<= 1;
            if (zrun > cap) return -1;
            ctx = 0;
            continue;
        }
        if (!flush_run()) return -1;
        int j = sym;
        uint8_t c = order[j];
        std::memmove(order + 1, order, j);
        order[0] = c;
        if (w >= cap) return -1;
        out[w++] = c;
        ctx = SymModel2::clas(j);
    }
    if (!flush_run()) return -1;
    return w;
}

void put_u32(std::vector<uint8_t>& v, uint32_t x) {
    v.push_back((uint8_t)x);
    v.push_back((uint8_t)(x >> 8));
    v.push_back((uint8_t)(x >> 16));
    v.push_back((uint8_t)(x >> 24));
}

uint32_t get_u32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
           ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

}  // namespace

extern "C" {

// Raw BWT hooks for other translation units (the zpaq BWT method in
// zpaq.cpp reuses this file's SA-IS forward and LF-walk inverse).
int32_t lrz_bwt_forward(const uint8_t* in, uint8_t* out, int32_t n) {
    return bwt_forward(in, out, n);
}

void lrz_bwt_inverse(const uint8_t* bwt, uint8_t* out, int32_t n,
                     int32_t q) {
    bwt_inverse(bwt, out, n, q);
}

// Encode one block: [u32 primary_index][rc payload].  Returns bytes
// written or -1 if the output would exceed cap (incompressible).
int64_t bwt_block_encode(const uint8_t* in, int64_t n, uint8_t* out,
                         int64_t cap) {
    if (n <= 0 || n > 0x7FFFFF00) return -1;
    std::vector<uint8_t> bwt(n);
    int32_t q = bwt_forward(in, bwt.data(), (int32_t)n);
    std::vector<uint8_t> payload;
    payload.reserve(n / 2 + 64);
    put_u32(payload, (uint32_t)q);
    mtf_rle_encode(bwt.data(), (int32_t)n, payload);
    if ((int64_t)payload.size() > cap) return -1;
    std::memcpy(out, payload.data(), payload.size());
    return (int64_t)payload.size();
}

// Decode one block of known uncompressed length u_len.  Returns u_len
// or -1 on corruption.
int64_t bwt_block_decode(const uint8_t* in, int64_t n, uint8_t* out,
                         int64_t u_len) {
    if (n < 5 || u_len <= 0 || u_len > 0x7FFFFF00) return -1;
    int32_t q = (int32_t)get_u32(in);
    if (q < 0 || q > u_len) return -1;
    std::vector<uint8_t> bwt(u_len);
    int32_t got = mtf_rle_decode(in + 4, n - 4, bwt.data(),
                                 (int32_t)u_len);
    if (got != (int32_t)u_len) return -1;
    bwt_inverse(bwt.data(), out, (int32_t)u_len, q);
    return u_len;
}

// v2 block coding: same SA-IS/BWT front, structured symbol coder
// (SymModel2), plus LF-chain checkpoints for the interleaved inverse -
// the format written as B3T2 by backends/bzip3_codec.py.
// Payload: [u32 q][u8 chains][(chains-1) x u32 ckpt][coded symbols].
int64_t bwt_block_encode2(const uint8_t* in, int64_t n, uint8_t* out,
                          int64_t cap) {
    if (n <= 0 || n > 0x7FFFFF00) return -1;
    const int c = n >= (1 << 16) ? 8 : 1;
    std::vector<uint8_t> bwt(n);
    uint32_t ckpt[8] = {0};
    int32_t q = bwt_forward_ck(in, bwt.data(), (int32_t)n, c, ckpt);
    std::vector<uint8_t> payload;
    payload.reserve(n / 2 + 64);
    put_u32(payload, (uint32_t)q);
    payload.push_back((uint8_t)c);
    for (int t = 0; t < c - 1; t++) put_u32(payload, ckpt[t]);
    mtf_rle_encode2(bwt.data(), (int32_t)n, payload);
    if ((int64_t)payload.size() > cap) return -1;
    std::memcpy(out, payload.data(), payload.size());
    return (int64_t)payload.size();
}

int64_t bwt_block_decode2(const uint8_t* in, int64_t n, uint8_t* out,
                          int64_t u_len) {
    if (n < 6 || u_len <= 0 || u_len > 0x7FFFFF00) return -1;
    int32_t q = (int32_t)get_u32(in);
    if (q < 0 || q > u_len) return -1;
    int c = in[4];
    if (c < 1 || c > 8) return -1;
    int64_t hdr = 5 + 4 * (int64_t)(c - 1);
    if (n < hdr + 1) return -1;
    uint32_t ckpt[8] = {0};
    for (int t = 0; t < c - 1; t++) {
        ckpt[t] = get_u32(in + 5 + 4 * t);
        if (ckpt[t] > (uint32_t)u_len) return -1;
    }
    std::vector<uint8_t> bwt(u_len);
    int32_t got = mtf_rle_decode2(in + hdr, n - hdr, bwt.data(),
                                  (int32_t)u_len);
    if (got != (int32_t)u_len) return -1;
    bwt_inverse_mc(bwt.data(), out, (int32_t)u_len, q, c, ckpt);
    return u_len;
}

}  // extern "C"
