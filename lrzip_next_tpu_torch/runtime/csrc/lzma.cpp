// From-scratch LZMA1 codec (raw streams, no container).
//
// The reference vendors the LZMA SDK 24.07 (reference src/lzma/C/
// LzmaEnc.c, LzmaDec.c, LzFind.c) and calls it through LzmaCompress /
// LzmaUncompress with lc=3 lp=0 pb=2 (src/stream.c:450-458).  This is
// an independent implementation of the published LZMA bitstream:
//
//  - binary range coder, 11-bit adaptive probabilities, 5 move bits
//  - the 12-state literal/match/rep state machine with 4 rep distances
//  - bit-tree length coders (choice/low/mid/high) and the
//    posSlot/SpecPos/Align distance model
//  - matched-literal coding after matches
//
// Encode has two strategies, matching the SDK's fast/normal split
// (LzmaEncProps_Normalize picks algo=0 below level 5):
//  - levels 1-4: hash-chain match finder (HC4 class, cf. LzFind.c:880)
//    with one-step lazy evaluation (the GetOptimumFast strategy of
//    LzmaEnc.c:1970);
//  - levels 5-9: binary-tree match finder (BT4 class, cf.
//    LzFind.c:962-1400: hash2/hash3 short-match heads + a suffix-
//    ordered binary tree on a 4-byte hash) feeding a price-table
//    optimal parse (the GetOptimum dynamic program of
//    LzmaEnc.c:1219-1968, re-derived: each DP node carries its exact
//    state and rep set instead of the SDK's incremental
//    reconstruction, segments cut at long matches).
// Both always terminate with the end-of-payload marker (distance
// 0xFFFFFFFF), which LzmaUncompress accepts when the output size is
// known.  Decode stops at the requested output length and also
// accepts marker-less SDK streams.  Both directions are cross-validated
// against liblzma and the reference SDK oracle in
// tests/test_reference_interop.py / tests/test_lzma_native.py.

#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace tlz {

static bool trace_on() {
    static const bool t = std::getenv("LRZ_LZMA_TRACE") != nullptr;
    return t;
}

typedef uint8_t U8;
typedef uint16_t U16;
typedef uint32_t U32;
typedef uint64_t U64;

constexpr int kNumBitModelTotalBits = 11;
constexpr U32 kBitModelTotal = 1u << kNumBitModelTotalBits;
constexpr int kNumMoveBits = 5;
constexpr U32 kTopValue = 1u << 24;
constexpr U16 kProbInit = (U16)(kBitModelTotal / 2);

constexpr int kNumStates = 12;
constexpr int kNumPosStatesMax = 16;
constexpr int kNumLenToPosStates = 4;
constexpr int kNumPosSlotBits = 6;
constexpr int kNumAlignBits = 4;
constexpr int kEndPosModelIndex = 14;
constexpr int kNumFullDistances = 1 << (kEndPosModelIndex >> 1);  // 128
constexpr int kMatchMinLen = 2;
// length coder symbol ranges
constexpr int kLenLowSymbols = 8;
constexpr int kLenMidSymbols = 8;
constexpr int kLenHighSymbols = 256;
constexpr int kMatchMaxLen = kMatchMinLen + kLenLowSymbols
    + kLenMidSymbols + kLenHighSymbols - 1;  // 273

// ----------------------------------------------------------- models ---

struct LenProbs {
    U16 choice, choice2;
    U16 low[kNumPosStatesMax][kLenLowSymbols];
    U16 mid[kNumPosStatesMax][kLenMidSymbols];
    U16 high[kLenHighSymbols];
};

struct Probs {
    U16 is_match[kNumStates][kNumPosStatesMax];
    U16 is_rep[kNumStates];
    U16 is_rep_g0[kNumStates];
    U16 is_rep_g1[kNumStates];
    U16 is_rep_g2[kNumStates];
    U16 is_rep0_long[kNumStates][kNumPosStatesMax];
    U16 pos_slot[kNumLenToPosStates][1 << kNumPosSlotBits];
    U16 spec_pos[kNumFullDistances - kEndPosModelIndex];
    U16 align[1 << kNumAlignBits];
    LenProbs len, rep_len;
    std::vector<U16> literal;  // 0x300 << (lc + lp)

    void init(int lc, int lp) {
        U16* base = &is_match[0][0];
        size_t fixed = (size_t)((U16*)(&rep_len + 1) - base);
        for (size_t i = 0; i < fixed; i++) base[i] = kProbInit;
        literal.assign((size_t)0x300 << (lc + lp), kProbInit);
    }
};

static inline int state_upd_lit(int s) {
    return s < 4 ? 0 : (s < 10 ? s - 3 : s - 6);
}
static inline int state_upd_match(int s) { return s < 7 ? 7 : 10; }
static inline int state_upd_rep(int s) { return s < 7 ? 8 : 11; }
static inline int state_upd_shortrep(int s) { return s < 7 ? 9 : 11; }

// ------------------------------------------------------ range coder ---

struct RangeDec {
    const U8* buf;
    int64_t pos, size;
    U32 range, code;
    bool overrun = false;

    int next() {
        if (pos < size) return buf[pos++];
        overrun = true;
        return 0;
    }
    void init() {
        range = 0xFFFFFFFFu;
        code = 0;
        next();  // first byte is always 0
        for (int i = 0; i < 4; i++) code = (code << 8) | next();
    }
    inline void normalize() {
        if (range < kTopValue) {
            range <<= 8;
            code = (code << 8) | next();
        }
    }
    inline int decode_bit(U16& p) {
        U32 bound = (range >> kNumBitModelTotalBits) * p;
        int bit;
        if (code < bound) {
            range = bound;
            p += (U16)((kBitModelTotal - p) >> kNumMoveBits);
            bit = 0;
        } else {
            range -= bound;
            code -= bound;
            p -= (U16)(p >> kNumMoveBits);
            bit = 1;
        }
        normalize();
        return bit;
    }
    U32 decode_direct(int n) {
        U32 res = 0;
        do {
            range >>= 1;
            code -= range;
            U32 t = 0 - (code >> 31);
            code += range & t;
            normalize();
            res = (res << 1) + (t + 1);
        } while (--n);
        return res;
    }
    int tree_decode(U16* probs, int nbits) {
        int m = 1;
        for (int i = 0; i < nbits; i++) m = (m << 1) | decode_bit(probs[m]);
        return m - (1 << nbits);
    }
    int tree_reverse_decode(U16* probs, int nbits) {
        int m = 1, sym = 0;
        for (int i = 0; i < nbits; i++) {
            int b = decode_bit(probs[m]);
            m = (m << 1) | b;
            sym |= b << i;
        }
        return sym;
    }
    int len_decode(LenProbs& lp, int pos_state) {
        if (!decode_bit(lp.choice))
            return tree_decode(lp.low[pos_state], 3);
        if (!decode_bit(lp.choice2))
            return kLenLowSymbols + tree_decode(lp.mid[pos_state], 3);
        return kLenLowSymbols + kLenMidSymbols + tree_decode(lp.high, 8);
    }
};

struct RangeEnc {
    std::vector<U8>& out;
    U64 low = 0;
    U32 range = 0xFFFFFFFFu;
    U8 cache = 0;
    int64_t cache_size = 1;
    explicit RangeEnc(std::vector<U8>& o) : out(o) {}

    void shift_low() {
        if ((U32)low < 0xFF000000u || (int)(low >> 32) != 0) {
            U8 temp = cache;
            do {
                out.push_back((U8)(temp + (U8)(low >> 32)));
                temp = 0xFF;
            } while (--cache_size);
            cache = (U8)(low >> 24);
        }
        cache_size++;
        low = (low << 8) & 0xFFFFFFFFu;
    }
    inline void encode_bit(U16& p, int bit) {
        U32 bound = (range >> kNumBitModelTotalBits) * p;
        if (!bit) {
            range = bound;
            p += (U16)((kBitModelTotal - p) >> kNumMoveBits);
        } else {
            low += bound;
            range -= bound;
            p -= (U16)(p >> kNumMoveBits);
        }
        while (range < kTopValue) {
            range <<= 8;
            shift_low();
        }
    }
    void encode_direct(U32 v, int n) {
        for (int i = n - 1; i >= 0; i--) {
            range >>= 1;
            if ((v >> i) & 1) low += range;
            while (range < kTopValue) {
                range <<= 8;
                shift_low();
            }
        }
    }
    void tree_encode(U16* probs, int nbits, int sym) {
        int m = 1;
        for (int i = nbits - 1; i >= 0; i--) {
            int b = (sym >> i) & 1;
            encode_bit(probs[m], b);
            m = (m << 1) | b;
        }
    }
    void tree_reverse_encode(U16* probs, int nbits, int sym) {
        int m = 1;
        for (int i = 0; i < nbits; i++) {
            int b = (sym >> i) & 1;
            encode_bit(probs[m], b);
            m = (m << 1) | b;
        }
    }
    void len_encode(LenProbs& lp, int pos_state, int len) {
        // len is the coded symbol (actual - kMatchMinLen)
        if (len < kLenLowSymbols) {
            encode_bit(lp.choice, 0);
            tree_encode(lp.low[pos_state], 3, len);
        } else if (len < kLenLowSymbols + kLenMidSymbols) {
            encode_bit(lp.choice, 1);
            encode_bit(lp.choice2, 0);
            tree_encode(lp.mid[pos_state], 3, len - kLenLowSymbols);
        } else {
            encode_bit(lp.choice, 1);
            encode_bit(lp.choice2, 1);
            tree_encode(lp.high, 8,
                        len - kLenLowSymbols - kLenMidSymbols);
        }
    }
    void flush() {
        for (int i = 0; i < 5; i++) shift_low();
    }
};

// ---------------------------------------------------------- decoder ---

// Returns bytes produced (== u_len) or -1 on corrupt stream.
int64_t decode(const U8* in, int64_t in_len, U8* out, int64_t u_len,
               int lc, int lp, int pb) {
    if (lc < 0 || lc > 8 || lp < 0 || lp > 4 || pb < 0 || pb > 4)
        return -1;
    if (u_len == 0) return 0;
    if (in_len < 5) return -1;
    Probs P;
    P.init(lc, lp);
    RangeDec rc{in, 0, in_len, 0, 0};
    rc.init();

    const U32 pb_mask = (1u << pb) - 1;
    const U32 lp_mask = (1u << lp) - 1;
    int state = 0;
    U32 rep0 = 0, rep1 = 0, rep2 = 0, rep3 = 0;
    int64_t pos = 0;

    while (pos < u_len) {
        int pos_state = (int)((U32)pos & pb_mask);
        if (!rc.decode_bit(P.is_match[state][pos_state])) {
            // literal
            U8 prev = pos ? out[pos - 1] : 0;
            U16* probs = &P.literal[
                (size_t)0x300 * ((((U32)pos & lp_mask) << lc)
                                 + (prev >> (8 - lc)))];
            int sym = 1;
            if (state >= 7) {
                if ((U64)rep0 + 1 > (U64)pos) return -1;
                U8 match_byte = out[pos - rep0 - 1];
                do {
                    int match_bit = (match_byte >> 7) & 1;
                    match_byte <<= 1;
                    int bit = rc.decode_bit(
                        probs[((1 + match_bit) << 8) + sym]);
                    sym = (sym << 1) | bit;
                    if (match_bit != bit) break;
                } while (sym < 0x100);
            }
            while (sym < 0x100)
                sym = (sym << 1) | rc.decode_bit(probs[sym]);
            out[pos++] = (U8)(sym - 0x100);
            state = state_upd_lit(state);
            continue;
        }
        int len;
        if (rc.decode_bit(P.is_rep[state])) {
            // rep match
            if (pos == 0) return -1;
            if (!rc.decode_bit(P.is_rep_g0[state])) {
                if (!rc.decode_bit(P.is_rep0_long[state][pos_state])) {
                    // short rep: one byte from rep0
                    if ((U64)rep0 + 1 > (U64)pos) return -1;
                    out[pos] = out[pos - rep0 - 1];
                    pos++;
                    state = state_upd_shortrep(state);
                    continue;
                }
            } else {
                U32 dist;
                if (!rc.decode_bit(P.is_rep_g1[state])) {
                    dist = rep1;
                } else if (!rc.decode_bit(P.is_rep_g2[state])) {
                    dist = rep2;
                    rep2 = rep1;
                } else {
                    dist = rep3;
                    rep3 = rep2;
                    rep2 = rep1;
                }
                rep1 = rep0;
                rep0 = dist;
            }
            len = rc.len_decode(P.rep_len, pos_state) + kMatchMinLen;
            state = state_upd_rep(state);
        } else {
            // normal match
            rep3 = rep2;
            rep2 = rep1;
            rep1 = rep0;
            len = rc.len_decode(P.len, pos_state) + kMatchMinLen;
            int lps = len - kMatchMinLen < kNumLenToPosStates
                ? len - kMatchMinLen : kNumLenToPosStates - 1;
            int slot = rc.tree_decode(P.pos_slot[lps], kNumPosSlotBits);
            U32 dist;
            if (slot < 4) {
                dist = (U32)slot;
            } else {
                int ndirect = (slot >> 1) - 1;
                dist = (U32)(2 | (slot & 1)) << ndirect;
                if (slot < kEndPosModelIndex) {
                    dist += (U32)rc.tree_reverse_decode(
                        P.spec_pos + dist - slot - 1, ndirect);
                } else {
                    dist += rc.decode_direct(ndirect - kNumAlignBits)
                            << kNumAlignBits;
                    dist += (U32)rc.tree_reverse_decode(P.align,
                                                        kNumAlignBits);
                }
            }
            if (dist == 0xFFFFFFFFu) {
                // end-of-payload marker before u_len bytes: corrupt
                return -1;
            }
            rep0 = dist;
            state = state_upd_match(state);
        }
        if (trace_on())
            std::fprintf(stderr, "D pos=%lld len=%d dist=%u state=%d\n",
                         (long long)pos, len, rep0, state);
        if ((U64)rep0 + 1 > (U64)pos) return -1;
        if (pos + len > u_len) return -1;
        const U8* src = out + pos - rep0 - 1;
        for (int i = 0; i < len; i++) out[pos + i] = src[i];
        pos += len;
    }
    if (rc.overrun) return -1;
    return pos;
}

// ---------------------------------------------------------- encoder ---

// HC4 hash-chain match finder over the whole input buffer.
struct MatchFinder {
    const U8* in;
    int64_t n;
    U32 dict;
    int depth;
    std::vector<int32_t> head;
    std::vector<int32_t> prev;
    static constexpr int HB = 17;

    MatchFinder(const U8* d, int64_t len, U32 dict_size, int dep)
        : in(d), n(len), dict(dict_size), depth(dep),
          head((size_t)1 << HB, -1), prev((size_t)len, -1) {}

    static inline U32 hash4(const U8* p) {
        U32 x;
        std::memcpy(&x, p, 4);
        return (x * 2654435761u) >> (32 - HB);
    }

    inline void insert(int64_t i) {
        if (i + 4 > n) return;
        U32 h = hash4(in + i);
        prev[(size_t)i] = head[h];
        head[h] = (int32_t)i;
    }

    // longest match at i (also inserts i).  Returns len (0 if < 2) and
    // the distance-1 via *dist.
    int find(int64_t i, U32* dist) {
        int best = 0;
        if (i + 4 > n) { if (i < n) insert(i); return 0; }
        U32 h = hash4(in + i);
        int32_t j = head[h];
        prev[(size_t)i] = j;
        head[h] = (int32_t)i;
        const int64_t max_len_avail =
            (n - i) < kMatchMaxLen ? (n - i) : kMatchMaxLen;
        const U8* q = in + i;
        for (int d = depth; j >= 0 && d > 0; --d) {
            int64_t back = i - j;
            if (back > dict) break;
            const U8* p = in + j;
            if (p[best] == q[best]) {
                int l = 0;
                while (l + 8 <= max_len_avail) {
                    U64 x, y;
                    std::memcpy(&x, p + l, 8);
                    std::memcpy(&y, q + l, 8);
                    if (x != y) {
                        l += __builtin_ctzll(x ^ y) >> 3;
                        goto done;
                    }
                    l += 8;
                }
                while (l < max_len_avail && p[l] == q[l]) l++;
            done:
                if (l > best) {
                    best = l;
                    *dist = (U32)(back - 1);
                    if (l >= max_len_avail) break;
                }
            }
            j = prev[(size_t)j];
        }
        return best;
    }
};

static inline int match_len_at(const U8* in, int64_t n, int64_t i,
                               U32 rep /* dist-1 */) {
    int64_t back = (int64_t)rep + 1;
    if (back > i) return 0;
    const U8* p = in + i - back;
    const U8* q = in + i;
    int64_t maxl = (n - i) < kMatchMaxLen ? (n - i) : kMatchMaxLen;
    int l = 0;
    while (l + 8 <= maxl) {
        U64 x, y;
        std::memcpy(&x, p + l, 8);
        std::memcpy(&y, q + l, 8);
        if (x != y) return l + (__builtin_ctzll(x ^ y) >> 3);
        l += 8;
    }
    while (l < maxl && p[l] == q[l]) l++;
    return l;
}

static void encode_literal(RangeEnc& rc, Probs& P, const U8* in,
                           int64_t pos, int state, U32 rep0, int lc,
                           U32 lp_mask) {
    U8 prev = pos ? in[pos - 1] : 0;
    U16* probs = &P.literal[
        (size_t)0x300 * ((((U32)pos & lp_mask) << lc)
                         + (prev >> (8 - lc)))];
    int sym = 0x100 | in[pos];
    if (state >= 7) {
        U8 match_byte = in[pos - rep0 - 1];
        int m = 1;
        int i = 7;
        for (; i >= 0; i--) {
            int match_bit = (match_byte >> i) & 1;
            int bit = (sym >> i) & 1;
            rc.encode_bit(probs[((1 + match_bit) << 8) + m], bit);
            m = (m << 1) | bit;
            if (match_bit != bit) { i--; break; }
        }
        for (; i >= 0; i--) {
            int bit = (sym >> i) & 1;
            rc.encode_bit(probs[m], bit);
            m = (m << 1) | bit;
        }
    } else {
        int m = 1;
        for (int i = 7; i >= 0; i--) {
            int bit = (sym >> i) & 1;
            rc.encode_bit(probs[m], bit);
            m = (m << 1) | bit;
        }
    }
}

static void encode_distance(RangeEnc& rc, Probs& P, int len, U32 dist) {
    int lps = len - kMatchMinLen < kNumLenToPosStates
        ? len - kMatchMinLen : kNumLenToPosStates - 1;
    int slot;
    if (dist < 4) {
        slot = (int)dist;
    } else {
        int zz = 31 - __builtin_clz(dist);
        slot = (zz << 1) | (int)((dist >> (zz - 1)) & 1);
    }
    rc.tree_encode(P.pos_slot[lps], kNumPosSlotBits, slot);
    if (slot >= 4) {
        int ndirect = (slot >> 1) - 1;
        U32 base = (U32)(2 | (slot & 1)) << ndirect;
        U32 rest = dist - base;
        if (slot < kEndPosModelIndex) {
            rc.tree_reverse_encode(P.spec_pos + base - slot - 1,
                                   ndirect, (int)rest);
        } else {
            rc.encode_direct(rest >> kNumAlignBits,
                             ndirect - kNumAlignBits);
            rc.tree_reverse_encode(P.align, kNumAlignBits,
                                   (int)(rest & ((1 << kNumAlignBits)
                                                 - 1)));
        }
    }
}

// ------------------------------------------------- price machinery ---
// Bit prices in 1/16-bit units (so a raw direct bit costs 16).  The
// table quantizes the 11-bit probability space to 128 slots; values
// are true -log2 costs computed at startup (the SDK derives an
// equivalent table by bit tricks in LzmaEnc_InitPriceTables,
// LzmaEnc.c:830).

constexpr int kPriceShift = 4;       // price unit = 2^-4 bits
constexpr U32 kInfPrice = 1u << 30;

struct ProbPriceTable {
    U32 t[kBitModelTotal >> kPriceShift];
    ProbPriceTable() {
        for (int i = 0; i < (int)(kBitModelTotal >> kPriceShift); i++) {
            double prob = ((double)(i << kPriceShift) + (1 << (kPriceShift - 1)))
                          / (double)kBitModelTotal;
            double bits = -std::log2(prob);
            t[i] = (U32)(bits * (1 << kPriceShift) + 0.5);
        }
    }
};
static const ProbPriceTable g_pp;

static inline U32 price0(U16 p) { return g_pp.t[p >> kPriceShift]; }
static inline U32 price1(U16 p) {
    return g_pp.t[(kBitModelTotal - p) >> kPriceShift];
}
static inline U32 price_bit(U16 p, int bit) {
    return bit ? price1(p) : price0(p);
}

static U32 tree_price(const U16* probs, int nbits, int sym) {
    U32 price = 0;
    int m = 1;
    for (int i = nbits - 1; i >= 0; i--) {
        int b = (sym >> i) & 1;
        price += price_bit(probs[m], b);
        m = (m << 1) | b;
    }
    return price;
}

static U32 tree_reverse_price(const U16* probs, int nbits, int sym) {
    U32 price = 0;
    int m = 1;
    for (int i = 0; i < nbits; i++) {
        int b = (sym >> i) & 1;
        price += price_bit(probs[m], b);
        m = (m << 1) | b;
    }
    return price;
}

// Length-coder prices per posState and coded symbol (len - 2), filled
// from the current adaptive probabilities at each parse segment (the
// SDK refreshes the same tables on a counter, LzmaEnc.c:966-1011).
struct LenPrices {
    U32 p[kNumPosStatesMax][kMatchMaxLen - kMatchMinLen + 1];
    void fill(const LenProbs& lp, int num_pos_states) {
        for (int ps = 0; ps < num_pos_states; ps++) {
            U32 c0 = price0(lp.choice);
            U32 c10 = price1(lp.choice) + price0(lp.choice2);
            U32 c11 = price1(lp.choice) + price1(lp.choice2);
            for (int s = 0; s < kLenLowSymbols; s++)
                p[ps][s] = c0 + tree_price(lp.low[ps], 3, s);
            for (int s = 0; s < kLenMidSymbols; s++)
                p[ps][kLenLowSymbols + s] =
                    c10 + tree_price(lp.mid[ps], 3, s);
            for (int s = 0; s < kLenHighSymbols; s++)
                p[ps][kLenLowSymbols + kLenMidSymbols + s] =
                    c11 + tree_price(lp.high, 8, s);
        }
    }
};

static inline int len_to_pos_state(int len) {
    int v = len - kMatchMinLen;
    return v < kNumLenToPosStates ? v : kNumLenToPosStates - 1;
}

static inline int dist_slot(U32 dist) {
    if (dist < 4) return (int)dist;
    int zz = 31 - __builtin_clz(dist);
    return (zz << 1) | (int)((dist >> (zz - 1)) & 1);
}

// Distance prices: slot tree prices (with the direct-bit cost folded
// in above kEndPosModelIndex), exact prices for the 128 modelled
// distances, and the 16 align prices (cf. FillDistancesPrices,
// LzmaEnc.c:2226).
struct DistPrices {
    U32 slot[kNumLenToPosStates][1 << kNumPosSlotBits];
    U32 full[kNumLenToPosStates][kNumFullDistances];
    U32 align_[1 << kNumAlignBits];
    void fill(const Probs& P) {
        for (int lps = 0; lps < kNumLenToPosStates; lps++) {
            for (int s = 0; s < (1 << kNumPosSlotBits); s++) {
                U32 pr = tree_price(P.pos_slot[lps], kNumPosSlotBits, s);
                if (s >= kEndPosModelIndex)
                    pr += (U32)(((s >> 1) - 1 - kNumAlignBits))
                          << kPriceShift;
                slot[lps][s] = pr;
            }
            for (U32 d = 0; d < kNumFullDistances; d++) {
                int s = dist_slot(d);
                U32 pr = slot[lps][s];
                if (s >= 4) {
                    int ndirect = (s >> 1) - 1;
                    U32 base = (U32)(2 | (s & 1)) << ndirect;
                    pr += tree_reverse_price(P.spec_pos + base - s - 1,
                                             ndirect, (int)(d - base));
                }
                full[lps][d] = pr;
            }
        }
        for (int a = 0; a < (1 << kNumAlignBits); a++)
            align_[a] = tree_reverse_price(P.align, kNumAlignBits, a);
    }
    inline U32 get(int lps, U32 dist) const {
        if (dist < kNumFullDistances) return full[lps][dist];
        return slot[lps][dist_slot(dist)]
               + align_[dist & ((1 << kNumAlignBits) - 1)];
    }
};

static U32 literal_price(const Probs& P, const U8* in, int64_t p,
                         int state, U32 rep0, int lc, U32 lp_mask) {
    U8 prev = p ? in[p - 1] : 0;
    const U16* probs = &P.literal[
        (size_t)0x300 * ((((U32)p & lp_mask) << lc)
                         + (prev >> (8 - lc)))];
    U32 price = 0;
    int sym = 0x100 | in[p];
    int m = 1;
    if (state >= 7) {
        U8 match_byte = in[p - rep0 - 1];
        int i = 7;
        for (; i >= 0; i--) {
            int match_bit = (match_byte >> i) & 1;
            int bit = (sym >> i) & 1;
            price += price_bit(probs[((1 + match_bit) << 8) + m], bit);
            m = (m << 1) | bit;
            if (match_bit != bit) { i--; break; }
        }
        for (; i >= 0; i--) {
            int bit = (sym >> i) & 1;
            price += price_bit(probs[m], bit);
            m = (m << 1) | bit;
        }
    } else {
        for (int i = 7; i >= 0; i--) {
            int bit = (sym >> i) & 1;
            price += price_bit(probs[m], bit);
            m = (m << 1) | bit;
        }
    }
    return price;
}

// ----------------------------------------------- BT4 match finder ---
// Suffix-ordered binary tree per 4-byte-hash bucket, plus direct
// hash2/hash3 heads for close short matches (the BT4 configuration of
// LzFind.c:1219, re-derived).  son[2i] / son[2i+1] are the left
// ("lexicographically smaller suffix") and right children of position
// i in its bucket's tree.
struct BtMatchFinder {
    const U8* in;
    int64_t n;
    U32 dict;
    int cycles;
    int hb;
    int nhb;  // tree hash width: 2..5 (the SDK's bt2/bt3/bt4/bt5
              // numHashBytes family, LzFind.c:962-1400); heads below
              // the tree width serve close short matches
    std::vector<int32_t> h2, h3, h4h, h4, son;
    static constexpr int H2B = 16, H3B = 16, H4B = 17;
    static constexpr int kMaxPairs = 80;

    BtMatchFinder(const U8* d, int64_t len, U32 dict_size, int cyc,
                  int nhb_ = 4)
        : in(d), n(len), dict(dict_size ? dict_size : 0xFFFFFFFFu),
          cycles(cyc), nhb(nhb_ < 2 ? 2 : (nhb_ > 5 ? 5 : nhb_)) {
        hb = 16;
        while (((int64_t)1 << hb) < len && hb < 22) hb++;
        if (nhb == 2) hb = 16;  // direct 2-byte value
        if (nhb >= 3) h2.assign((size_t)1 << H2B, -1);
        if (nhb >= 4) h3.assign((size_t)1 << H3B, -1);
        if (nhb >= 5) h4h.assign((size_t)1 << H4B, -1);
        h4.assign((size_t)1 << hb, -1);
        son.assign((size_t)2 * (size_t)len, -1);
    }

    static inline U32 hv2(const U8* p) {
        return (U32)p[0] | ((U32)p[1] << 8);
    }
    static inline U32 hv3(const U8* p) {
        U32 x = (U32)p[0] | ((U32)p[1] << 8) | ((U32)p[2] << 16);
        return (x * 2654435761u) >> (32 - H3B);
    }
    static inline U32 hv4h(const U8* p) {
        U32 x;
        std::memcpy(&x, p, 4);
        return (x * 2654435761u) >> (32 - H4B);
    }
    inline U32 hvtree(const U8* p) const {
        switch (nhb) {
            case 2:
                return hv2(p);
            case 3: {
                U32 x = (U32)p[0] | ((U32)p[1] << 8) | ((U32)p[2] << 16);
                return (x * 2654435761u) >> (32 - hb);
            }
            case 5: {
                U32 x;
                std::memcpy(&x, p, 4);
                U64 y = (U64)x | ((U64)p[4] << 32);
                return (U32)((y * 0x9E3779B185EBCA87ull) >> (64 - hb));
            }
            default: {
                U32 x;
                std::memcpy(&x, p, 4);
                return (x * 2654435761u) >> (32 - hb);
            }
        }
    }

    // Descend position i's tree bucket: re-links the tree so i becomes
    // the bucket root, optionally collecting (len, dist-1) pairs of
    // strictly increasing length.  The two-rail descent keeps the
    // subtree ordered by suffix comparison.
    template <bool COLLECT>
    int walk(int64_t i, U32* lens, U32* dists, int np, int best) {
        U32 h = hvtree(in + i);
        int32_t cur = h4[h];
        h4[h] = (int32_t)i;
        int32_t* ptr0 = &son[2 * (size_t)i + 1];
        int32_t* ptr1 = &son[2 * (size_t)i];
        int len0 = 0, len1 = 0;
        int64_t maxl = n - i < kMatchMaxLen ? n - i : kMatchMaxLen;
        for (int d = cycles;; --d) {
            if (cur < 0 || d <= 0 || (U64)(i - cur) > dict) {
                *ptr0 = -1;
                *ptr1 = -1;
                break;
            }
            const U8* pb = in + cur;
            const U8* qb = in + i;
            int len = len0 < len1 ? len0 : len1;
            if (pb[len] == qb[len]) {
                len++;
                while (len < maxl && pb[len] == qb[len]) len++;
                if (COLLECT && len > best && len >= 2) {
                    best = len;
                    lens[np] = (U32)len;
                    dists[np] = (U32)(i - cur - 1);
                    if (np + 1 < kMaxPairs) np++;
                }
                if (len == maxl) {
                    // full-length node: splice it out, i replaces it
                    *ptr1 = son[2 * (size_t)cur];
                    *ptr0 = son[2 * (size_t)cur + 1];
                    break;
                }
            }
            if (pb[len] < qb[len]) {
                *ptr1 = cur;
                ptr1 = &son[2 * (size_t)cur + 1];
                cur = *ptr1;
                len1 = len;
            } else {
                *ptr0 = cur;
                ptr0 = &son[2 * (size_t)cur];
                cur = *ptr0;
                len0 = len;
            }
        }
        return np;
    }

    // All useful matches at i (inserts i into every structure).
    // Returns pairs canonicalized to strictly increasing (len, dist).
    int get_matches(int64_t i, U32* lens, U32* dists) {
        U32 rl[kMaxPairs], rd[kMaxPairs];
        int np = 0;
        int64_t maxl = n - i < kMatchMaxLen ? n - i : kMatchMaxLen;
        if (nhb >= 3 && maxl >= 2) {
            U32 hh = hv2(in + i);
            int32_t c = h2[hh];
            h2[hh] = (int32_t)i;
            if (c >= 0 && (U64)(i - c) <= dict) {
                int l = 0;
                while (l < maxl && in[c + l] == in[i + l]) l++;
                if (l >= 2) {
                    rl[np] = (U32)l;
                    rd[np] = (U32)(i - c - 1);
                    np++;
                }
            }
        }
        if (nhb >= 4 && n - i >= 3) {
            U32 hh = hv3(in + i);
            int32_t c = h3[hh];
            h3[hh] = (int32_t)i;
            if (c >= 0 && (U64)(i - c) <= dict && in[c] == in[i]
                && in[c + 1] == in[i + 1] && in[c + 2] == in[i + 2]) {
                int l = 3;
                while (l < maxl && in[c + l] == in[i + l]) l++;
                rl[np] = (U32)l;
                rd[np] = (U32)(i - c - 1);
                np++;
            }
        }
        if (nhb >= 5 && n - i >= 4) {
            U32 hh = hv4h(in + i);
            int32_t c = h4h[hh];
            h4h[hh] = (int32_t)i;
            if (c >= 0 && (U64)(i - c) <= dict
                && std::memcmp(in + c, in + i, 4) == 0) {
                int l = 4;
                while (l < maxl && in[c + l] == in[i + l]) l++;
                rl[np] = (U32)l;
                rd[np] = (U32)(i - c - 1);
                np++;
            }
        }
        if (n - i >= nhb) {
            // the h2/h3 heads are the *closest* 2-/3-byte matches, so
            // any BT candidate of <= their length has a larger
            // distance and is dominated: start recording above them
            int best = 1;
            for (int a = 0; a < np; a++)
                if ((int)rl[a] > best) best = (int)rl[a];
            np = walk<true>(i, rl, rd, np, best);
        }
        if (!np) return 0;
        // canonicalize: sort by len, then keep the suffix-minimum
        // distance so both len and dist are strictly increasing (each
        // pair is the cheapest source for lengths up to its len)
        for (int a = 1; a < np; a++) {  // insertion sort, np is tiny
            U32 kl = rl[a], kd = rd[a];
            int b = a - 1;
            for (; b >= 0 && (rl[b] > kl || (rl[b] == kl && rd[b] > kd));
                 b--) {
                rl[b + 1] = rl[b];
                rd[b + 1] = rd[b];
            }
            rl[b + 1] = kl;
            rd[b + 1] = kd;
        }
        int out = 0;
        U32 mind = 0xFFFFFFFFu;
        int keep[kMaxPairs];
        int nkeep = 0;
        for (int a = np - 1; a >= 0; a--) {
            if (rd[a] < mind) {
                mind = rd[a];
                keep[nkeep++] = a;
            }
        }
        for (int a = nkeep - 1; a >= 0; a--) {
            lens[out] = rl[keep[a]];
            dists[out] = rd[keep[a]];
            out++;
        }
        return out;
    }

    // Insert-only (skipped positions inside an accepted match).
    void skip(int64_t i) {
        if (nhb >= 3 && n - i >= 2) h2[hv2(in + i)] = (int32_t)i;
        if (nhb >= 4 && n - i >= 3) h3[hv3(in + i)] = (int32_t)i;
        if (nhb >= 5 && n - i >= 4) h4h[hv4h(in + i)] = (int32_t)i;
        if (n - i >= nhb) walk<false>(i, nullptr, nullptr, 0, 0);
    }
};

// ------------------------------------------------ match sources -----
// The optimal parser consumes matches through one of two sources: the
// synchronous source (single-thread: finder interleaved with the
// parse, parse-driven interior sampling) or the pipelined source - the
// analog of the SDK's 2-thread match-finder pipeline (LzFindMt.c:
// 440-786, hash thread -> btree thread -> encoder over ring-buffered
// blocks; enabled via numThreads=2 at reference src/stream.c:456,
// disabled by --nobemt).  Here one worker thread runs the whole BT4
// walk ahead of the parser, applying the same deterministic nice-cut +
// interior-sampling policy the sync path uses, so output depends only
// on the data (never on scheduling).

static void sample_skip(BtMatchFinder& mf, int64_t q0, int64_t q1) {
    // interior sampling of positions covered by an accepted long
    // match: head and tail fully indexed, interior every 8th (see the
    // rationale at the parser's skip block)
    if (q1 - q0 <= 80) {
        for (int64_t q = q0; q < q1; q++) mf.skip(q);
    } else {
        for (int64_t q = q0; q < q0 + 32; q++) mf.skip(q);
        for (int64_t q = q0 + 32; q < q1 - 32; q += 8) mf.skip(q);
        for (int64_t q = q1 - 32; q < q1; q++) mf.skip(q);
    }
}

struct SyncSource {
    BtMatchFinder mf;
    SyncSource(const U8* in, int64_t n, U32 dict, int cycles, int,
               int nhb = 4)
        : mf(in, n, dict, cycles, nhb) {}
    int get(int64_t p, U32* lens, U32* dists) {
        return mf.get_matches(p, lens, dists);
    }
    void note_gap(int64_t q0, int64_t q1) { sample_skip(mf, q0, q1); }
};

struct AheadSource {
    struct Block {
        std::vector<int64_t> pos;
        std::vector<uint8_t> np;
        std::vector<U32> pairs;  // (len, dist) interleaved
        bool eof = false;
    };
    static constexpr size_t kFlushEntries = 1 << 15;
    static constexpr size_t kFlushPairs = 1 << 17;
    static constexpr size_t kRing = 3;

    BtMatchFinder mf;
    const int64_t n;
    const int nice;
    std::mutex mu;
    std::condition_variable cv_push, cv_pop;
    std::deque<std::unique_ptr<Block>> q;
    bool stop = false;
    std::thread worker;

    std::unique_ptr<Block> cur;
    size_t ci = 0, poff = 0;

    AheadSource(const U8* in, int64_t n_, U32 dict, int cycles,
                int nice_, int nhb = 4)
        : mf(in, n_, dict, cycles, nhb), n(n_), nice(nice_) {
        worker = std::thread([this] { run(); });
    }
    ~AheadSource() {
        {
            std::lock_guard<std::mutex> g(mu);
            stop = true;
        }
        cv_push.notify_all();
        if (worker.joinable()) worker.join();
    }

    void run() {
        U32 lens[BtMatchFinder::kMaxPairs];
        U32 dists[BtMatchFinder::kMaxPairs];
        auto blk = std::make_unique<Block>();
        auto flush = [&](bool eof) {
            blk->eof = eof;
            std::unique_lock<std::mutex> lk(mu);
            cv_push.wait(lk, [&] { return q.size() < kRing || stop; });
            if (stop) return false;
            q.push_back(std::move(blk));
            cv_pop.notify_one();
            blk = std::make_unique<Block>();
            return true;
        };
        int64_t pos = 0;
        while (pos < n) {
            int np = mf.get_matches(pos, lens, dists);
            blk->pos.push_back(pos);
            blk->np.push_back((uint8_t)np);
            for (int a = 0; a < np; a++) {
                blk->pairs.push_back(lens[a]);
                blk->pairs.push_back(dists[a]);
            }
            if (np && (int)lens[np - 1] >= nice) {
                // mirror the parser: a nice-len match is taken
                // outright, its interior sample-skipped
                int64_t L = (int64_t)lens[np - 1];
                if (pos + L > n) L = n - pos;
                sample_skip(mf, pos + 1, pos + L);
                pos += L;
            } else {
                pos += 1;
            }
            if (blk->pos.size() >= kFlushEntries
                || blk->pairs.size() >= kFlushPairs) {
                if (!flush(false)) return;
            }
        }
        flush(true);
    }

    int get(int64_t p, U32* lens, U32* dists) {
        for (;;) {
            if (!cur || ci >= cur->pos.size()) {
                if (cur && cur->eof) return 0;
                std::unique_lock<std::mutex> lk(mu);
                cv_pop.wait(lk, [&] { return !q.empty(); });
                cur = std::move(q.front());
                q.pop_front();
                cv_push.notify_one();
                ci = 0;
                poff = 0;
                continue;
            }
            int enp = cur->np[ci];
            int64_t ep = cur->pos[ci];
            if (ep > p) return 0;  // worker sample-skipped p: no pairs
            if (ep == p) {
                for (int a = 0; a < enp; a++) {
                    lens[a] = cur->pairs[poff + 2 * a];
                    dists[a] = cur->pairs[poff + 2 * a + 1];
                }
                ci++;
                poff += 2 * (size_t)enp;
                return enp;
            }
            ci++;  // stale entry (parser jumped past it): discard
            poff += 2 * (size_t)enp;
        }
    }
    void note_gap(int64_t, int64_t) {}  // worker drives its own skips
};

// ---------------------------------------------------- emit helpers ---

static void emit_rep(RangeEnc& rc, Probs& P, int& state, U32* reps,
                     int pos_state, int rep_idx, int len) {
    rc.encode_bit(P.is_rep[state], 1);
    if (rep_idx == 0) {
        rc.encode_bit(P.is_rep_g0[state], 0);
        rc.encode_bit(P.is_rep0_long[state][pos_state], 1);
    } else {
        U32 dist = reps[rep_idx];
        rc.encode_bit(P.is_rep_g0[state], 1);
        if (rep_idx == 1) {
            rc.encode_bit(P.is_rep_g1[state], 0);
        } else {
            rc.encode_bit(P.is_rep_g1[state], 1);
            rc.encode_bit(P.is_rep_g2[state], rep_idx == 3);
            if (rep_idx == 3) reps[3] = reps[2];
            reps[2] = reps[1];
        }
        reps[1] = reps[0];
        reps[0] = dist;
    }
    rc.len_encode(P.rep_len, pos_state, len - kMatchMinLen);
    state = state_upd_rep(state);
}

static void emit_match(RangeEnc& rc, Probs& P, int& state, U32* reps,
                       int pos_state, int len, U32 dist) {
    rc.encode_bit(P.is_rep[state], 0);
    reps[3] = reps[2];
    reps[2] = reps[1];
    reps[1] = reps[0];
    reps[0] = dist;
    rc.len_encode(P.len, pos_state, len - kMatchMinLen);
    encode_distance(rc, P, len, dist);
    state = state_upd_match(state);
}

// ------------------------------------------------- optimal parser ---
// Dynamic program over a segment of up to kNumOpts positions: node j =
// cheapest known encoding of the next j bytes.  Each node stores its
// exact coder state and rep set, so prices are exact under the
// segment-start probability snapshot (the SDK's GetOptimum
// reconstructs these incrementally instead; same search space).
// Segments cut early at nice_len-or-longer matches, which both caps
// the DP and avoids truncating long matches at segment edges.

constexpr int kNumOpts = 2048;

struct OptNode {
    U32 price;
    int32_t prev;
    U32 back;  // kBackLit / kBackShortRep / rep idx 0-3 / dist + 4
    U8 state;
    U16 ext;   // 0: simple move; else composite "move(ext bytes) +
               // literal + rep0(rest)" - the survival trick for
               // rep-establishing paths (cf. the SDK's prev2/posPrev2
               // composite backpointers, LzmaEnc.c:1684-1960)
    U32 reps[4];
};
constexpr U32 kBackLit = 0xFFFFFFFFu;
constexpr U32 kBackShortRep = 0xFFFFFFFEu;

template <class SRC>
int64_t encode_opt_t(const U8* in, int64_t n, std::vector<U8>& out,
                     int level, int lc, int lp, int pb, int nice,
                     SRC& mf) {
    Probs P;
    P.init(lc, lp);
    RangeEnc rc(out);
    const U32 pb_mask = (1u << pb) - 1;
    const U32 lp_mask = (1u << lp) - 1;
    const int num_pos_states = 1 << pb;
    int state = 0;
    U32 reps[4] = {0, 0, 0, 0};

    std::vector<OptNode> opt(kNumOpts + kMatchMaxLen + 1);
    LenPrices len_prices, rep_len_prices;
    DistPrices dist_prices;
    U32 mlens[BtMatchFinder::kMaxPairs], mdists[BtMatchFinder::kMaxPairs];

    int64_t pos0 = 0;
    int64_t price_refresh_at = 0;  // bytes-encoded watermark
    while (pos0 < n) {
        // price-table refresh on a byte counter (early-cut segments
        // can be short; per-segment refill would dominate - the SDK
        // refreshes the same tables on event counters,
        // LzmaEnc.c:2325-2342)
        if (pos0 >= price_refresh_at) {
            len_prices.fill(P.len, num_pos_states);
            rep_len_prices.fill(P.rep_len, num_pos_states);
            dist_prices.fill(P);
            price_refresh_at = pos0 + kNumOpts;
        }

        const int H = (int)((n - pos0) < (int64_t)kNumOpts + kMatchMaxLen
                            ? (n - pos0) : kNumOpts + kMatchMaxLen);
        for (int j = 0; j <= H; j++) opt[j].price = kInfPrice;
        opt[0].price = 0;
        opt[0].prev = -1;
        opt[0].back = kBackLit;
        opt[0].state = (U8)state;
        opt[0].ext = 0;
        std::memcpy(opt[0].reps, reps, sizeof reps);

        int len_end = 0;       // furthest node relaxed so far

        auto relax = [&](int to, U32 price, int from, U32 back,
                         U8 nstate, const U32* nreps, U16 ext = 0) {
            if (price < opt[to].price) {
                opt[to].price = price;
                opt[to].prev = from;
                opt[to].back = back;
                opt[to].state = nstate;
                opt[to].ext = ext;
                std::memcpy(opt[to].reps, nreps, 4 * sizeof(U32));
            }
        };

        // composite "move + mismatch literal + rep0 continuation":
        // prices the future reuse of a move's distance into one
        // relaxation, so paths that establish a long-range rep are not
        // pruned at the intermediate nodes (the GetOptimum len2 blocks,
        // LzmaEnc.c:1684-1960).  first_price covers the move itself.
        auto relax_combined = [&](int cur_, int64_t p_, int mv_len,
                                  U32 dist /* rep-coded rep0 after mv */,
                                  U32 first_price, U32 back, U8 st1,
                                  const U32* nreps) {
            int64_t p2 = p_ + mv_len + 1;
            int to_base = cur_ + mv_len + 1;
            if (to_base + kMatchMinLen > H || p2 + kMatchMinLen > n)
                return;
            int len2 = match_len_at(in, n, p2, dist);
            int cap2 = H - to_base;
            if (len2 > cap2) len2 = cap2;
            if (len2 < kMatchMinLen) return;
            int ps1 = (int)((U32)(p_ + mv_len) & pb_mask);
            int ps2 = (int)((U32)p2 & pb_mask);
            U32 pr = first_price
                     + price0(P.is_match[st1][ps1])
                     + literal_price(P, in, p_ + mv_len, st1, dist, lc,
                                     lp_mask);
            U8 st2 = (U8)state_upd_lit(st1);
            pr += price1(P.is_match[st2][ps2])
                  + price1(P.is_rep[st2])
                  + price0(P.is_rep_g0[st2])
                  + price1(P.is_rep0_long[st2][ps2])
                  + rep_len_prices.p[ps2][len2 - kMatchMinLen];
            U8 st3 = (U8)state_upd_rep(st2);
            relax(to_base + len2, pr, cur_, back, st3, nreps,
                  (U16)mv_len);
            if (to_base + len2 > len_end) len_end = to_base + len2;
        };

        int cur = 0;
        bool cut = false;      // long-match early exit taken
        int searched = 0;      // positions fed to mf.get_matches
        for (; cur == 0 || (cur <= len_end && cur < kNumOpts && !cut);
             cur++) {
            const OptNode node = opt[cur];  // copy: opt[] mutates below
            const int64_t p = pos0 + cur;
            if (p >= n) break;
            const int ps = (int)((U32)p & pb_mask);
            const int avail = H - cur;
            const int maxl_here =
                avail < kMatchMaxLen ? avail : kMatchMaxLen;

            // literal
            {
                U32 pr = node.price
                         + price0(P.is_match[node.state][ps])
                         + literal_price(P, in, p, node.state,
                                         node.reps[0], lc, lp_mask);
                relax(cur + 1, pr, cur, kBackLit,
                      (U8)state_upd_lit(node.state), node.reps);
                if (cur + 1 > len_end) len_end = cur + 1;
            }
            const U32 match_price =
                node.price + price1(P.is_match[node.state][ps]);
            const U32 rep_match_price =
                match_price + price1(P.is_rep[node.state]);

            // short rep (1 byte from rep0)
            if ((U64)node.reps[0] + 1 <= (U64)p
                && in[p] == in[p - node.reps[0] - 1]) {
                U32 pr = rep_match_price
                         + price0(P.is_rep_g0[node.state])
                         + price0(P.is_rep0_long[node.state][ps]);
                relax(cur + 1, pr, cur, kBackShortRep,
                      (U8)state_upd_shortrep(node.state), node.reps);
            }

            // rep matches (duplicate distances keep only the earliest
            // index - its choice bits are the cheapest path)
            for (int k = 0; k < 4; k++) {
                if ((U64)node.reps[k] + 1 > (U64)p) continue;
                bool dup = false;
                for (int j = 0; j < k; j++)
                    if (node.reps[j] == node.reps[k]) { dup = true; break; }
                if (dup) continue;
                int l = match_len_at(in, n, p, node.reps[k]);
                if (l > maxl_here) l = maxl_here;
                if (l < kMatchMinLen) continue;
                U32 choice;
                if (k == 0)
                    choice = price0(P.is_rep_g0[node.state])
                             + price1(P.is_rep0_long[node.state][ps]);
                else if (k == 1)
                    choice = price1(P.is_rep_g0[node.state])
                             + price0(P.is_rep_g1[node.state]);
                else
                    choice = price1(P.is_rep_g0[node.state])
                             + price1(P.is_rep_g1[node.state])
                             + price_bit(P.is_rep_g2[node.state], k == 3);
                U32 base = rep_match_price + choice;
                U32 nreps[4];
                nreps[0] = node.reps[k];
                nreps[1] = node.reps[k == 0 ? 1 : 0];
                nreps[2] = node.reps[k <= 1 ? 2 : 1];
                nreps[3] = node.reps[k <= 2 ? 3 : 2];
                U8 nstate = (U8)state_upd_rep(node.state);
                if (l >= nice) {
                    // long rep: take it outright and cut the segment
                    U32 pr = base + rep_len_prices.p[ps][l - kMatchMinLen];
                    relax(cur + l, pr, cur, (U32)k, nstate, nreps);
                    len_end = cur + l;
                    cut = true;
                    break;
                }
                for (int L = kMatchMinLen; L <= l; L++)
                    relax(cur + L,
                          base + rep_len_prices.p[ps][L - kMatchMinLen],
                          cur, (U32)k, nstate, nreps);
                if (cur + l > len_end) len_end = cur + l;
                relax_combined(cur, p, l, nreps[0],
                               base + rep_len_prices.p[ps][l - kMatchMinLen],
                               (U32)k, nstate, nreps);
            }
            if (cut) break;

            // normal matches from BT4
            int np = mf.get(p, mlens, mdists);
            searched = cur + 1;
            if (np && maxl_here >= kMatchMinLen) {
                int maxlen = (int)mlens[np - 1];
                if (maxlen > maxl_here) maxlen = maxl_here;
                const U32 normal_price =
                    match_price + price0(P.is_rep[node.state]);
                U8 nstate = (U8)state_upd_match(node.state);
                if ((int)mlens[np - 1] >= nice
                    || mlens[np - 1] >= (U32)avail) {
                    // nice_len match: take the longest outright
                    U32 dist = mdists[np - 1];
                    int L = maxlen;
                    U32 nreps[4] = {dist, node.reps[0], node.reps[1],
                                    node.reps[2]};
                    U32 pr = normal_price
                             + len_prices.p[ps][L - kMatchMinLen]
                             + dist_prices.get(len_to_pos_state(L), dist);
                    relax(cur + L, pr, cur, dist + 4, nstate, nreps);
                    len_end = cur + L;
                    cut = true;
                    break;
                }
                int j = 0;
                for (int L = kMatchMinLen; L <= maxlen; L++) {
                    while ((int)mlens[j] < L) j++;
                    U32 dist = mdists[j];
                    U32 nreps[4] = {dist, node.reps[0], node.reps[1],
                                    node.reps[2]};
                    U32 pr = normal_price
                             + len_prices.p[ps][L - kMatchMinLen]
                             + dist_prices.get(len_to_pos_state(L),
                                               dist);
                    relax(cur + L, pr, cur, dist + 4, nstate, nreps);
                    if (L == (int)mlens[j])  // at each pair's full len
                        relax_combined(cur, p, L, dist, pr, dist + 4,
                                       nstate, nreps);
                }
                if (cur + maxlen > len_end) len_end = cur + maxlen;
            }
        }

        if (len_end == 0) break;  // nothing reachable (n == pos0)

        // backtrack the cheapest path into the decision list
        static thread_local std::vector<int> path;
        path.clear();
        for (int j = len_end; j > 0; j = opt[j].prev) path.push_back(j);

        // emit decisions oldest-first
        int64_t p = pos0;
        for (int t = (int)path.size() - 1; t >= 0; t--) {
            const OptNode& nd = opt[path[t]];
            int seg_len = path[t] - (nd.prev);
            int ps = (int)((U32)p & pb_mask);
            if (nd.ext) {
                // composite: move(ext) + mismatch literal + rep0(rest)
                int mv = nd.ext;
                int len2 = seg_len - mv - 1;
                rc.encode_bit(P.is_match[state][ps], 1);
                if (nd.back < 4)
                    emit_rep(rc, P, state, reps, ps, (int)nd.back, mv);
                else
                    emit_match(rc, P, state, reps, ps, mv, nd.back - 4);
                p += mv;
                ps = (int)((U32)p & pb_mask);
                rc.encode_bit(P.is_match[state][ps], 0);
                encode_literal(rc, P, in, p, state, reps[0], lc, lp_mask);
                state = state_upd_lit(state);
                p += 1;
                ps = (int)((U32)p & pb_mask);
                rc.encode_bit(P.is_match[state][ps], 1);
                emit_rep(rc, P, state, reps, ps, 0, len2);
                p += len2;
                continue;
            }
            if (nd.back == kBackLit) {
                rc.encode_bit(P.is_match[state][ps], 0);
                encode_literal(rc, P, in, p, state, reps[0], lc, lp_mask);
                state = state_upd_lit(state);
            } else if (nd.back == kBackShortRep) {
                rc.encode_bit(P.is_match[state][ps], 1);
                rc.encode_bit(P.is_rep[state], 1);
                rc.encode_bit(P.is_rep_g0[state], 0);
                rc.encode_bit(P.is_rep0_long[state][ps], 0);
                state = state_upd_shortrep(state);
            } else if (nd.back < 4) {
                rc.encode_bit(P.is_match[state][ps], 1);
                emit_rep(rc, P, state, reps, ps, (int)nd.back, seg_len);
            } else {
                rc.encode_bit(P.is_match[state][ps], 1);
                emit_match(rc, P, state, reps, ps, seg_len,
                           nd.back - 4);
            }
            p += seg_len;
        }

        // positions the DP never searched (inside the final accepted
        // matches / past the early cut) still need tree insertion so
        // later searches can find them.  Inside long matches the data
        // is a repeat of an already-indexed region, so the sync source
        // samples the interior instead of inserting every position
        // (each BT insert is a full tree descent; the SDK pays it -
        // its skip loop at LzFind.c:1374 - which is why BT4 crawls on
        // highly repetitive data).  The pipelined source drives its
        // own skips ahead of the parse.
        mf.note_gap(pos0 + searched, pos0 + len_end);
        pos0 += len_end;
    }

    // end-of-payload marker: match with distance 0xFFFFFFFF, len 2
    {
        int ps = (int)((U32)pos0 & pb_mask);
        rc.encode_bit(P.is_match[state][ps], 1);
        rc.encode_bit(P.is_rep[state], 0);
        rc.len_encode(P.len, ps, 0);
        encode_distance(rc, P, kMatchMinLen, 0xFFFFFFFFu);
    }
    rc.flush();
    return (int64_t)out.size();
}

int64_t encode_opt(const U8* in, int64_t n, std::vector<U8>& out,
                   int level, U32 dict_size, int lc, int lp, int pb,
                   int threads, int mf) {
    const int nice = level < 7 ? 32 : 64;     // fb (src/stream.c:455)
    const int cycles = (16 + nice / 2) * (level >= 9 ? 2 : 1);
    // match-finder family selector (the SDK's bt2/bt3/bt4/bt5
    // numHashBytes dial, LzFind.c:962-1400); bt4 is the default as in
    // the reference's stream.c lzma setup.  mf 2..5 selects
    // explicitly (--lzma-mf); 0 = default with the LRZ_LZMA_MF env
    // var kept as a debug override.
    int nhb = (mf >= 2 && mf <= 5) ? mf : 4;
    if (mf == 0) {
        if (const char* e = std::getenv("LRZ_LZMA_MF")) {
            if (e[0] == 'b' && e[1] == 't' && e[2] >= '2' && e[2] <= '5'
                && e[3] == 0)
                nhb = e[2] - '0';
        }
    }
    if (threads >= 2 && n > (1 << 16)) {
        AheadSource src(in, n, dict_size, cycles, nice, nhb);
        return encode_opt_t(in, n, out, level, lc, lp, pb, nice, src);
    }
    SyncSource src(in, n, dict_size, cycles, nice, nhb);
    return encode_opt_t(in, n, out, level, lc, lp, pb, nice, src);
}

int64_t encode(const U8* in, int64_t n, std::vector<U8>& out, int level,
               U32 dict_size, int lc, int lp, int pb, int threads,
               int mf_sel = 0) {
    if (level >= 5)  // normal mode: BT4 + optimal parse (SDK algo=1)
        return encode_opt(in, n, out, level, dict_size, lc, lp, pb,
                          threads, mf_sel);
    Probs P;
    P.init(lc, lp);
    RangeEnc rc(out);
    const U32 pb_mask = (1u << pb) - 1;
    const U32 lp_mask = (1u << lp) - 1;
    int state = 0;
    U32 reps[4] = {0, 0, 0, 0};

    int depth = level <= 2 ? 8 : (level <= 5 ? 24 : (level <= 7 ? 48 : 96));
    int nice = level < 7 ? 32 : 64;  // fb mapping (src/stream.c:455)
    MatchFinder mf(in, n, dict_size ? dict_size : 0xFFFFFFFFu, depth);

    int64_t pos = 0;
    // pending match found by the lazy look-ahead for the next position
    int have_next = 0;
    int next_len = 0;
    U32 next_dist = 0;

    while (pos < n) {
        int main_len;
        U32 main_dist = 0;
        if (have_next) {
            main_len = next_len;
            main_dist = next_dist;
            have_next = 0;
        } else {
            main_len = mf.find(pos, &main_dist);
        }
        // best rep match
        int rep_len = 0, rep_idx = 0;
        for (int r = 0; r < 4; r++) {
            int l = match_len_at(in, n, pos, reps[r]);
            if (l > rep_len) { rep_len = l; rep_idx = r; }
        }
        // normal-match admissibility (cheap dist/len sanity like
        // GetOptimumFast's ChangePair rules)
        if (main_len == 2 && main_dist >= 512) main_len = 0;
        if (main_len == 3 && main_dist >= (1u << 15)) main_len = 2;
        if (main_len < kMatchMinLen) main_len = 0;

        bool use_rep = rep_len >= 2
            && (rep_len + 1 >= main_len
                || (rep_len + 2 >= main_len && main_dist >= (1u << 9))
                || (rep_len + 3 >= main_len && main_dist >= (1u << 15)));

        if (!use_rep && main_len >= kMatchMinLen && main_len < nice
            && pos + 1 < n) {
            // one-step lazy with the SDK's distance-aware preference
            // rules (GetOptimumFast, LzmaEnc.c:1970: a slightly longer
            // match is not worth it when its distance class jumps)
            next_len = mf.find(pos + 1, &next_dist);
            have_next = 1;
            auto change_pair = [](U32 small, U32 big) {
                return (big >> 7) > small;
            };
            bool lit = false;
            if (next_len >= main_len && next_dist < main_dist)
                lit = true;
            else if (next_len == main_len + 1
                     && !change_pair(main_dist, next_dist))
                lit = true;
            else if (next_len > main_len + 1)
                lit = true;
            else if (next_len + 1 >= main_len && main_len >= 3
                     && change_pair(next_dist, main_dist))
                lit = true;
            if (lit) main_len = 0;
        }

        int pos_state = (int)((U32)pos & pb_mask);
        if (use_rep && rep_len >= 2) {
            if (trace_on())
                std::fprintf(stderr, "E pos=%lld REP len=%d idx=%d dist=%u\n",
                             (long long)pos, rep_len, rep_idx, reps[rep_idx]);
            rc.encode_bit(P.is_match[state][pos_state], 1);
            rc.encode_bit(P.is_rep[state], 1);
            U32 dist = reps[rep_idx];
            if (rep_idx == 0) {
                rc.encode_bit(P.is_rep_g0[state], 0);
                if (rep_len == 1) {
                    rc.encode_bit(P.is_rep0_long[state][pos_state], 0);
                    state = state_upd_shortrep(state);
                    pos += 1;
                    continue;
                }
                rc.encode_bit(P.is_rep0_long[state][pos_state], 1);
            } else {
                rc.encode_bit(P.is_rep_g0[state], 1);
                if (rep_idx == 1) {
                    rc.encode_bit(P.is_rep_g1[state], 0);
                } else {
                    rc.encode_bit(P.is_rep_g1[state], 1);
                    rc.encode_bit(P.is_rep_g2[state], rep_idx == 3);
                    if (rep_idx == 3) reps[3] = reps[2];
                    reps[2] = reps[1];
                }
                reps[1] = reps[0];
                reps[0] = dist;
            }
            rc.len_encode(P.rep_len, pos_state, rep_len - kMatchMinLen);
            state = state_upd_rep(state);
            // feed skipped positions to the match finder
            if (have_next) {
                for (int64_t k = pos + 2; k < pos + rep_len; k++)
                    mf.insert(k);
            } else {
                for (int64_t k = pos + 1; k < pos + rep_len; k++)
                    mf.insert(k);
            }
            have_next = 0;
            pos += rep_len;
        } else if (main_len >= kMatchMinLen) {
            if (trace_on())
                std::fprintf(stderr, "E pos=%lld MATCH len=%d dist=%u\n",
                             (long long)pos, main_len, main_dist);
            rc.encode_bit(P.is_match[state][pos_state], 1);
            rc.encode_bit(P.is_rep[state], 0);
            reps[3] = reps[2];
            reps[2] = reps[1];
            reps[1] = reps[0];
            reps[0] = main_dist;
            rc.len_encode(P.len, pos_state, main_len - kMatchMinLen);
            encode_distance(rc, P, main_len, main_dist);
            state = state_upd_match(state);
            if (have_next) {
                for (int64_t k = pos + 2; k < pos + main_len; k++)
                    mf.insert(k);
            } else {
                for (int64_t k = pos + 1; k < pos + main_len; k++)
                    mf.insert(k);
            }
            have_next = 0;
            pos += main_len;
        } else {
            rc.encode_bit(P.is_match[state][pos_state], 0);
            encode_literal(rc, P, in, pos, state, reps[0], lc, lp_mask);
            state = state_upd_lit(state);
            pos += 1;
        }
    }
    // end-of-payload marker: match with distance 0xFFFFFFFF, len 2
    {
        int pos_state = (int)((U32)pos & pb_mask);
        rc.encode_bit(P.is_match[state][pos_state], 1);
        rc.encode_bit(P.is_rep[state], 0);
        rc.len_encode(P.len, pos_state, 0);
        encode_distance(rc, P, kMatchMinLen, 0xFFFFFFFFu);
    }
    rc.flush();
    return (int64_t)out.size();
}

}  // namespace tlz

extern "C" {

// Raw LZMA1 encode; returns bytes written, or -1 when the result would
// exceed cap.  threads >= 2 enables the pipelined match finder (the
// LzFindMt analog, reference src/lzma/C/LzFindMt.c via numThreads at
// src/stream.c:456; --nobemt passes 1).
// mf: 0 = default (bt4; LRZ_LZMA_MF env debug override), 2..5 = btN
// (the SDK's numHashBytes dial, LzFind.c MatchFinder_CreateVTable).
int64_t lzma1_encode(const uint8_t* in, int64_t n, uint8_t* out,
                     int64_t cap, int level, uint32_t dict_size,
                     int lc, int lp, int pb, int threads, int mf) {
    if (lc < 0 || lc > 8 || lp < 0 || lp > 4 || pb < 0 || pb > 4)
        return -1;
    if (mf != 0 && (mf < 2 || mf > 5)) return -1;
    std::vector<uint8_t> buf;
    buf.reserve((size_t)(n / 2 + 256));
    int64_t r = tlz::encode(in, n, buf, level, dict_size, lc, lp, pb,
                            threads, mf);
    if (r < 0 || r > cap) return -1;
    std::memcpy(out, buf.data(), (size_t)r);
    return r;
}

// Raw LZMA1 decode of exactly u_len bytes; returns u_len or -1 on
// corruption.
int64_t lzma1_decode(const uint8_t* in, int64_t n, uint8_t* out,
                     int64_t u_len, int lc, int lp, int pb) {
    return tlz::decode(in, n, out, u_len, lc, lp, pb);
}

}  // extern "C"
