// From-scratch ZPAQ level-1/2 codec for lrzip_next_tpu.
//
// Replaces the reference's vendored libzpaq 7.15 (reference
// src/lib/libzpaq/) with an independent implementation of the
// public-domain ZPAQ specification:
//
//  - ZPAQL virtual machine (interpreted; no JIT), executing the context
//    computation (HCOMP) and post-processing (PCOMP) programs embedded
//    in archives (semantics per the spec's instruction table; cf.
//    reference libzpaq.cpp:1043-1270 for the same ISA)
//  - context-mixing predictor with CONST/CM/ICM/MATCH/AVG/MIX2/MIX/
//    ISSE/SSE components (spec section 5; cf. libzpaq.cpp:1779-2070)
//  - carry-less range coder (spec section 4)
//  - block/segment container framing with the standard 13-byte locator
//    tag (spec section 3)
//
// Decode handles any conforming archive, including LZ77/BWT/E8E9
// methods, because their inverses arrive as PCOMP bytecode and run in
// the VM. Encode emits this implementation's own context-model config
// (an order-0..5 ICM/ISSE chain + match model + mixer, the classic
// "mid" topology) - valid input for any conforming decoder, including
// the reference's.
//
// Interop gate: squash()/stretch() tables are rebuilt from the spec
// formulas and verified against the spec's published checksums at init;
// the bit-history state table is the spec's 1024-byte format constant.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <vector>
#include <string>
#include <stdexcept>
#include <atomic>
#include <mutex>
#include <thread>

#include "zpaq_statetable.inc"

namespace tpz {

typedef uint8_t U8;
typedef uint16_t U16;
typedef uint32_t U32;
typedef uint64_t U64;

struct Err : std::runtime_error {
    explicit Err(const char* m) : std::runtime_error(m) {}
};

// ------------------------------------------------------------- I/O ----

struct Source {
    const U8* p;
    int64_t pos, len;
    int get() { return pos < len ? p[pos++] : -1; }
};

struct Sink {
    U8* p;
    int64_t pos, cap;
    bool overflow = false;
    void put(int c) {
        if (pos < cap) p[pos++] = (U8)c;
        else overflow = true;
    }
    void write(const U8* b, int64_t n) {
        if (pos + n <= cap) { std::memcpy(p + pos, b, n); pos += n; }
        else overflow = true;
    }
};

// -------------------------------------------------------- tables ------

static U16 g_squash[4096];
static short g_stretch[32768];
static int g_dt2k[256];
static int g_dt[1024];
static bool g_tables_ready = false;

static void build_tables() {
    if (g_tables_ready) return;
    // squash(x) = floor(32768 / (1 + e^(-x/64))), clamped at the ends
    for (int i = 0; i < 4096; i++) {
        if (i < 1376) g_squash[i] = 0;
        else if (i >= 2720) g_squash[i] = 32767;
        else g_squash[i] =
            (U16)(32768.0 / (1.0 + std::exp((i - 2048) * (-1.0 / 64))));
    }
    // stretch = rounded inverse of squash
    for (int x = 16384; x < 32768; x++)
        g_stretch[x] = (short)((int)(std::log((x + 0.5) / (32767.5 - x))
                                     * 64 + 0.5 + 100000) - 100000);
    for (int x = 0; x < 16384; x++)
        g_stretch[x] = (short)(-g_stretch[32767 - x]);
    // spec checksums guard against libm rounding drift
    U32 sq = 0, st = 0;
    for (int i = 32767; i >= 0; --i) st = st * 3 + (U32)g_stretch[i];
    for (int i = 4095; i >= 0; --i) sq = sq * 3 + g_squash[i];
    if (st != 3887533746u || sq != 2278286169u)
        throw Err("squash/stretch tables diverge from ZPAQ spec");
    for (int i = 0; i < 256; i++) g_dt2k[i] = i ? 2048 / i : 0;
    for (int i = 0; i < 1024; i++) g_dt[i] = (1 << 17) / (i * 2 + 3) * 2;
    g_tables_ready = true;
}

static inline int squash(int x) {
    if (x < -2048) x = -2048;
    if (x > 2047) x = 2047;
    return g_squash[x + 2048];
}
static inline int stretch(int x) { return g_stretch[x & 32767]; }
static inline int clamp2k(int x) {
    return x < -2048 ? -2048 : x > 2047 ? 2047 : x;
}
static inline int clamp512k(int x) {
    return x < -(1 << 19) ? -(1 << 19)
         : x >= (1 << 19) ? (1 << 19) - 1 : x;
}

// component type codes and their header sizes
enum { NONE = 0, CONS = 1, CM = 2, ICM = 3, MATCH = 4, AVG = 5,
       MIX2 = 6, MIX = 7, ISSE = 8, SSE = 9 };
static const int kCompSize[256] = {0, 2, 3, 2, 3, 4, 6, 6, 3, 5};

// ------------------------------------------------------------ VM ------

// ZPAQL machine. Header layout: hsize[2] hh hm ph pm n COMP 0 HCOMP 0,
// with HCOMP relocated 128 bytes past COMP (guard gap).
struct VM {
    std::vector<U8> header;
    int cend = 0, hbegin = 0, hend = 0;
    std::vector<U8> m;
    std::vector<U32> h, r;
    U32 a = 0, b = 0, c = 0, d = 0;
    int f = 0, pc = 0;
    Sink* out = nullptr;  // OUT instruction target (postprocessing)

    U32& H(U32 i) { return h[i & (h.size() - 1)]; }
    U8& M(U32 i) { return m[i & (m.size() - 1)]; }

    void clear() {
        header.clear(); m.clear(); h.clear(); r.clear();
        cend = hbegin = hend = 0;
        a = b = c = d = 0; f = pc = 0;
    }

    int read_header(Source& in) {
        int hsize = in.get();
        int c2 = in.get();
        if (c2 < 0) throw Err("EOF in header");
        hsize += c2 * 256;
        header.assign(hsize + 300, 0);
        cend = hbegin = hend = 0;
        header[cend++] = hsize & 255;
        header[cend++] = hsize >> 8;
        while (cend < 7) {
            int v = in.get();
            if (v < 0) throw Err("EOF in header");
            header[cend++] = (U8)v;
        }
        int n = header[6];
        for (int i = 0; i < n; i++) {
            int type = in.get();
            if (type < 0) throw Err("EOF in COMP");
            header[cend++] = (U8)type;
            int sz = kCompSize[type & 255];
            if (sz < 1) throw Err("bad component type");
            if (cend + sz > hsize) throw Err("COMP overflow");
            for (int j = 1; j < sz; j++) {
                int v = in.get();
                if (v < 0) throw Err("EOF in COMP");
                header[cend++] = (U8)v;
            }
        }
        int e = in.get();
        header[cend++] = (U8)e;
        if (e != 0) throw Err("missing COMP end");
        hbegin = hend = cend + 128;
        if (hend > hsize + 129) throw Err("missing HCOMP");
        while (hend < hsize + 129) {
            int op = in.get();
            if (op < 0) throw Err("EOF in HCOMP");
            header[hend++] = (U8)op;
        }
        e = in.get();
        header[hend++] = (U8)e;
        if (e != 0) throw Err("missing HCOMP end");
        return cend + hend - hbegin;
    }

    void init_mem(int hbits, int mbits) {
        if (hbits > 28 || mbits > 28) throw Err("H/M too big");
        h.assign((size_t)1 << hbits, 0);
        m.assign((size_t)1 << mbits, 0);
        r.assign(256, 0);
        a = b = c = d = 0; f = pc = 0;
    }
    void init_h() { init_mem(header[2], header[3]); }
    void init_p() { init_mem(header[4], header[5]); }

    void run(U32 input) {
        pc = hbegin;
        a = input;
        while (step()) {}
    }

    void div_(U32 x) { a = x ? a / x : 0; }
    void mod_(U32 x) { a = x ? a % x : 0; }
    template <class T> void swap_(T& x) { U32 t = (U32)x; x = (T)a; a = t; }

    int step();
};

// One interpreted ZPAQL instruction; opcode map per the spec's table.
int VM::step() {
    const U8* hd = header.data();
    int op = hd[pc++];
    const int band = op & 7;   // operand selector for ALU group
    if (op >= 128 && op < 240) {
        // ALU: A op= operand
        U32 v;
        switch (band) {
            case 0: v = a; break;
            case 1: v = b; break;
            case 2: v = c; break;
            case 3: v = d; break;
            case 4: v = M(b); break;
            case 5: v = M(c); break;
            case 6: v = H(d); break;
            default: v = hd[pc++]; break;
        }
        switch (op >> 3) {
            case 16: a += v; break;
            case 17: a -= v; break;
            case 18: a *= v; break;
            case 19: div_(v); break;
            case 20: mod_(v); break;
            case 21: a &= v; break;
            case 22: a &= ~v; break;
            case 23: a |= v; break;
            case 24: a ^= v; break;
            case 25: a <<= (v & 31); break;
            case 26: a >>= (v & 31); break;
            case 27: f = (op == 216) ? 1 : (a == v); break;
            case 28: f = (op == 224) ? 0 : (a < v); break;
            case 29: f = (op == 232) ? 0 : (a > v); break;
            default: throw Err("bad opcode");
        }
        return 1;
    }
    if (op >= 64 && op < 128) {
        // MOV dst = src over {A,B,C,D,*B,*C,*D,imm}
        U32 v;
        switch (band) {
            case 0: v = a; break;
            case 1: v = b; break;
            case 2: v = c; break;
            case 3: v = d; break;
            case 4: v = M(b); break;
            case 5: v = M(c); break;
            case 6: v = H(d); break;
            default: v = hd[pc++]; break;
        }
        switch ((op - 64) >> 3) {
            case 0: a = v; break;
            case 1: b = v; break;
            case 2: c = v; break;
            case 3: d = v; break;
            case 4: M(b) = (U8)v; break;
            case 5: M(c) = (U8)v; break;
            case 6: H(d) = v; break;
            default: throw Err("bad opcode");
        }
        return 1;
    }
    switch (op) {
        case 0: throw Err("ZPAQL execution error");
        case 1: ++a; break;
        case 2: --a; break;
        case 3: a = ~a; break;
        case 4: a = 0; break;
        case 7: a = r[hd[pc++]]; break;
        case 8: swap_(b); break;
        case 9: ++b; break;
        case 10: --b; break;
        case 11: b = ~b; break;
        case 12: b = 0; break;
        case 15: b = r[hd[pc++]]; break;
        case 16: swap_(c); break;
        case 17: ++c; break;
        case 18: --c; break;
        case 19: c = ~c; break;
        case 20: c = 0; break;
        case 23: c = r[hd[pc++]]; break;
        case 24: swap_(d); break;
        case 25: ++d; break;
        case 26: --d; break;
        case 27: d = ~d; break;
        case 28: d = 0; break;
        case 31: d = r[hd[pc++]]; break;
        case 32: swap_(M(b)); break;
        case 33: ++M(b); break;
        case 34: --M(b); break;
        case 35: M(b) = ~M(b); break;
        case 36: M(b) = 0; break;
        case 39: if (f) pc += ((hd[pc] + 128) & 255) - 127; else ++pc;
                 break;  // JT
        case 40: swap_(M(c)); break;
        case 41: ++M(c); break;
        case 42: --M(c); break;
        case 43: M(c) = ~M(c); break;
        case 44: M(c) = 0; break;
        case 47: if (!f) pc += ((hd[pc] + 128) & 255) - 127; else ++pc;
                 break;  // JF
        case 48: swap_(H(d)); break;
        case 49: ++H(d); break;
        case 50: --H(d); break;
        case 51: H(d) = ~H(d); break;
        case 52: H(d) = 0; break;
        case 55: r[hd[pc++]] = a; break;
        case 56: return 0;  // HALT
        case 57: if (out) out->put(a & 255); break;  // OUT
        case 59: a = (a + M(b) + 512) * 773; break;  // HASH
        case 60: H(d) = (H(d) + a + 512) * 773; break;  // HASHD
        case 63: pc += ((hd[pc] + 128) & 255) - 127; break;  // JMP
        case 255:  // LJ
            pc = hbegin + hd[pc] + 256 * hd[pc + 1];
            if (pc >= hend) throw Err("LJ out of range");
            break;
        default: throw Err("bad opcode");
    }
    return 1;
}

// ------------------------------------------------------ predictor -----

struct Comp {
    U32 limit = 0, cxt = 0, a = 0, b = 0, c = 0;
    std::vector<U32> cm;
    std::vector<U8> ht;
    std::vector<U16> a16;
    U32& CM(U32 i) { return cm[i & (cm.size() - 1)]; }
    U8& HT(U32 i) { return ht[i & (ht.size() - 1)]; }
};

struct Model {
    VM& z;
    Comp comp[256];
    int c8 = 1, hmap4 = 1;
    int p[256];
    U32 hh[256];

    explicit Model(VM& zr) : z(zr) {}

    bool is_modeled() const { return z.header[6] != 0; }

    static int st_next(int state, int y) {
        return kStateTable[state * 4 + y];
    }
    static int st_cminit(int state) {
        return ((kStateTable[state * 4 + 3] * 2 + 1) << 22)
               / (kStateTable[state * 4 + 2]
                  + kStateTable[state * 4 + 3] + 1);
    }

    void init() {
        build_tables();
        z.init_h();
        c8 = 1; hmap4 = 1;
        for (int i = 0; i < 256; i++) { hh[i] = 0; p[i] = 0; }
        for (int i = 0; i < 256; i++) comp[i] = Comp();
        int n = z.header[6];
        const U8* cp = &z.header[7];
        for (int i = 0; i < n; i++) {
            Comp& cr = comp[i];
            switch (cp[0]) {
                case CONS:
                    p[i] = (cp[1] - 128) * 4;
                    break;
                case CM:
                    if (cp[1] > 28) throw Err("CM too big");
                    cr.cm.assign((size_t)1 << cp[1], 0x80000000u);
                    cr.limit = cp[2] * 4;
                    break;
                case ICM:
                    if (cp[1] > 28) throw Err("ICM too big");
                    cr.limit = 1023;
                    cr.cm.resize(256);
                    cr.ht.assign((size_t)64 << cp[1], 0);
                    for (int j = 0; j < 256; j++)
                        cr.cm[j] = st_cminit(j);
                    break;
                case MATCH:
                    if (cp[1] > 28 || cp[2] > 28)
                        throw Err("MATCH too big");
                    cr.cm.assign((size_t)1 << cp[1], 0);
                    cr.ht.assign((size_t)1 << cp[2], 0);
                    cr.HT(0) = 1;
                    break;
                case AVG:
                    if (cp[1] >= i || cp[2] >= i) throw Err("AVG ref");
                    break;
                case MIX2:
                    if (cp[1] > 28) throw Err("MIX2 too big");
                    if (cp[2] >= i || cp[3] >= i) throw Err("MIX2 ref");
                    cr.c = (U32)1 << cp[1];
                    cr.a16.assign((size_t)1 << cp[1], 32768);
                    break;
                case MIX: {
                    if (cp[1] > 28) throw Err("MIX too big");
                    if (cp[2] >= i) throw Err("MIX ref");
                    if (cp[3] < 1 || cp[3] > i - cp[2])
                        throw Err("MIX m range");
                    int mm = cp[3];
                    cr.c = (U32)1 << cp[1];
                    cr.cm.assign(((size_t)1 << cp[1]) * mm, 65536 / mm);
                    break;
                }
                case ISSE:
                    if (cp[1] > 28) throw Err("ISSE too big");
                    if (cp[2] >= i) throw Err("ISSE ref");
                    cr.ht.assign((size_t)64 << cp[1], 0);
                    cr.cm.resize(512);
                    for (int j = 0; j < 256; j++) {
                        cr.cm[j * 2] = 1 << 15;
                        cr.cm[j * 2 + 1] = clamp512k(
                            stretch(st_cminit(j) >> 8) * 1024);
                    }
                    break;
                case SSE:
                    if (cp[1] > 28) throw Err("SSE too big");
                    if (cp[2] >= i) throw Err("SSE ref");
                    if (cp[3] > cp[4] * 4) throw Err("SSE start");
                    cr.cm.resize((size_t)32 << cp[1]);
                    cr.limit = cp[4] * 4;
                    for (size_t j = 0; j < cr.cm.size(); j++)
                        cr.cm[j] = (U32)(squash(((int)j & 31) * 64 - 992)
                                         << 17) | cp[3];
                    break;
                default: throw Err("unknown component");
            }
            cp += kCompSize[cp[0]];
        }
    }

    // 16-slot hash-table row lookup with 3-way probing + LRU replace
    size_t find(std::vector<U8>& ht, int sizebits, U32 cxt) {
        int chk = (cxt >> sizebits) & 255;
        size_t mask = ht.size() - 16;
        size_t h0 = ((size_t)cxt * 16) & mask;
        if (ht[h0] == chk) return h0;
        size_t h1 = h0 ^ 16;
        if (ht[h1] == chk) return h1;
        size_t h2 = h0 ^ 32;
        if (ht[h2] == chk) return h2;
        size_t hx;
        if (ht[h0 + 1] <= ht[h1 + 1] && ht[h0 + 1] <= ht[h2 + 1]) hx = h0;
        else if (ht[h1 + 1] < ht[h2 + 1]) hx = h1;
        else hx = h2;
        std::memset(&ht[hx], 0, 16);
        ht[hx] = (U8)chk;
        return hx;
    }

    // Encode-side prefetch: the byte is known before its 8 bits are
    // coded, so both nibbles' hash-table rows (ICM/ISSE find() probes,
    // the per-nibble DRAM misses that bound CM throughput on big
    // models) can be requested up front and overlap the coding work.
    void prefetch_byte(int ch) {
        int n = z.header[6];
        const U8* cp = &z.header[7];
        const U32 c8a = 1, c8b = 16 + (ch >> 4);
        for (int i = 0; i < n; i++) {
            if (cp[0] == ICM || cp[0] == ISSE) {
                Comp& cr = comp[i];
                size_t mask = cr.ht.size() - 16;
                int sizebits = cp[1] + 2;
                for (U32 c8 : {c8a, c8b}) {
                    U32 cxt = hh[i] + 16 * c8;
                    size_t h0 = ((size_t)cxt * 16) & mask;
                    __builtin_prefetch(&cr.ht[h0]);
                    __builtin_prefetch(&cr.ht[h0 ^ 16]);
                    __builtin_prefetch(&cr.ht[h0 ^ 32]);
                    (void)sizebits;
                }
            } else if (cp[0] == MATCH) {
                Comp& cr = comp[i];
                __builtin_prefetch(&cr.CM(hh[i]));
                __builtin_prefetch(&cr.HT(cr.limit - cr.b));
            }
            cp += kCompSize[cp[0]];
        }
    }

    int predict() {
        int n = z.header[6];
        const U8* cp = &z.header[7];
        for (int i = 0; i < n; i++) {
            Comp& cr = comp[i];
            switch (cp[0]) {
                case CONS: break;
                case CM:
                    cr.cxt = hh[i] ^ hmap4;
                    p[i] = stretch(cr.CM(cr.cxt) >> 17);
                    break;
                case ICM:
                    if (c8 == 1 || (c8 & 0xf0) == 16)
                        cr.c = (U32)find(cr.ht, cp[1] + 2,
                                         hh[i] + 16 * c8);
                    cr.cxt = cr.ht[cr.c + (hmap4 & 15)];
                    p[i] = stretch(cr.CM(cr.cxt) >> 8);
                    break;
                case MATCH:
                    if (cr.a == 0) p[i] = 0;
                    else {
                        cr.c = (cr.HT(cr.limit - cr.b)
                                >> (7 - cr.cxt)) & 1;
                        p[i] = stretch((g_dt2k[cr.a]
                                        * (cr.c * -2 + 1)) & 32767);
                    }
                    break;
                case AVG:
                    p[i] = (p[cp[1]] * cp[3]
                            + p[cp[2]] * (256 - cp[3])) >> 8;
                    break;
                case MIX2: {
                    cr.cxt = (hh[i] + (c8 & cp[5])) & (cr.c - 1);
                    int w = cr.a16[cr.cxt];
                    p[i] = (w * p[cp[2]] + (65536 - w) * p[cp[3]]) >> 16;
                    break;
                }
                case MIX: {
                    int mm = cp[3];
                    cr.cxt = hh[i] + (c8 & cp[5]);
                    cr.cxt = (cr.cxt & (cr.c - 1)) * mm;
                    int* wt = (int*)&cr.cm[cr.cxt];
                    int s = 0;
                    for (int j = 0; j < mm; j++)
                        s += (wt[j] >> 8) * p[cp[2] + j];
                    p[i] = clamp2k(s >> 8);
                    break;
                }
                case ISSE: {
                    if (c8 == 1 || (c8 & 0xf0) == 16)
                        cr.c = (U32)find(cr.ht, cp[1] + 2,
                                         hh[i] + 16 * c8);
                    cr.cxt = cr.ht[cr.c + (hmap4 & 15)];
                    int* wt = (int*)&cr.cm[cr.cxt * 2];
                    p[i] = clamp2k((wt[0] * p[cp[2]] + wt[1] * 64) >> 16);
                    break;
                }
                case SSE: {
                    cr.cxt = (hh[i] + c8) * 32;
                    int pq = p[cp[2]] + 992;
                    if (pq < 0) pq = 0;
                    if (pq > 1983) pq = 1983;
                    int wt = pq & 63;
                    pq >>= 6;
                    cr.cxt += pq;
                    p[i] = stretch(((cr.CM(cr.cxt) >> 10) * (64 - wt)
                                    + (cr.CM(cr.cxt + 1) >> 10) * wt)
                                   >> 13);
                    cr.cxt += wt >> 5;
                    break;
                }
                default: throw Err("predict: bad component");
            }
            cp += kCompSize[cp[0]];
        }
        return squash(p[n - 1]);
    }

    void train(Comp& cr, int y) {
        U32& pn = cr.CM(cr.cxt);
        U32 count = pn & 0x3ff;
        int error = y * 32767 - (int)(pn >> 17);
        pn += (U32)((error * g_dt[count]) & -1024)
              + (count < cr.limit);
    }

    void update(int y) {
        const U8* cp = &z.header[7];
        int n = z.header[6];
        for (int i = 0; i < n; i++) {
            Comp& cr = comp[i];
            switch (cp[0]) {
                case CONS: break;
                case CM: train(cr, y); break;
                case ICM: {
                    cr.ht[cr.c + (hmap4 & 15)] =
                        (U8)st_next(cr.ht[cr.c + (hmap4 & 15)], y);
                    U32& pn = cr.CM(cr.cxt);
                    pn += (U32)((int)(y * 32767 - (int)(pn >> 8)) >> 2);
                    break;
                }
                case MATCH:
                    if ((int)cr.c != y) cr.a = 0;
                    cr.HT(cr.limit) = (U8)(cr.HT(cr.limit) * 2 + y);
                    if (++cr.cxt == 8) {
                        cr.cxt = 0;
                        ++cr.limit;
                        cr.limit &= (U32)(cr.ht.size() - 1);
                        if (cr.a == 0) {
                            cr.b = cr.limit - cr.CM(hh[i]);
                            if (cr.b & (cr.ht.size() - 1))
                                while (cr.a < 255
                                       && cr.HT(cr.limit - cr.a - 1)
                                          == cr.HT(cr.limit - cr.a
                                                   - cr.b - 1))
                                    ++cr.a;
                        } else cr.a += cr.a < 255;
                        cr.CM(hh[i]) = cr.limit;
                    }
                    break;
                case AVG: break;
                case MIX2: {
                    int err = (y * 32767 - squash(p[i])) * cp[4] >> 5;
                    int w = cr.a16[cr.cxt];
                    w += (err * (p[cp[2]] - p[cp[3]]) + (1 << 12)) >> 13;
                    if (w < 0) w = 0;
                    if (w > 65535) w = 65535;
                    cr.a16[cr.cxt] = (U16)w;
                    break;
                }
                case MIX: {
                    int mm = cp[3];
                    int err = (y * 32767 - squash(p[i])) * cp[4] >> 4;
                    int* wt = (int*)&cr.cm[cr.cxt];
                    for (int j = 0; j < mm; j++)
                        wt[j] = clamp512k(
                            wt[j] + ((err * p[cp[2] + j] + (1 << 12))
                                     >> 13));
                    break;
                }
                case ISSE: {
                    int err = y * 32767 - squash(p[i]);
                    int* wt = (int*)&cr.cm[cr.cxt * 2];
                    wt[0] = clamp512k(
                        wt[0] + ((err * p[cp[2]] + (1 << 12)) >> 13));
                    wt[1] = clamp512k(wt[1] + ((err + 16) >> 5));
                    cr.ht[cr.c + (hmap4 & 15)] =
                        (U8)st_next(cr.cxt, y);
                    break;
                }
                case SSE: train(cr, y); break;
                default: throw Err("update: bad component");
            }
            cp += kCompSize[cp[0]];
        }
        // advance bit history / byte boundary
        c8 += c8 + y;
        if (c8 >= 256) {
            z.run(c8 - 256);
            hmap4 = 1;
            c8 = 1;
            for (int i = 0; i < n; i++) hh[i] = z.H(i);
        } else if (c8 >= 16 && c8 < 32) {
            hmap4 = (hmap4 & 0xf) << 5 | y << 4 | 1;
        } else {
            hmap4 = (hmap4 & 0x1f0) | (((hmap4 & 0xf) * 2 + y) & 0xf);
        }
    }
};

// --------------------------------------------------- range coder ------

// ---------------- specialized CM evaluator (the libzpaq JIT analog) --
// libzpaq JIT-compiles each model's component loop to x86 at runtime
// (libzpaq.cpp Predictor rcode sections); this resolves the same
// specialization at C++ compile time for the topology family our
// build_model() emits: ICM -> chained ISSE x5 -> MATCH -> optional
// word ICM+ISSE -> optional periodic ICM[+ISSE] x2 -> MIX over all.
// No component dispatch, no header walking, predictions in locals, and
// all nibble-boundary hash-row probes issued back-to-back so their
// cache misses overlap (the interpreter issues them serially between
// component evaluations - the main stall on the decode side, which
// cannot prefetch the unknown next byte).  Arithmetic is bit-identical
// to Model; the interpreter remains the general path for foreign
// archives (tests cross-decode both ways and against the libzpaq
// oracle).

struct FastShape {
    bool ok = false;
    bool word = false;
    int nper = 0;
    bool per_isse = false;
    int bits[16] = {0};   // cp[1] per component
    int match_b2 = 0;     // MATCH cp[2] (history ring bits)
    int mix_rate = 24, mix_mask = 255;
    int n = 0;
};

// Parse a COMP section; shape.ok iff it is exactly a build_model()
// topology (so FastModelT's unrolled order applies).
static FastShape parse_fast_shape(const VM& z) {
    FastShape s;
    int n = z.header[6];
    const U8* cp = &z.header[7];
    const U8* ecp[16];
    if (n < 8 || n > 14) return s;
    for (int i = 0; i < n; i++) {
        ecp[i] = cp;
        if (cp[0] < 1 || cp[0] > 9) return s;
        cp += kCompSize[cp[0]];
    }
    if (ecp[0][0] != ICM) return s;
    s.bits[0] = ecp[0][1];
    for (int k = 1; k <= 5; k++) {
        if (ecp[k][0] != ISSE || ecp[k][2] != k - 1) return s;
        s.bits[k] = ecp[k][1];
    }
    if (ecp[6][0] != MATCH) return s;
    s.bits[6] = ecp[6][1];
    s.match_b2 = ecp[6][2];
    int i = 7;
    if (ecp[i][0] == ICM && i + 1 < n && ecp[i + 1][0] == ISSE
        && ecp[i + 1][2] == i) {
        // a leading ICM+ISSE pair is the word model; periodic pairs
        // follow (build_model emits word before periodic)
        s.word = true;
        s.bits[i] = ecp[i][1];
        s.bits[i + 1] = ecp[i + 1][1];
        i += 2;
    }
    while (i < n - 1) {
        if (ecp[i][0] != ICM || s.nper >= 2) return s;
        s.bits[i] = ecp[i][1];
        bool chained = i + 2 < n && ecp[i + 1][0] == ISSE
                       && ecp[i + 1][2] == i;
        if (s.nper == 0) s.per_isse = chained;
        else if (s.per_isse != chained) return s;
        if (chained) {
            s.bits[i + 1] = ecp[i + 1][1];
            i += 2;
        } else {
            i += 1;
        }
        s.nper++;
    }
    const U8* mx = ecp[n - 1];
    if (mx[0] != MIX || mx[1] != 16 || mx[2] != 0 || mx[3] != n - 1)
        return s;
    s.mix_rate = mx[4];
    s.mix_mask = mx[5];
    s.n = n;
    s.ok = true;
    return s;
}

// assembled by the model builder (defined with build_model below);
// FastModelT byte-compares the archive's HCOMP against it to decide
// whether the native hash routine may replace the ZPAQL interpreter
static std::vector<U8> build_hcomp(int n, int word, const int* periods,
                                   int nper, bool per_isse);

static inline size_t ffind(U8* ht, size_t mask16, int sizebits, U32 cxt) {
    // identical replacement policy to Model::find
    int chk = (cxt >> sizebits) & 255;
    size_t h0 = ((size_t)cxt * 16) & mask16;
    if (ht[h0] == chk) return h0;
    size_t h1 = h0 ^ 16;
    if (ht[h1] == chk) return h1;
    size_t h2 = h0 ^ 32;
    if (ht[h2] == chk) return h2;
    size_t hx;
    if (ht[h0 + 1] <= ht[h1 + 1] && ht[h0 + 1] <= ht[h2 + 1]) hx = h0;
    else if (ht[h1 + 1] < ht[h2 + 1]) hx = h1;
    else hx = h2;
    std::memset(&ht[hx], 0, 16);
    ht[hx] = (U8)chk;
    return hx;
}

template <bool WORD, int NPER, bool PER_ISSE>
struct FastModelT {
    static constexpr int NW = WORD ? 2 : 0;
    static constexpr int NP = NPER * (PER_ISSE ? 2 : 1);
    static constexpr int N = 7 + NW + NP + 1;   // + final MIX
    static constexpr int M = N - 1;             // mixer inputs

    VM& z;
    FastShape shape;
    int c8 = 1, hmap4 = 1;
    U32 hh[N];
    int p[N];

    std::vector<U8> ht[N];     // ICM/ISSE rows; [6] = MATCH history
    std::vector<U32> cmv[N];   // ICM cm / ISSE weights / MATCH heads
    size_t hmask16[N];         // ht.size() - 16 for ffind
    int sbits[N];              // cp[1] + 2 (ffind's chk shift)
    U32 irow[N];               // current nibble row (ICM/ISSE)
    U32 icxt[N];               // current bit-history state
    U32 ma = 0, mb = 0, mc = 0, mcxt = 0, mlimit = 0;   // MATCH
    size_t mhmask = 0, mcmask = 0;
    std::vector<int> mixw;
    U32 mixcxt = 0;
    bool fast_hc = false;   // native HCOMP (byte-verified against the
                            // archive's program)
    U32 wordh = 0;          // persistent word-hash slot (H[7])

    FastModelT(VM& zr, const FastShape& fs) : z(zr), shape(fs) {}
    bool is_modeled() const { return true; }

    // Native equivalent of build_model's HCOMP: ring-store the byte,
    // chained order-1..5 hashes into H[1..5], order-7 into H[6], the
    // case-folded word hash pair, and byte<<8 for the mixer context.
    // Used only when the archive's HCOMP bytes equal build_hcomp's.
    inline void run_hcomp(U32 ch) {
        VM& v = z;
        const size_t mm = v.m.size() - 1;
        v.c += 1;
        v.m[v.c & mm] = (U8)ch;
        U32 b = v.c;
        U32 a = (v.m[b & mm] + 512u) * 773u;
        hh[1] = a;
        for (int k = 2; k <= 5; k++) {
            b--;
            a = (a + v.m[b & mm] + 512u) * 773u;
            hh[k] = a;
        }
        b--;
        a = (a + v.m[b & mm] + 512u) * 773u;
        b--;
        a = (a + v.m[b & mm] + 512u) * 773u;
        hh[6] = a;
        if (WORD) {
            U32 x = ch & ~32u;
            if (x > 64 && x < 91) wordh = (wordh + x + 512u) * 773u;
            else wordh = 0;
            hh[7] = wordh;
            hh[8] = (wordh + v.m[(v.c - 1) & mm] + 512u) * 773u;
        }
        hh[N - 1] = ch << 8;
    }

    void init() {
        build_tables();
        z.init_h();
        c8 = 1;
        hmap4 = 1;
        for (int i = 0; i < N; i++) {
            hh[i] = 0;
            p[i] = 0;
            irow[i] = 0;
            icxt[i] = 0;
        }
        auto init_icm = [&](int i) {
            ht[i].assign((size_t)64 << shape.bits[i], 0);
            hmask16[i] = ht[i].size() - 16;
            sbits[i] = shape.bits[i] + 2;
            cmv[i].resize(256);
            for (int j = 0; j < 256; j++)
                cmv[i][j] = Model::st_cminit(j);
        };
        auto init_isse = [&](int i) {
            ht[i].assign((size_t)64 << shape.bits[i], 0);
            hmask16[i] = ht[i].size() - 16;
            sbits[i] = shape.bits[i] + 2;
            cmv[i].resize(512);
            for (int j = 0; j < 256; j++) {
                cmv[i][j * 2] = 1 << 15;
                cmv[i][j * 2 + 1] = (U32)clamp512k(
                    stretch(Model::st_cminit(j) >> 8) * 1024);
            }
        };
        init_icm(0);
        for (int k = 1; k <= 5; k++) init_isse(k);
        cmv[6].assign((size_t)1 << shape.bits[6], 0);
        ht[6].assign((size_t)1 << shape.match_b2, 0);
        ht[6][0] = 1;
        mhmask = ht[6].size() - 1;
        mcmask = cmv[6].size() - 1;
        ma = mb = mc = mcxt = mlimit = 0;
        if (WORD) {
            init_icm(7);
            init_isse(8);
        }
        for (int g = 0; g < NPER; g++) {
            int i = 7 + NW + g * (PER_ISSE ? 2 : 1);
            init_icm(i);
            if (PER_ISSE) init_isse(i + 1);
        }
        mixw.assign((size_t)65536 * M, 65536 / M);
        mixcxt = 0;
        wordh = 0;
        fast_hc = false;
        if (NPER == 0) {
            std::vector<U8> exp = build_hcomp(N, WORD ? 1 : 0, nullptr,
                                              0, false);
            int hlen = z.hend - z.hbegin - 1;  // minus the terminator
            fast_hc = (int)exp.size() == hlen
                      && std::memcmp(&z.header[z.hbegin], exp.data(),
                                     (size_t)hlen) == 0;
        }
    }

    inline void nibble_rows() {
        // all find() probe chains issued together: independent loads
        // overlap instead of serializing behind each component's ALU.
        // The h0 prefetch pass puts every table's (likely) line in
        // flight before any find's branches resolve.
        const U32 cc = 16 * (U32)c8;
        for (int i = 0; i < N - 1; i++) {
            if (i == 6) continue;
            __builtin_prefetch(
                &ht[i][((size_t)(hh[i] + cc) * 16) & hmask16[i]]);
        }
        irow[0] = (U32)ffind(ht[0].data(), hmask16[0], sbits[0],
                             hh[0] + cc);
        for (int k = 1; k <= 5; k++)
            irow[k] = (U32)ffind(ht[k].data(), hmask16[k], sbits[k],
                                 hh[k] + cc);
        if (WORD) {
            irow[7] = (U32)ffind(ht[7].data(), hmask16[7], sbits[7],
                                 hh[7] + cc);
            irow[8] = (U32)ffind(ht[8].data(), hmask16[8], sbits[8],
                                 hh[8] + cc);
        }
        for (int g = 0; g < NPER; g++) {
            int i = 7 + NW + g * (PER_ISSE ? 2 : 1);
            irow[i] = (U32)ffind(ht[i].data(), hmask16[i], sbits[i],
                                 hh[i] + cc);
            if (PER_ISSE)
                irow[i + 1] = (U32)ffind(ht[i + 1].data(),
                                         hmask16[i + 1], sbits[i + 1],
                                         hh[i + 1] + cc);
        }
    }

    inline int pred_icm(int i) {
        icxt[i] = ht[i][irow[i] + (hmap4 & 15)];
        return stretch((int)(cmv[i][icxt[i]] >> 8));
    }
    inline int pred_isse(int i, int pin) {
        icxt[i] = ht[i][irow[i] + (hmap4 & 15)];
        const int* wt = (const int*)&cmv[i][icxt[i] * 2];
        return clamp2k((wt[0] * pin + wt[1] * 64) >> 16);
    }
    inline void upd_icm(int i, int y) {
        ht[i][irow[i] + (hmap4 & 15)] =
            (U8)Model::st_next((int)icxt[i], y);
        U32& pn = cmv[i][icxt[i]];
        pn += (U32)((int)(y * 32767 - (int)(pn >> 8)) >> 2);
    }
    inline void upd_isse(int i, int pin, int y) {
        int err = y * 32767 - squash(p[i]);
        int* wt = (int*)&cmv[i][icxt[i] * 2];
        wt[0] = clamp512k(wt[0] + ((err * pin + (1 << 12)) >> 13));
        wt[1] = clamp512k(wt[1] + ((err + 16) >> 5));
        ht[i][irow[i] + (hmap4 & 15)] =
            (U8)Model::st_next((int)icxt[i], y);
    }

    int predict() {
        if (c8 == 1 || (c8 & 0xf0) == 16) nibble_rows();
        p[0] = pred_icm(0);
        for (int k = 1; k <= 5; k++) p[k] = pred_isse(k, p[k - 1]);
        if (ma == 0) {
            p[6] = 0;
        } else {
            mc = (ht[6][(mlimit - mb) & mhmask] >> (7 - mcxt)) & 1;
            p[6] = stretch((g_dt2k[ma] * ((int)mc * -2 + 1)) & 32767);
        }
        if (WORD) {
            p[7] = pred_icm(7);
            p[8] = pred_isse(8, p[7]);
        }
        for (int g = 0; g < NPER; g++) {
            int i = 7 + NW + g * (PER_ISSE ? 2 : 1);
            p[i] = pred_icm(i);
            if (PER_ISSE) p[i + 1] = pred_isse(i + 1, p[i]);
        }
        mixcxt = (hh[N - 1] + ((U32)c8 & (U32)shape.mix_mask)) & 65535;
        const int* wt = &mixw[(size_t)mixcxt * M];
        int s = 0;
        for (int j = 0; j < M; j++) s += (wt[j] >> 8) * p[j];
        p[N - 1] = clamp2k(s >> 8);
        return squash(p[N - 1]);
    }

    void update(int y) {
        upd_icm(0, y);
        for (int k = 1; k <= 5; k++) upd_isse(k, p[k - 1], y);
        // MATCH (identical to Model's)
        if ((int)mc != y) ma = 0;
        {
            U8& hb = ht[6][mlimit & mhmask];
            hb = (U8)(hb * 2 + y);
        }
        if (++mcxt == 8) {
            mcxt = 0;
            ++mlimit;
            mlimit &= (U32)mhmask;
            if (ma == 0) {
                mb = mlimit - cmv[6][hh[6] & mcmask];
                if (mb & mhmask)
                    while (ma < 255
                           && ht[6][(mlimit - ma - 1) & mhmask]
                              == ht[6][(mlimit - ma - mb - 1) & mhmask])
                        ++ma;
            } else {
                ma += ma < 255;
            }
            cmv[6][hh[6] & mcmask] = mlimit;
        }
        if (WORD) {
            upd_icm(7, y);
            upd_isse(8, p[7], y);
        }
        for (int g = 0; g < NPER; g++) {
            int i = 7 + NW + g * (PER_ISSE ? 2 : 1);
            upd_icm(i, y);
            if (PER_ISSE) upd_isse(i + 1, p[i], y);
        }
        {
            int err = (y * 32767 - squash(p[N - 1])) * shape.mix_rate
                      >> 4;
            int* wt = &mixw[(size_t)mixcxt * M];
            for (int j = 0; j < M; j++)
                wt[j] = clamp512k(
                    wt[j] + ((err * p[j] + (1 << 12)) >> 13));
        }
        c8 += c8 + y;
        if (c8 >= 256) {
            if (fast_hc) {
                run_hcomp((U32)(c8 - 256));
            } else {
                z.run(c8 - 256);
                for (int i = 0; i < N; i++) hh[i] = z.H(i);
            }
            hmap4 = 1;
            c8 = 1;
        } else if (c8 >= 16 && c8 < 32) {
            hmap4 = (hmap4 & 0xf) << 5 | y << 4 | 1;
        } else {
            hmap4 = (hmap4 & 0x1f0) | (((hmap4 & 0xf) * 2 + y) & 0xf);
        }
    }

    // Encode-side: the byte is known before its bits are coded, so
    // both nibbles' rows can start loading now (Model::prefetch_byte)
    void prefetch_byte(int ch) {
        const U32 c8a = 16, c8b = 16 * (U32)(16 + (ch >> 4));
        auto pf = [&](int i) {
            for (U32 cc : {c8a, c8b}) {
                size_t h0 = ((size_t)(hh[i] + cc) * 16) & hmask16[i];
                __builtin_prefetch(&ht[i][h0]);
                __builtin_prefetch(&ht[i][h0 ^ 16]);
                __builtin_prefetch(&ht[i][h0 ^ 32]);
            }
        };
        pf(0);
        for (int k = 1; k <= 5; k++) pf(k);
        if (WORD) {
            pf(7);
            pf(8);
        }
        for (int g = 0; g < NPER; g++) {
            int i = 7 + NW + g * (PER_ISSE ? 2 : 1);
            pf(i);
            if (PER_ISSE) pf(i + 1);
        }
        __builtin_prefetch(&cmv[6][hh[6] & mcmask]);
        __builtin_prefetch(&ht[6][(mlimit - mb) & mhmask]);
    }
};

template <class PRED = Model>
struct RangeDecoder {
    Source* in = nullptr;
    U32 low = 1, high = 0xFFFFFFFF, curr = 0;
    PRED* pr = nullptr;

    void init(bool modeled) {
        if (modeled) { low = 1; high = 0xFFFFFFFF; curr = 0; }
        else low = high = curr = 0;
    }

    int decode(int p) {
        if (curr < low || curr > high) throw Err("archive corrupted");
        U32 mid = low + (U32)(((U64)(high - low) * (U32)p) >> 16);
        // branchless select: y is entropy by construction, so the
        // branch form mispredicts ~half the time
        int y = curr <= mid;
        U32 m1 = (U32)-y;
        high = (high & ~m1) | (mid & m1);
        low = (low & m1) | ((mid + 1) & ~m1);
        while ((high ^ low) < 0x1000000) {
            high = high << 8 | 255;
            low = low << 8;
            low += (low == 0);
            int ch = in->get();
            if (ch < 0) throw Err("unexpected EOF");
            curr = curr << 8 | ch;
        }
        return y;
    }

    int decompress() {
        if (pr->is_modeled()) {
            if (curr == 0)
                for (int i = 0; i < 4; i++)
                    curr = curr << 8 | (in->get() & 255);
            if (decode(0)) {
                if (curr != 0) throw Err("decoding end of stream");
                return -1;
            }
            int ch = 1;
            while (ch < 256) {
                int p = pr->predict() * 2 + 1;
                ch += ch + decode(p);
                pr->update(ch & 1);
            }
            return ch - 256;
        }
        // stored mode: 4-byte count then raw bytes
        if (curr == 0) {
            for (int i = 0; i < 4; i++) curr = curr << 8 | (in->get() & 255);
            if (curr == 0) return -1;
        }
        --curr;
        return in->get();
    }
};

template <class PRED = Model>
struct RangeEncoder {
    Sink* out = nullptr;
    U32 low = 1, high = 0xFFFFFFFF;
    PRED* pr = nullptr;

    void init() { low = 1; high = 0xFFFFFFFF; pr->init(); }

    void encode(int y, int p) {
        U32 mid = low + (U32)(((U64)(high - low) * (U32)p) >> 16);
        U32 m1 = (U32)-(y != 0);
        high = (high & ~m1) | (mid & m1);
        low = (low & m1) | ((mid + 1) & ~m1);
        while ((high ^ low) < 0x1000000) {
            out->put(high >> 24);
            high = high << 8 | 255;
            low = low << 8;
            low += (low == 0);
        }
    }

    void compress(int ch) {
        if (ch == -1) { encode(1, 0); return; }
        pr->prefetch_byte(ch);
        encode(0, 0);
        for (int i = 7; i >= 0; --i) {
            int p = pr->predict() * 2 + 1;
            int y = (ch >> i) & 1;
            encode(y, p);
            pr->update(y);
        }
    }

};

// ------------------------------------- small-chain evaluator ----------
// Specialized predictor for the 2-3 component ICM -> ISSE chains the
// LZ77 token models and the BWT method use ({ICM s; ISSE s' 0 [; ISSE
// s'' 1]}, final component's prediction, no mixer).  Same arithmetic
// as Model, without per-bit header walking; ~3x the generic
// interpreter's speed (the libzpaq-JIT analog for the small shapes,
// complementing FastModelT's big-CM coverage).

struct SmallShape {
    int nc = 0;          // 0 = not a small chain; else 2 or 3
    int bits[3] = {0};
};

static SmallShape parse_small_chain(const VM& z) {
    SmallShape s;
    int n = z.header[6];
    if (n != 2 && n != 3) return s;
    const U8* cp = &z.header[7];
    if (cp[0] != ICM) return s;
    s.bits[0] = cp[1];
    cp += kCompSize[ICM];
    if (cp[0] != ISSE || cp[2] != 0) return s;
    s.bits[1] = cp[1];
    cp += kCompSize[ISSE];
    if (n == 3) {
        if (cp[0] != ISSE || cp[2] != 1) return s;
        s.bits[2] = cp[1];
    }
    s.nc = n;
    return s;
}

template <int NC>
struct SmallChainT {
    VM& z;
    SmallShape shape;
    int c8 = 1, hmap4 = 1;
    U32 hh[NC];
    int p[NC];
    std::vector<U8> ht[NC];
    std::vector<U32> cmv[NC];
    size_t hmask16[NC];
    int sbits[NC];
    U32 irow[NC], icxt[NC];
    bool fast_hc = false;

    SmallChainT(VM& zr, const SmallShape& fs) : z(zr), shape(fs) {}
    bool is_modeled() const { return true; }

    void init() {
        build_tables();
        z.init_h();
        c8 = 1;
        hmap4 = 1;
        for (int i = 0; i < NC; i++) { hh[i] = 0; p[i] = 0; }
        auto init_icm = [&](int i) {
            ht[i].assign((size_t)64 << shape.bits[i], 0);
            hmask16[i] = ht[i].size() - 16;
            sbits[i] = shape.bits[i] + 2;
            cmv[i].resize(256);
            for (int j = 0; j < 256; j++)
                cmv[i][j] = Model::st_cminit(j);
        };
        auto init_isse = [&](int i) {
            ht[i].assign((size_t)64 << shape.bits[i], 0);
            hmask16[i] = ht[i].size() - 16;
            sbits[i] = shape.bits[i] + 2;
            cmv[i].resize(512);
            for (int j = 0; j < 256; j++) {
                cmv[i][j * 2] = 1 << 15;
                cmv[i][j * 2 + 1] = (U32)clamp512k(
                    stretch(Model::st_cminit(j) >> 8) * 1024);
            }
        };
        init_icm(0);
        for (int k = 1; k < NC; k++) init_isse(k);
        // native HCOMP only when the program is exactly the chained
        // order-1..NC hash the encoders emit
        static const U8 hc2[] = {17, 104, 74, 4, 95, 0, 59, 112,
                                 10, 25, 59, 112, 56};
        static const U8 hc3[] = {17, 104, 74, 4, 95, 0, 59, 112,
                                 10, 25, 59, 112, 10, 25, 59, 112, 56};
        const U8* exp = NC == 2 ? hc2 : hc3;
        int elen = NC == 2 ? (int)sizeof hc2 : (int)sizeof hc3;
        int hlen = z.hend - z.hbegin - 1;
        fast_hc = hlen == elen
                  && std::memcmp(&z.header[z.hbegin], exp,
                                 (size_t)elen) == 0;
    }

    inline void nibble_rows() {
        const U32 cc = 16 * (U32)c8;
        for (int i = 0; i < NC; i++)
            __builtin_prefetch(
                &ht[i][((size_t)(hh[i] + cc) * 16) & hmask16[i]]);
        for (int i = 0; i < NC; i++)
            irow[i] = (U32)ffind(ht[i].data(), hmask16[i], sbits[i],
                                 hh[i] + cc);
    }

    int predict() {
        if (c8 == 1 || (c8 & 0xf0) == 16) nibble_rows();
        icxt[0] = ht[0][irow[0] + (hmap4 & 15)];
        p[0] = stretch((int)(cmv[0][icxt[0]] >> 8));
        for (int k = 1; k < NC; k++) {
            icxt[k] = ht[k][irow[k] + (hmap4 & 15)];
            const int* wt = (const int*)&cmv[k][icxt[k] * 2];
            p[k] = clamp2k((wt[0] * p[k - 1] + wt[1] * 64) >> 16);
        }
        return squash(p[NC - 1]);
    }

    void update(int y) {
        {
            ht[0][irow[0] + (hmap4 & 15)] =
                (U8)Model::st_next((int)icxt[0], y);
            U32& pn = cmv[0][icxt[0]];
            pn += (U32)((int)(y * 32767 - (int)(pn >> 8)) >> 2);
        }
        for (int k = 1; k < NC; k++) {
            int err = y * 32767 - squash(p[k]);
            int* wt = (int*)&cmv[k][icxt[k] * 2];
            wt[0] = clamp512k(wt[0] + ((err * p[k - 1] + (1 << 12))
                                       >> 13));
            wt[1] = clamp512k(wt[1] + ((err + 16) >> 5));
            ht[k][irow[k] + (hmap4 & 15)] =
                (U8)Model::st_next((int)icxt[k], y);
        }
        c8 += c8 + y;
        if (c8 >= 256) {
            if (fast_hc) {
                VM& v = z;
                const size_t mm = v.m.size() - 1;
                v.c += 1;
                v.m[v.c & mm] = (U8)(c8 - 256);
                U32 b = v.c;
                U32 a = (v.m[b & mm] + 512u) * 773u;
                hh[0] = a;
                for (int k = 1; k < NC; k++) {
                    b--;
                    a = (a + v.m[b & mm] + 512u) * 773u;
                    hh[k] = a;
                }
            } else {
                z.run(c8 - 256);
                for (int i = 0; i < NC; i++) hh[i] = z.H(i);
            }
            hmap4 = 1;
            c8 = 1;
        } else if (c8 >= 16 && c8 < 32) {
            hmap4 = (hmap4 & 0xf) << 5 | y << 4 | 1;
        } else {
            hmap4 = (hmap4 & 0x1f0) | (((hmap4 & 0xf) * 2 + y) & 0xf);
        }
    }

    void prefetch_byte(int ch) {
        const U32 c8a = 16, c8b = 16 * (U32)(16 + (ch >> 4));
        for (int i = 0; i < NC; i++) {
            for (U32 cc : {c8a, c8b}) {
                size_t h0 = ((size_t)(hh[i] + cc) * 16) & hmask16[i];
                __builtin_prefetch(&ht[i][h0]);
                __builtin_prefetch(&ht[i][h0 ^ 16]);
                __builtin_prefetch(&ht[i][h0 ^ 32]);
            }
        }
    }
};

// -------------------------------------------- LZ77 PCOMP program ------
//
// The fast-mode encoder (levels 1-2, mirroring libzpaq's LZ77-based low
// methods, reference libzpaq.cpp:7545-7731) emits its own byte-aligned
// LZ77 token stream plus a from-scratch ZPAQL *postprocessor program*
// that inverts it, so any conforming ZPAQ decoder - the reference's
// included - reconstructs the data by running the embedded bytecode.
//
// Token format (this implementation's own):
//   0x00 len[3 LE]            literal run, `len` raw bytes follow
//   0x01 len[3 LE] off[4 LE]  match: copy len bytes from `off` back
//
// The PCOMP program is a 12-state byte machine: H[0]=state, H[1]=count,
// H[2]=offset, H[3]=byte temp; B = write cursor into the M ring.

struct PAsm {
    std::vector<U8> code;
    std::vector<int> labels;                      // id -> position
    std::vector<std::pair<size_t, int>> frel;     // short-jump operand
    std::vector<std::pair<size_t, int>> fabs;     // LJ low-byte position

    int newlabel() { labels.push_back(-1); return (int)labels.size() - 1; }
    void place(int l) { labels[l] = (int)code.size(); }
    void op(int o) { code.push_back((U8)o); }
    void opi(int o, int n) {
        code.push_back((U8)o);
        code.push_back((U8)n);
    }
    // short relative jump (JT=39, JF=47, JMP=63): range -127..+128
    void jrel(int o, int l) {
        code.push_back((U8)o);
        frel.push_back({code.size(), l});
        code.push_back(0);
    }
    // conditional far jump: inverted short jump over a 3-byte LJ
    void jfar(int cond, int l) {
        int inv = (cond == 39) ? 47 : 39;
        code.push_back((U8)inv);
        code.push_back(3);  // skip the LJ (target = operand pos + 4)
        code.push_back(255);
        fabs.push_back({code.size(), l});
        code.push_back(0);
        code.push_back(0);
    }
    void finish() {
        for (auto& f : frel) {
            int delta = labels[f.second] - (int)f.first;
            if (delta < -127 || delta > 128) throw Err("jump out of range");
            code[f.first] = (U8)((delta - 1) & 255);
        }
        for (auto& f : fabs) {
            int t = labels[f.second];
            code[f.first] = (U8)(t & 255);
            code[f.first + 1] = (U8)(t >> 8);
        }
    }
};

static std::vector<U8> build_lz_pcomp() {
    PAsm a;
    int S[12];
    for (int i = 0; i < 12; i++) S[i] = a.newlabel();
    int COPY = a.newlabel(), SET0 = a.newlabel(), DONE = a.newlabel();
    int TO1 = a.newlabel();

    // prologue: EOS check, stash byte in H[3], dispatch on H[0]
    a.opi(239, 255);          // A> 255 ?  (EOS sentinel 0xFFFFFFFF)
    a.jfar(39, DONE);
    a.opi(95, 3); a.op(112);  // D=3; *D=A      (H[3] = input byte)
    a.opi(95, 0); a.op(70);   // D=0; A=*D      (A = state)
    for (int s = 0; s <= 10; s++) {
        a.opi(223, s);        // A== s ?
        a.jfar(39, S[s]);
    }
    // fall through = state 11: last offset byte, then the copy loop
    a.place(S[11]);
    a.opi(95, 3); a.op(70); a.opi(207, 24);       // A = byte << 24
    a.opi(95, 2); a.op(134); a.op(112);           // H[2] += A (full off)
    a.op(65); a.op(142); a.op(80);                // A=B; A-=H[2]; C=A
    a.opi(95, 1);                                 // D=1 (count)
    a.place(COPY);
    a.op(69); a.op(96); a.op(57);                 // A=*C; *B=A; OUT
    a.op(9); a.op(17);                            // B++; C++
    a.op(70); a.op(2); a.op(112);                 // A=H[1]; A--; H[1]=A
    a.opi(223, 0);                                // A== 0 ?
    a.jrel(47, COPY);                             // JF -> copy more
    a.jrel(63, SET0);

    // state 0: command byte (0 = literal run, else match)
    a.place(S[0]);
    a.opi(95, 3); a.op(70);
    a.opi(223, 0);
    a.jrel(39, TO1);
    a.opi(71, 5); a.opi(95, 0); a.op(112); a.op(56);  // state=5; halt
    a.place(TO1);
    a.opi(71, 1); a.opi(95, 0); a.op(112); a.op(56);  // state=1; halt

    // states 1-3 / 5-7: little-endian length into H[1]; 8-10: offset
    // low/mid bytes into H[2]
    struct Acc { int st, var, shift, next; };
    const Acc accs[] = {
        {1, 1, 0, 2},  {2, 1, 8, 3},  {3, 1, 16, 4},
        {5, 1, 0, 6},  {6, 1, 8, 7},  {7, 1, 16, 8},
        {8, 2, 0, 9},  {9, 2, 8, 10}, {10, 2, 16, 11},
    };
    // state 4 first (literal copy), so its short jumps stay in range
    a.place(S[4]);
    a.opi(95, 3); a.op(70);                       // A = byte
    a.op(96); a.op(57); a.op(9);                  // *B=A; OUT; B++
    a.opi(95, 1); a.op(70); a.op(2); a.op(112);   // H[1]--
    a.opi(223, 0);
    a.jrel(47, DONE);                             // count left: stay in 4
    a.place(SET0);
    a.op(4); a.opi(95, 0); a.op(112);             // state = 0
    a.place(DONE);
    a.op(56);                                     // HALT
    for (const Acc& x : accs) {
        a.place(S[x.st]);
        a.opi(95, 3); a.op(70);                   // A = byte
        if (x.shift) {
            a.opi(207, x.shift);                  // A <<= shift
            a.opi(95, x.var); a.op(134);          // A += H[var]
        } else {
            a.opi(95, x.var);
        }
        a.op(112);                                // H[var] = A
        a.opi(71, x.next); a.opi(95, 0); a.op(112); a.op(56);
    }
    a.finish();
    return a.code;
}

static const std::vector<U8>& lz_prog() {
    static const std::vector<U8> p = build_lz_pcomp();
    return p;
}

// ------------------------------------------- E8E9 exe precoder --------
//
// x86 content precoder (the reference's libzpaq picks an E8E9
// transform for exe-type input, libzpaq.cpp:7545-7731 via
// src/stream.c:304-309).  This implementation's own transform: at each
// 0xE8/0xE9 opcode with 4 following bytes, the little-endian 32-bit
// field gains the opcode's block offset (rel->abs); the embedded PCOMP
// program below undoes it on any conforming ZPAQ decoder.  Scanning
// skips the rewritten field, so encode and decode agree on which bytes
// are opcodes.
//
// PCOMP state: H[0] = collect state (0 = normal, s in 1..4 = opcode
// seen, s-1 field bytes pending), H[1] = opcode position, H[2..5] =
// pending field bytes; B counts output bytes (positions).

static std::vector<U8> build_e8e9_pcomp() {
    PAsm a;
    int EOS = a.newlabel(), NORMAL = a.newlabel(), STST = a.newlabel();
    int BEGIN = a.newlabel(), FLUSH = a.newlabel(), FIN = a.newlabel();

    a.opi(239, 255); a.jfar(39, EOS);    // A> 255 ? -> end of segment
    a.op(80);                            // C=A (input byte)
    a.opi(95, 0); a.op(70);              // D=0; A=*D  (state)
    a.opi(223, 0); a.jfar(39, NORMAL);
    // collecting field bytes: state s in 1..4
    a.opi(135, 1);                       // A+=1 (new state, 2..5)
    a.op(88);                            // D=A
    a.op(114);                           // *D=C  (H[2..5] = byte)
    a.opi(223, 5); a.jfar(47, STST);
    // 4th field byte stored: w' = H[2..5] LE; emit LE(w' - p0)
    a.opi(95, 5); a.op(70);              // A=H[5]
    a.opi(207, 8); a.opi(95, 4); a.op(134);
    a.opi(207, 8); a.opi(95, 3); a.op(134);
    a.opi(207, 8); a.opi(95, 2); a.op(134);
    a.opi(95, 1); a.op(142);             // A -= H[1] (opcode position)
    a.op(80);                            // C = w
    a.opi(175, 255); a.op(57); a.op(9);  // OUT w&255; B++
    a.op(66); a.opi(215, 8); a.opi(175, 255); a.op(57); a.op(9);
    a.op(66); a.opi(215, 16); a.opi(175, 255); a.op(57); a.op(9);
    a.op(66); a.opi(215, 24); a.op(57); a.op(9);
    a.op(4);                             // A=0 (back to normal)
    a.place(STST);
    a.opi(95, 0); a.op(112); a.op(56);   // H[0]=A; HALT
    a.place(NORMAL);
    a.op(66); a.op(57); a.op(9);         // A=C; OUT; B++
    a.opi(223, 0xE8); a.jrel(39, BEGIN);
    a.opi(223, 0xE9); a.jrel(39, BEGIN);
    a.op(56);
    a.place(BEGIN);
    a.op(65); a.opi(143, 1);             // A = B-1 (opcode position)
    a.opi(95, 1); a.op(112);             // H[1] = A
    a.opi(71, 1); a.opi(95, 0); a.op(112); a.op(56);  // state=1
    a.place(EOS);
    // flush pending bytes raw (opcode was within 4 bytes of the end,
    // which the encoder never transforms)
    a.opi(95, 0); a.op(70);
    a.opi(223, 0); a.jfar(39, FIN);
    a.opi(143, 1);                       // pending count = state-1
    a.opi(223, 0); a.jfar(39, FIN);
    a.op(80);                            // C = count
    a.opi(95, 2);                        // D = 2
    a.place(FLUSH);
    a.op(70); a.op(57); a.op(9);         // A=*D; OUT; B++
    a.op(25);                            // D++
    a.op(66); a.opi(143, 1); a.op(80);   // C--
    a.opi(223, 0); a.jrel(47, FLUSH);
    a.place(FIN);
    a.op(56);
    a.finish();
    return a.code;
}

static const std::vector<U8>& e8e9_prog() {
    static const std::vector<U8> p = build_e8e9_pcomp();
    return p;
}

// ------------------------------------------- BWT method --------------
//
// High-redundancy binary arm (the reference's libzpaq mid methods use
// a BWT pre-coder for such types, libzpaq.cpp:7545-7731): blocks are
// BWT'd with this runtime's SA-IS (csrc/bwt.cpp), modeled with a small
// ICM/ISSE chain, and carry a from-scratch ZPAQL PCOMP that inverts
// the BWT on any conforming decoder.
//
// Decoded-stream layout per block: [bwt bytes (n)] [primary row q, LE4].
// PCOMP memory: M[0..n+4) buffers the stream (pm sized to the block);
// H holds bucket counts at [0..257], the mask constant at [0], and the
// packed psi links at [259..259+n]: H[lf(i)+259] = (i+259) | (col(i)-1
// << 24), so the forward psi walk outputs bytes in order with one
// fetch per byte.  Scalars live in R0 (n) and R1 (q).

extern "C" int32_t lrz_bwt_forward(const uint8_t* in, uint8_t* out,
                                   int32_t n);
extern "C" void lrz_bwt_inverse(const uint8_t* bwt, uint8_t* out,
                                int32_t n, int32_t q);

static std::vector<U8> build_bwt_pcomp() {
    PAsm a;
    int EOS = a.newlabel(), FIN = a.newlabel();
    int Z1 = a.newlabel(), P2 = a.newlabel(), P2T = a.newlabel();
    int P3 = a.newlabel(), P3T = a.newlabel();
    int P4 = a.newlabel(), P4T = a.newlabel(), SENT = a.newlabel();
    int P4J = a.newlabel(), P5 = a.newlabel(), W1 = a.newlabel();

    // normal phase: buffer the byte
    a.opi(239, 255); a.jfar(39, EOS);    // A> 255 ? -> EOS
    a.op(96); a.op(9); a.op(56);         // *B=A; B++; HALT

    a.place(EOS);
    // R0 = n = B - 4;  stop on empty segment
    a.op(65); a.opi(143, 4); a.opi(55, 0);   // A=B-4; R0=A
    a.opi(223, 0); a.jfar(39, FIN);
    // R1 = q = LE32 at M[n..n+4)
    a.opi(135, 3); a.op(72);             // B = n+3
    a.op(68); a.op(80);                  // A=*B; C=A
    for (int k = 0; k < 3; k++) {
        a.op(10);                        // B--
        a.op(66); a.opi(207, 8);         // A=C; A<<=8
        a.op(132); a.op(80);             // A+=*B; C=A
    }
    a.op(66); a.opi(55, 1);              // R1 = q

    // zero bucket counts H[0..257]
    a.op(28);                            // D=0
    a.opi(71, 255); a.opi(135, 3); a.op(80);  // C = 258
    a.place(Z1);
    a.op(52); a.op(25);                  // H(d)=0; D++
    a.op(66); a.opi(143, 1); a.op(80);   // C--
    a.opi(223, 0); a.jrel(47, Z1);

    // count pass: for w in 0..n: ++H[M[w]+1]; plus one sentinel
    a.op(12);                            // B = 0 (w)
    a.place(P2);
    a.opi(7, 0); a.op(217); a.jfar(39, P2T);  // A=R0; A==B ? done
    a.op(68); a.opi(135, 1); a.op(88);   // D = M[w]+1
    a.op(49); a.op(9);                   // ++H(d); w++
    a.jrel(63, P2);
    a.place(P2T);
    a.op(28); a.op(49);                  // ++H[0] (sentinel)

    // exclusive prefix over H[0..257]: C = running
    a.op(20); a.op(28);                  // C=0; D=0
    a.place(P3);
    a.op(70); a.op(72);                  // A=*D; B=A (tmp)
    a.op(66); a.op(112);                 // A=C; H(d)=A
    a.op(129); a.op(80);                 // A+=B; C=A
    a.op(25);                            // D++
    a.op(67); a.opi(143, 3); a.opi(223, 255); a.jrel(47, P3);  // D==258?
    a.place(P3T);

    // scatter pass: rows i = B in 0..n, w = C
    a.op(12); a.op(20);                  // B = 0 (i), C = 0 (w)
    a.place(P4);
    a.opi(7, 0); a.opi(135, 1); a.op(217);   // A=R0+1; A==B ?
    a.jfar(39, P5);
    a.opi(7, 1); a.op(217); a.jfar(39, SENT);  // i == q ?
    // normal row: c-cell = M[w]+1; j = H[c]++; H[j+259] = packed
    a.op(69); a.opi(135, 1); a.op(88);   // D = M[w]+1
    a.op(70); a.op(49);                  // A = j = H(d); ++H(d)
    a.opi(135, 255); a.opi(135, 4);      // A = j + 259
    a.op(88);                            // D = target
    a.op(69);                            // A = M[w]  (byte = col-1)
    a.op(17);                            // w++
    a.opi(207, 24);                      // A <<= 24
    a.op(129); a.opi(135, 255); a.opi(135, 4);  // A += i + 259
    a.op(112);                           // H(d) = packed
    a.jrel(63, P4J);
    a.place(SENT);                       // sentinel row: c-cell 0
    a.op(28);                            // D = 0
    a.op(70); a.op(49);                  // j = H[0]; ++H[0]
    a.opi(135, 255); a.opi(135, 4); a.op(88);   // D = j + 259
    a.op(65); a.opi(135, 255); a.opi(135, 4);   // A = i + 259
    a.op(112);                           // H(d) = packed (byte 0)
    a.place(P4J);
    a.op(9);                             // i++
    a.jrel(63, P4);
    a.place(P4T);

    // walk: H[0] = mask; p = H[259] & mask; n outputs
    a.place(P5);
    a.opi(71, 1); a.opi(207, 24); a.opi(143, 1);  // A = 2^24 - 1
    a.op(28); a.op(112);                 // H[0] = mask
    a.opi(7, 0); a.op(80);               // C = n (countdown)
    a.opi(71, 255); a.opi(135, 4); a.op(88);      // D = 259
    a.op(70);                            // A = H[259] (psi(0) packed)
    a.op(28); a.op(174);                 // A &= H[0]
    a.op(88);                            // D = p
    a.place(W1);
    a.op(70); a.op(72);                  // A = packed; B = A
    a.opi(215, 24); a.op(57);            // OUT (packed >> 24)
    a.op(65); a.op(28); a.op(174);       // A = B & mask
    a.op(88);                            // D = next p
    a.op(66); a.opi(143, 1); a.op(80);   // C--
    a.opi(223, 0); a.jrel(47, W1);
    a.place(FIN);
    a.op(56);                            // HALT
    a.finish();
    return a.code;
}

static const std::vector<U8>& bwt_prog() {
    static const std::vector<U8> p = build_bwt_pcomp();
    return p;
}

// forward transform, in place, offsets relative to the block start
static void e8e9_fwd(U8* p, int64_t n) {
    for (int64_t i = 0; i + 4 < n;) {
        if (p[i] == 0xE8 || p[i] == 0xE9) {
            U32 w = (U32)p[i + 1] | ((U32)p[i + 2] << 8)
                    | ((U32)p[i + 3] << 16) | ((U32)p[i + 4] << 24);
            w += (U32)i;
            p[i + 1] = (U8)w;
            p[i + 2] = (U8)(w >> 8);
            p[i + 3] = (U8)(w >> 16);
            p[i + 4] = (U8)(w >> 24);
            i += 5;
        } else {
            i++;
        }
    }
}

// text detection: mostly printable ASCII + whitespace.  Replaces the
// redundancy>192 inference (which misreads highly-redundant binary as
// text and picks the word model / blocks the BWT arm).
static bool looks_text(const U8* p, int64_t n) {
    int64_t m = n < (1 << 20) ? n : (1 << 20);
    if (m == 0) return false;
    int64_t cnt = 0;
    for (int64_t i = 0; i < m; i++) {
        U8 c = p[i];
        if (c == 9 || c == 10 || c == 13 || (c >= 32 && c < 127)) cnt++;
    }
    return cnt * 10 >= m * 9;
}

// x86 detection: call/jump opcodes whose rel32 upper byte is a sign
// extension occur far more often in machine code than anywhere else
// (the reference's exe-type detection role, libzpaq.cpp:7561-7580)
static bool looks_x86(const U8* p, int64_t n) {
    int64_t m = n < (1 << 20) ? n : (1 << 20);
    if (m < 4096) return false;
    int64_t hits = 0;
    for (int64_t i = 0; i + 4 < m; i++) {
        if ((p[i] == 0xE8 || p[i] == 0xE9)
            && (p[i + 4] == 0x00 || p[i + 4] == 0xFF))
            hits++;
    }
    return hits * 512 >= m;
}

// ------------------------------------------------- LZ77 tokenizer -----

static void lz77_tokens(const U8* in, int64_t n, std::vector<U8>& out,
                        int depth) {
    const int64_t MINM = 16;
    const int HB = 17;
    auto emit_lits = [&](int64_t from, int64_t to) {
        while (from < to) {
            int64_t L = to - from;
            if (L > 0xFFFFFF) L = 0xFFFFFF;
            out.push_back(0);
            out.push_back((U8)L);
            out.push_back((U8)(L >> 8));
            out.push_back((U8)(L >> 16));
            out.insert(out.end(), in + from, in + from + L);
            from += L;
        }
    };
    if (n < MINM + 8) { emit_lits(0, n); return; }
    std::vector<int32_t> head((size_t)1 << HB, -1);
    std::vector<int32_t> prev;
    if (depth > 1) prev.assign((size_t)n, -1);
    auto hash8 = [&](int64_t i) -> U32 {
        U64 x;
        std::memcpy(&x, in + i, 8);
        return (U32)((x * 0x9E3779B185EBCA87ULL) >> (64 - HB));
    };
    int64_t i = 0, lit = 0;
    const int64_t limit = n - 8;
    while (i <= limit) {
        U32 h = hash8(i);
        int32_t j = head[h];
        if (depth > 1) prev[(size_t)i] = j;
        head[h] = (int32_t)i;
        int64_t blen = 0, boff = 0;
        for (int d = depth; j >= 0 && d > 0; --d) {
            const U8* p = in + j;
            const U8* q = in + i;
            const int64_t maxl = n - i;
            int64_t l = 0;
            while (l + 8 <= maxl) {
                U64 x, y;
                std::memcpy(&x, p + l, 8);
                std::memcpy(&y, q + l, 8);
                if (x != y) {
                    l += __builtin_ctzll(x ^ y) >> 3;
                    break;
                }
                l += 8;
            }
            if (l + 8 > maxl)
                while (l < maxl && p[l] == q[l]) l++;
            if (l > blen) { blen = l; boff = i - j; }
            j = depth > 1 ? prev[(size_t)j] : -1;
        }
        if (blen >= MINM) {
            emit_lits(lit, i);
            int64_t L = blen > 0xFFFFFF ? 0xFFFFFF : blen;
            out.push_back(1);
            out.push_back((U8)L);
            out.push_back((U8)(L >> 8));
            out.push_back((U8)(L >> 16));
            out.push_back((U8)boff);
            out.push_back((U8)(boff >> 8));
            out.push_back((U8)(boff >> 16));
            out.push_back((U8)(boff >> 24));
            const int64_t end = i + L;
            const int64_t step = L > 4096 ? 61 : (L > 256 ? 7 : 1);
            for (int64_t k = i + 1; k < end && k <= limit; k += step) {
                U32 h2 = hash8(k);
                if (depth > 1) prev[(size_t)k] = head[h2];
                head[h2] = (int32_t)k;
            }
            i = end;
            lit = end;
        } else {
            i++;
        }
    }
    emit_lits(lit, n);
}

// -------------------------------------------------- decompresser ------

static const U8 kTag[13] = {0x37, 0x6b, 0x53, 0x74, 0xa0, 0x31, 0x83,
                            0xd3, 0x8c, 0xb2, 0x28, 0xb0, 0xd3};

// PCOMP loader/driver: PASS or PROG psize[2] pcomp..., then data
struct PostProc {
    int state = 0;  // 0 init, 1 pass, 2..4 loading, 5 run
    int psize = 0;
    VM z;
    // native fast path for this implementation's own LZ77 program: when
    // the loaded PCOMP bytecode equals build_lz_pcomp()'s, run the same
    // state machine natively instead of interpreting it (identical
    // semantics; LRZ_ZPAQ_FORCE_VM=1 pins the VM for tests)
    bool fast = false;
    int fstate = 0;
    U32 flen = 0, foff = 0;
    // native fast path for this implementation's own inverse-BWT
    // program (build_bwt_pcomp): buffer the segment, invert natively
    bool bwt_fast = false;
    std::vector<U8> bwt_buf;

    void init(int ph, int pm) {
        state = 0;
        psize = 0;
        fast = false;
        fstate = 0;
        flen = foff = 0;
        bwt_fast = false;
        bwt_buf.clear();
        z.clear();
        z.header.assign(300, 0);
        z.header[4] = (U8)ph;
        z.header[5] = (U8)pm;
    }

    void bwt_write(int ch, Sink& sink) {
        if (ch >= 0) {
            bwt_buf.push_back((U8)ch);
            return;
        }
        if (bwt_buf.size() < 4) { bwt_buf.clear(); return; }
        int64_t n = (int64_t)bwt_buf.size() - 4;
        U32 q = (U32)bwt_buf[n] | ((U32)bwt_buf[n + 1] << 8)
                | ((U32)bwt_buf[n + 2] << 16)
                | ((U32)bwt_buf[n + 3] << 24);
        if ((int64_t)q > n) throw Err("bad BWT primary index");
        std::vector<U8> outb((size_t)n);
        lrz_bwt_inverse(bwt_buf.data(), outb.data(), (int32_t)n,
                        (int32_t)q);
        sink.write(outb.data(), n);
        bwt_buf.clear();
    }

    void fast_write(int ch, Sink& sink) {
        if (ch < 0) return;  // EOS: the program just halts
        switch (fstate) {
            case 0: fstate = ch ? 5 : 1; break;
            case 1: flen = (U32)ch; fstate = 2; break;
            case 2: flen += (U32)ch << 8; fstate = 3; break;
            case 3: flen += (U32)ch << 16; fstate = 4; break;
            case 4:  // literal
                sink.put(ch);
                if (--flen == 0) fstate = 0;
                break;
            case 5: flen = (U32)ch; fstate = 6; break;
            case 6: flen += (U32)ch << 8; fstate = 7; break;
            case 7: flen += (U32)ch << 16; fstate = 8; break;
            case 8: foff = (U32)ch; fstate = 9; break;
            case 9: foff += (U32)ch << 8; fstate = 10; break;
            case 10: foff += (U32)ch << 16; fstate = 11; break;
            case 11: {
                foff += (U32)ch << 24;
                // overlap-safe byte copy from already-written output
                // (the VM path reads the zero-initialised M ring when
                // the offset underruns; mirror that)
                for (U32 i = 0; i < flen; i++) {
                    int64_t s = sink.pos - (int64_t)foff;
                    sink.put(s >= 0 && s < sink.cap ? sink.p[s] : 0);
                }
                fstate = 0;
                flen = foff = 0;
                break;
            }
        }
    }

    void write(int ch, Sink& sink) {
        if (state == 5 && fast) { fast_write(ch, sink); return; }
        if (state == 5 && bwt_fast) { bwt_write(ch, sink); return; }
        switch (state) {
            case 0:
                if (ch < 0) throw Err("unexpected EOS");
                if (ch > 1) throw Err("unknown post processing type");
                state = ch + 1;
                break;
            case 1:  // PASS
                if (ch >= 0) sink.put(ch);
                break;
            case 2:
                if (ch < 0) throw Err("unexpected EOS");
                psize = ch;
                state = 3;
                break;
            case 3: {
                if (ch < 0) throw Err("unexpected EOS");
                psize += ch * 256;
                if (psize < 1) throw Err("empty PCOMP");
                int ph = z.header[4], pm = z.header[5];
                z.header.assign(psize + 300, 0);
                z.cend = 8;
                z.hbegin = z.hend = z.cend + 128;
                z.header[4] = (U8)ph;
                z.header[5] = (U8)pm;
                state = 4;
                break;
            }
            case 4:
                if (ch < 0) throw Err("unexpected EOS");
                z.header[z.hend++] = (U8)ch;
                if (z.hend - z.hbegin == psize) {
                    int hsize = z.cend - 2 + z.hend - z.hbegin;
                    z.header[0] = hsize & 255;
                    z.header[1] = hsize >> 8;
                    z.init_p();
                    z.out = &sink;
                    state = 5;
                    const std::vector<U8>& lp = lz_prog();
                    fast = (size_t)psize == lp.size()
                        && std::memcmp(&z.header[z.hbegin], lp.data(),
                                       lp.size()) == 0
                        && !std::getenv("LRZ_ZPAQ_FORCE_VM");
                    const std::vector<U8>& bp = bwt_prog();
                    bwt_fast = (size_t)psize == bp.size()
                        && std::memcmp(&z.header[z.hbegin], bp.data(),
                                       bp.size()) == 0
                        && !std::getenv("LRZ_ZPAQ_FORCE_VM");
                }
                break;
            case 5:
                z.out = &sink;
                if (ch >= 0) z.run((U32)ch);
                else {
                    // EOS: run with all-ones input per spec
                    z.run((U32)-1);
                }
                break;
        }
    }
};

// Decompress every block in the stream.
template <class PRED>
static void decode_block_segments(Source& in, Sink& out, VM& z,
                                  PRED& model) {
    RangeDecoder<PRED> dec;
    dec.in = &in;
    dec.pr = &model;
    bool first_seg = true;
    PostProc pp;
    for (;;) {
        int c1 = in.get();
        if (c1 == 255) break;  // end of block
        if (c1 != 1) throw Err("missing segment");
        while ((c1 = in.get()) != 0)
            if (c1 < 0) throw Err("EOF in filename");
        while ((c1 = in.get()) != 0)
            if (c1 < 0) throw Err("EOF in comment");
        if (in.get() != 0) throw Err("missing reserved byte");
        if (first_seg) {
            model.init();
            dec.init(model.is_modeled());
            pp.init(z.header[4], z.header[5]);
            first_seg = false;
        }
        // decompress segment data until EOS, feeding postprocessor.
        // The 4 zero trailer bytes are consumed by the decoder's EOS
        // normalisation (curr must land at 0), so the checksum
        // marker follows immediately.
        for (;;) {
            int c2 = dec.decompress();
            pp.write(c2, out);
            if (c2 == -1) break;
        }
        int cs = in.get();
        if (cs == 253) {
            for (int i = 0; i < 20; i++) in.get();  // skip sha1
        } else if (cs != 254) {
            throw Err("missing end of segment marker");
        }
    }
    if (out.overflow) throw Err("output buffer overflow");
}

// Decode one block; in.pos must sit right after the tag + "zPQ".
static void decode_one_block(Source& in, Sink& out) {
    int level = in.get();
    if (level != 1 && level != 2) throw Err("unsupported ZPAQ level");
    if (in.get() != 1) throw Err("unsupported ZPAQL type");
    VM z;
    z.read_header(in);
    if (level == 1 && z.header[6] == 0)
        throw Err("level 1 needs at least 1 component");
    // our own CM topologies decode through the specialized
    // evaluator; anything else through the spec interpreter
    FastShape fs = parse_fast_shape(z);
    if (fs.ok && !fs.word && fs.nper == 0) {
        FastModelT<false, 0, false> m(z, fs);
        decode_block_segments(in, out, z, m);
    } else if (fs.ok && fs.word && fs.nper == 0) {
        FastModelT<true, 0, false> m(z, fs);
        decode_block_segments(in, out, z, m);
    } else if (fs.ok && fs.word && fs.nper == 1 && fs.per_isse) {
        FastModelT<true, 1, true> m(z, fs);
        decode_block_segments(in, out, z, m);
    } else if (fs.ok && fs.word && fs.nper == 2 && fs.per_isse) {
        FastModelT<true, 2, true> m(z, fs);
        decode_block_segments(in, out, z, m);
    } else if (SmallShape ss = parse_small_chain(z);
               ss.nc == 2 && !std::getenv("LRZ_ZPAQ_FORCE_VM")) {
        SmallChainT<2> m(z, ss);
        decode_block_segments(in, out, z, m);
    } else if (ss.nc == 3 && !std::getenv("LRZ_ZPAQ_FORCE_VM")) {
        SmallChainT<3> m(z, ss);
        decode_block_segments(in, out, z, m);
    } else {
        Model m(z);
        decode_block_segments(in, out, z, m);
    }
}

// Advance past the tag; returns false at EOF.
static bool scan_tag(Source& in) {
    int matched = 0;
    int ch;
    while ((ch = in.get()) != -1) {
        if (ch == (matched < 13 ? kTag[matched] : "zPQ"[matched - 13])) {
            if (++matched == 16) return true;
        } else {
            matched = (ch == kTag[0]) ? 1 : 0;
        }
    }
    return false;
}

// The declared output size of the block at `pos` (right after its
// tag), from the first segment's size comment; -1 when absent or
// non-numeric (foreign encoders may omit it).
static int64_t peek_block_size(const Source& base, int64_t pos) {
    Source in{base.p, pos, base.len};
    if (in.get() == -1) return -1;   // level
    if (in.get() != 1) return -1;
    int hsize = in.get();
    int c2 = in.get();
    if (c2 < 0) return -1;
    hsize += c2 * 256;
    in.pos += hsize;                  // header body
    if (in.pos >= in.len) return -1;
    if (in.get() != 1) return -1;     // segment marker
    int c;
    while ((c = in.get()) != 0)
        if (c < 0) return -1;         // filename
    int64_t size = 0;
    bool any = false;
    while ((c = in.get()) != 0) {
        if (c < '0' || c > '9' || size > ((int64_t)1 << 53)) return -1;
        size = size * 10 + (c - '0');
        any = true;
    }
    return any ? size : -1;
}

static int64_t decode_stream(Source& in, Sink& out, int threads = 1) {
    build_tables();
    if (threads >= 2) {
        // parallel block decode: blocks are independent; their output
        // offsets come from the size comments our encoder writes (the
        // locator-tag scan is the spec's own random-access mechanism).
        // Any irregularity falls back to the serial path below.
        std::vector<int64_t> starts, sizes;
        Source scan{in.p, in.pos, in.len};
        bool ok = true;
        while (scan_tag(scan)) {
            int64_t sz = peek_block_size(scan, scan.pos);
            if (sz < 0) { ok = false; break; }
            starts.push_back(scan.pos);
            sizes.push_back(sz);
        }
        if (ok && starts.size() > 1) {
            std::vector<int64_t> offs(starts.size() + 1, 0);
            for (size_t i = 0; i < sizes.size(); i++)
                offs[i + 1] = offs[i] + sizes[i];
            if (offs.back() > out.cap - out.pos)
                throw Err("output buffer overflow");
            std::atomic<size_t> next{0};
            std::atomic<bool> fail{false};
            char emsg[128] = {0};
            std::mutex emu;
            auto work = [&]() {
                for (size_t i;
                     (i = next.fetch_add(1)) < starts.size();) {
                    int64_t end = i + 1 < starts.size()
                        ? starts[i + 1] : in.len;
                    Source bin{in.p, starts[i], end};
                    Sink bout{out.p + out.pos + offs[i], 0, sizes[i]};
                    try {
                        decode_one_block(bin, bout);
                        if (bout.pos != sizes[i] || bout.overflow)
                            throw Err("block size mismatch");
                    } catch (const std::exception& e) {
                        std::lock_guard<std::mutex> g(emu);
                        std::snprintf(emsg, sizeof emsg, "%s",
                                      e.what());
                        fail = true;
                        return;
                    }
                }
            };
            std::thread t2(work);
            work();
            t2.join();
            if (fail) throw Err(emsg);
            out.pos += offs.back();
            in.pos = in.len;
            return out.pos;
        }
    }
    while (scan_tag(in)) decode_one_block(in, out);
    return out.pos;
}

// ----------------------------------------------------- compressor -----

// Tiny ZPAQL assembler for our built-in model's HCOMP program.
struct Asm {
    std::vector<U8> code;
    std::vector<std::pair<size_t, int>> fix;  // jump operand -> label id
    std::vector<int> labels;
    void op(int o) { code.push_back((U8)o); }
    void op(int o, int n) { code.push_back((U8)o); code.push_back((U8)n); }
    int newlabel() { labels.push_back(-1); return (int)labels.size() - 1; }
    void place(int l) { labels[l] = (int)code.size(); }
    void jrel(int o, int l) {        // JT=39 JF=47 JMP=63, short range
        code.push_back((U8)o);
        fix.push_back({code.size(), l});
        code.push_back(0);
    }
    void finish() {
        for (auto& f : fix) {
            int delta = labels[f.second] - (int)f.first;
            if (delta < -127 || delta > 128) throw Err("jump out of range");
            code[f.first] = (U8)((delta - 1) & 255);
        }
    }
};

// Build a COMP+HCOMP header for an order-0..5 ICM/ISSE chain with a
// match model and mixer (the classic "mid" topology), sized by sb.
//
// Adaptive extras mirror the reference's method-string expansion
// (libzpaq.cpp:7633-7694, driven by lrzip's redundancy measurement at
// src/stream.c:304-309):
//  - `word`: word-context models (libzpaq's "w" specs): 0 = none,
//    1 = small ICM/ISSE pair (binary mode, libzpaq's level-5 "w1i1"),
//    2 = full-size pair (text) - the word hash folds case and resets
//    on non-letters;
//  - `periods`: up to 2 record lengths from the repetition-gap
//    histogram, each an ICM whose context is the byte one period back
//    (libzpaq's "c0,0,999+period" context spec); with `per_isse` each
//    periodic ICM is refined by an ISSE mixing in the previous byte
//    (libzpaq chains ISSEs behind its periodic contexts at level 5,
//    libzpaq.cpp:7654-7686).
static std::vector<U8> build_model(int sb, int word = 0,
                                   const int* periods = nullptr,
                                   int nper = 0, bool per_isse = false,
                                   int ph = 0) {
    // components
    std::vector<U8> comp;
    int n = 0;
    auto add = [&](std::initializer_list<int> v) {
        for (int x : v) comp.push_back((U8)x);
        n++;
    };
    add({ICM, 5});                    // 0: order-0 indirect model
    add({ISSE, 13, 0});               // 1: order 1
    add({ISSE, sb + 1, 1});           // 2: order 2
    add({ISSE, sb + 2, 2});           // 3: order 3
    add({ISSE, sb + 2, 3});           // 4: order 4
    add({ISSE, sb + 3, 4});           // 5: order 5
    add({MATCH, sb + 6, sb + 8});     // 6: long match model
    const int word_slot = word ? n : -1;
    if (word) {
        const int wsz = word >= 2 ? sb - 2 : sb - 5;  // text vs binary
        add({ICM, wsz});              // word-context indirect model
        add({ISSE, wsz + 1, n - 1});  // word+prev-byte refinement
    }
    const int per_slot = nper > 0 ? n : -1;
    for (int i = 0; i < nper; i++) {
        add({ICM, sb - 4});           // byte one period back
        if (per_isse)
            add({ISSE, sb - 4, n - 1});  // + previous-byte refinement
    }
    add({MIX, 16, 0, n, 24, 255});    // final mixer over all above

    (void)word_slot;
    (void)per_slot;
    std::vector<U8> hc = build_hcomp(n, word, periods, nper, per_isse);

    int hh = 3;                       // 2^hh context slots >= n
    while ((1 << hh) < n) hh++;
    const int hm = nper > 0 ? 13 : 3; // ring must reach back one period

    std::vector<U8> hdr;
    // hsize = hh hm ph pm n (5) + COMP + end + HCOMP + end
    int hsize = 5 + (int)comp.size() + 1 + (int)hc.size() + 1;
    hdr.push_back(hsize & 255);
    hdr.push_back(hsize >> 8);
    hdr.push_back((U8)hh);
    hdr.push_back((U8)hm);
    hdr.push_back((U8)ph);  // PCOMP H size (e8e9 method needs H[0..6])
    hdr.push_back(0);   // pm
    hdr.push_back((U8)n);
    for (U8 x : comp) hdr.push_back(x);
    hdr.push_back(0);   // COMP end
    for (U8 x : hc) hdr.push_back(x);
    hdr.push_back(0);   // HCOMP end
    return hdr;
}

// HCOMP program for an n-component build_model topology: ring-store
// the byte, hash chains h[1..5] of orders 1..5, h[6] = order-7 hash
// for the match model, then the optional word/periodic contexts, and
// byte<<8 for the mixer context.  FastModelT::run_hcomp is the native
// mirror of exactly this program.
static std::vector<U8> build_hcomp(int n, int word, const int* periods,
                                   int nper, bool per_isse) {
    const int word_slot = word ? 7 : -1;
    const int per_slot = 7 + (word ? 2 : 0);
    Asm a;
    a.op(17);        // C++
    a.op(104);       // *C=A   (store input byte in M[c])
    a.op(74);        // B=C
    a.op(4);         // A=0
    a.op(95, 1);     // D= 1
    a.op(59);        // HASH   (a = (a + M[b] + 512) * 773)
    a.op(112);       // *D=A   -> h[1] order 1
    for (int k = 0; k < 4; k++) {  // h[2]..h[5], orders 2..5
        a.op(10);    // B--
        a.op(25);    // D++
        a.op(59);    // HASH
        a.op(112);   // *D=A
    }
    a.op(25);        // D++ (d=6)
    a.op(10);        // B--
    a.op(59);        // HASH (order 6)
    a.op(10);        // B--
    a.op(59);        // HASH (order 7)
    a.op(112);       // *D=A -> h[6] for MATCH
    if (word) {
        // H[w] = letter ? hash(H[w], folded byte) : 0; then
        // H[w+1] = hash(H[w], previous byte)
        int skip = a.newlabel(), cont = a.newlabel();
        a.op(95, word_slot);  // D= w
        a.op(69);             // A=*C   (current byte)
        a.op(183, 32);        // A&~ 32 (fold case)
        a.op(239, 64);        // A> 64 ?
        a.jrel(47, skip);     // JF -> not a letter
        a.op(231, 91);        // A< 91 ?
        a.jrel(47, skip);
        a.op(60);             // HASHD: H[w] = (H[w]+a+512)*773
        a.jrel(63, cont);
        a.place(skip);
        a.op(52);             // *D=0 (word boundary resets the hash)
        a.place(cont);
        a.op(70);             // A=*D  (word hash)
        a.op(25);             // D++ (w+1)
        a.op(74);             // B=C
        a.op(10);             // B--  (previous byte)
        a.op(59);             // HASH (a = (wordhash + M[c-1] + 512)*773)
        a.op(112);            // *D=A
    }
    for (int i = 0; i < nper; i++) {
        int p = periods[i];
        a.op(95, per_slot + i * (per_isse ? 2 : 1));  // D= slot
        a.op(66);                // A=C
        while (p > 255) { a.op(143, 255); p -= 255; }  // A-= 255
        a.op(143, p);            // A-= period remainder
        a.op(72);                // B=A
        a.op(4);                 // A=0
        a.op(59);                // HASH -> hash of M[c - period]
        a.op(112);               // *D=A
        if (per_isse) {
            a.op(25);            // D++ (the chained ISSE slot)
            a.op(74);            // B=C
            a.op(10);            // B--  (previous byte)
            a.op(59);            // HASH (periodic hash + M[c-1])
            a.op(112);           // *D=A
        }
    }
    a.op(95, n - 1); // D= mixer slot
    a.op(69);        // A=*C  (current byte)
    a.op(207, 8);    // A<<= 8
    a.op(112);       // *D=A -> mixer context
    a.op(56);        // HALT
    a.finish();
    return a.code;
}

// Pick up to 2 dominant repetition periods (record lengths) from the
// gap histogram between recurrences of each byte value - the analysis
// libzpaq runs before building its level-5 method (libzpaq.cpp:7657-
// 7694).  Returns the number of periods written to out[2].
static int find_periods(const U8* p, int64_t n, int out[2]) {
    constexpr int NR = 1 << 12;
    // the reference analyzes every block regardless of size
    // (libzpaq.cpp:7657-7694); small record-structured blocks still
    // benefit, so only skip blocks too short for any period to recur
    if (n < 512) return 0;
    std::vector<int> last(256, 0);
    std::vector<int64_t> gaps(NR, 0);
    for (int64_t i = 0; i < n; i++) {
        int k = (int)(i - last[p[i]]);
        if (k > 0 && k < NR) gaps[k]++;
        last[p[i]] = (int)i;
    }
    int found = 0;
    int64_t n1 = n - gaps[1] - gaps[2] - gaps[3];
    for (int rounds = 0; rounds < 2; rounds++) {
        int period = 0;
        double score = 0;
        int64_t t = 0;
        for (int j = 5; j < NR && t < n1; j++) {
            double s = (double)gaps[j] / (256.0 + (double)(n1 - t));
            if (s > score) { score = s; period = j; }
            t += gaps[j];
        }
        if (period <= 4 || score <= 0.1) break;
        out[found++] = period;
        n1 -= gaps[period];
        gaps[period] = 0;
    }
    return found;
}

// Fast modes (levels 1-2): LZ77 tokens + the embedded PCOMP inverse.
// Level 1 stores the token stream raw (level-2 block, 0 components);
// level 2 models it with a small ICM/ISSE chain (order 1 + order 2).
static int64_t encode_stream_lz(Source& in, Sink& out, int level,
                                int bs) {
    build_tables();
    if (bs < 0) bs = 4;
    if (bs > 11) bs = 11;
    int64_t block_cap = ((int64_t)0x100000 << bs) - 4096;
    if (block_cap > ((int64_t)1 << 27)) block_cap = (int64_t)1 << 27;
    const std::vector<U8>& prog = lz_prog();
    const bool modeled = level >= 2;
    const int depth = level >= 3 ? 64 : (level >= 2 ? 16 : 2);

    while (in.pos < in.len) {
        int64_t n = in.len - in.pos;
        if (n > block_cap) n = block_cap;

        std::vector<U8> toks;
        toks.reserve((size_t)(n / 4 + prog.size() + 64));
        toks.push_back(1);  // PCOMP: PROG
        toks.push_back((U8)(prog.size() & 255));
        toks.push_back((U8)(prog.size() >> 8));
        toks.insert(toks.end(), prog.begin(), prog.end());
        lz77_tokens(in.p + in.pos, n, toks, depth);
        in.pos += n;

        int pm = 1;
        while (((int64_t)1 << pm) < n) pm++;

        // block header
        std::vector<U8> body;  // hh hm ph pm n COMP 0 HCOMP 0
        if (modeled && level >= 3) {
            // 3-component model: order-1 ICM -> order-2 ISSE ->
            // order-3 ISSE over the token stream (level 3)
            const U8 comp[] = {ICM, 16, ISSE, 17, 0, ISSE, 18, 1};
            const U8 hcomp[] = {
                17, 104, 74, 4,      // C++; *C=A; B=C; A=0
                95, 0, 59, 112,      // D=0; HASH; *D=A   (order 1)
                10, 25, 59, 112,     // B--; D++; HASH; *D=A (order 2)
                10, 25, 59, 112,     // B--; D++; HASH; *D=A (order 3)
                56,                  // HALT
            };
            body = {2, 3, 3, (U8)pm, 3};  // hh=2 (4 slots), ph=3
            body.insert(body.end(), comp, comp + sizeof comp);
            body.push_back(0);
            body.insert(body.end(), hcomp, hcomp + sizeof hcomp);
            body.push_back(0);
        } else if (modeled) {
            // 2-component model over the token stream: order-1 ICM
            // feeding an order-2 ISSE
            const U8 comp[] = {ICM, 16, ISSE, 17, 0};
            const U8 hcomp[] = {
                17, 104, 74, 4,      // C++; *C=A; B=C; A=0
                95, 0, 59, 112,      // D=0; HASH; *D=A   (order 1)
                10, 25, 59, 112,     // B--; D++; HASH; *D=A (order 2)
                56,                  // HALT
            };
            body = {1, 3, 3, (U8)pm, 2};  // ph=3: PCOMP uses H[0..3]
            body.insert(body.end(), comp, comp + sizeof comp);
            body.push_back(0);
            body.insert(body.end(), hcomp, hcomp + sizeof hcomp);
            body.push_back(0);
        } else {
            body = {0, 0, 3, (U8)pm, 0, 0, 56, 0};  // ph=3: H[0..3]
        }
        // hsize counts hh hm ph pm n + COMP + 0 + HCOMP + 0
        const int hsize = (int)body.size();

        out.write(kTag, 13);
        out.put('z'); out.put('P'); out.put('Q');
        out.put(2);  // ZPAQ level 2 (allows 0-component stored blocks)
        out.put(1);
        out.put(hsize & 255);
        out.put(hsize >> 8);
        out.write(body.data(), (int64_t)body.size());
        // segment: empty filename, size comment, reserved byte
        out.put(1);
        out.put(0);
        char cbuf[32];
        int cl = std::snprintf(cbuf, sizeof cbuf, "%lld", (long long)n);
        for (int i = 0; i < cl; i++) out.put(cbuf[i]);
        out.put(0);
        out.put(0);

        if (modeled) {
            Source hs{nullptr, 0, 0};
            std::vector<U8> hdr;
            hdr.push_back(hsize & 255);
            hdr.push_back(hsize >> 8);
            hdr.insert(hdr.end(), body.begin(), body.end());
            hs.p = hdr.data();
            hs.len = (int64_t)hdr.size();
            VM z;
            z.read_header(hs);
            SmallShape ss = parse_small_chain(z);
            auto code_toks = [&](auto& model) {
                RangeEncoder<typename std::remove_reference<
                    decltype(model)>::type> enc;
                enc.out = &out;
                enc.pr = &model;
                enc.init();
                for (U8 b : toks) enc.compress(b);
                enc.compress(-1);
            };
            if (ss.nc == 3) {
                SmallChainT<3> model(z, ss);
                code_toks(model);
            } else if (ss.nc == 2) {
                SmallChainT<2> model(z, ss);
                code_toks(model);
            } else {
                Model model(z);
                code_toks(model);
            }
            out.put(0); out.put(0); out.put(0); out.put(0);
        } else {
            // stored: 4-byte big-endian count, raw bytes, zero count
            U32 cnt = (U32)toks.size();
            out.put((int)(cnt >> 24)); out.put((int)(cnt >> 16) & 255);
            out.put((int)(cnt >> 8) & 255); out.put((int)cnt & 255);
            out.write(toks.data(), (int64_t)toks.size());
            out.put(0); out.put(0); out.put(0); out.put(0);
        }
        out.put(254);  // no checksum
        out.put(255);  // end of block
        if (out.overflow) return -1;
    }
    return out.pos;
}

// Encode ONE BWT block: SA-IS forward BWT, then the bwt bytes + LE32
// primary row coded under a small order-1/2 ICM/ISSE model with the
// inverse-BWT PCOMP embedded.
static void encode_bwt_block(const U8* data, int64_t n, Sink& out) {
    std::vector<U8> bwt((size_t)n);
    int32_t q = lrz_bwt_forward(data, bwt.data(), (int32_t)n);
    const std::vector<U8>& prog = bwt_prog();

    int pm = 3;
    while (((int64_t)1 << pm) < n + 8) pm++;
    int ph = 9;
    while (((int64_t)1 << ph) < n + 300) ph++;
    // order-1 ICM + order-2 ISSE.  An order-3 ISSE extension was
    // measured (round 5): +1% text ratio for -60% encode speed - BWT
    // output is rank/run structured, not deep-byte-context
    // conditioned, so deeper ISSEs buy almost nothing; rejected.
    const U8 comp[] = {ICM, 16, ISSE, 17, 0};
    const U8 hcomp[] = {
        17, 104, 74, 4,      // C++; *C=A; B=C; A=0
        95, 0, 59, 112,      // D=0; HASH; *D=A   (order 1)
        10, 25, 59, 112,     // B--; D++; HASH; *D=A (order 2)
        56,
    };
    std::vector<U8> body = {1, 3, (U8)ph, (U8)pm, 2};
    body.insert(body.end(), comp, comp + sizeof comp);
    body.push_back(0);
    body.insert(body.end(), hcomp, hcomp + sizeof hcomp);
    body.push_back(0);
    const int hsize = (int)body.size();

    out.write(kTag, 13);
    out.put('z'); out.put('P'); out.put('Q');
    out.put(1);
    out.put(1);
    out.put(hsize & 255);
    out.put(hsize >> 8);
    out.write(body.data(), (int64_t)body.size());
    out.put(1);
    out.put(0);
    char cbuf[32];
    int cl = std::snprintf(cbuf, sizeof cbuf, "%lld", (long long)n);
    for (int i = 0; i < cl; i++) out.put(cbuf[i]);
    out.put(0);
    out.put(0);

    std::vector<U8> hdr;
    hdr.push_back(hsize & 255);
    hdr.push_back(hsize >> 8);
    hdr.insert(hdr.end(), body.begin(), body.end());
    Source hs{hdr.data(), 0, (int64_t)hdr.size()};
    VM z;
    z.read_header(hs);
    SmallShape ss = parse_small_chain(z);
    SmallChainT<2> model(z, ss);
    RangeEncoder<SmallChainT<2>> enc;
    enc.out = &out;
    enc.pr = &model;
    enc.init();
    enc.compress(1);  // PCOMP: PROG psize[2] bytecode
    enc.compress((int)(prog.size() & 255));
    enc.compress((int)(prog.size() >> 8));
    for (U8 x : prog) enc.compress(x);
    for (int64_t i = 0; i < n; i++) enc.compress(bwt[(size_t)i]);
    enc.compress((int)((U32)q & 255));
    enc.compress((int)(((U32)q >> 8) & 255));
    enc.compress((int)(((U32)q >> 16) & 255));
    enc.compress((int)(((U32)q >> 24) & 255));
    enc.compress(-1);
    out.put(0); out.put(0); out.put(0); out.put(0);
    out.put(254);
    out.put(255);
}

// BWT stream: high-redundancy level-4 arm.  Blocks are independent, so
// backend MT splits them across two threads like the CM path.
static int64_t encode_stream_bwt(Source& in, Sink& out, int bs,
                                 int threads) {
    build_tables();
    if (bs < 0) bs = 4;
    if (bs > 11) bs = 11;
    int64_t block_cap = ((int64_t)0x100000 << bs) - 4096;
    // the PCOMP packs links as 24-bit values: blocks stay under 2^24
    if (block_cap > ((int64_t)1 << 24) - 4096)
        block_cap = ((int64_t)1 << 24) - 4096;
    if (threads >= 2 && in.len - in.pos > (2 << 20)) {
        int64_t half = (in.len - in.pos + threads - 1) / threads;
        if (half < (1 << 20)) half = 1 << 20;
        if (half < block_cap) block_cap = half;
    }
    std::vector<std::pair<int64_t, int64_t>> blocks;
    for (int64_t p = in.pos; p < in.len;) {
        int64_t n = in.len - p;
        if (n > block_cap) n = block_cap;
        blocks.emplace_back(p, n);
        p += n;
    }
    in.pos = in.len;
    if (blocks.size() > 1 && threads >= 2) {
        std::vector<std::vector<U8>> bufs(blocks.size());
        std::atomic<size_t> next{0};
        std::atomic<bool> fail{false};
        auto work = [&]() {
            for (size_t i; (i = next.fetch_add(1)) < blocks.size();) {
                int64_t off = blocks[i].first, n = blocks[i].second;
                bufs[i].resize((size_t)(n + n / 4 + 65536));
                Sink bsk{bufs[i].data(), 0, (int64_t)bufs[i].size()};
                try {
                    encode_bwt_block(in.p + off, n, bsk);
                } catch (...) {
                    fail = true;
                    return;
                }
                if (bsk.overflow) { fail = true; return; }
                bufs[i].resize((size_t)bsk.pos);
            }
        };
        std::thread t2(work);
        work();
        t2.join();
        if (fail) return -1;
        for (auto& b : bufs) out.write(b.data(), (int64_t)b.size());
        if (out.overflow) return -1;
        return out.pos;
    }
    for (auto& blk : blocks) {
        encode_bwt_block(in.p + blk.first, blk.second, out);
        if (out.overflow) return -1;
    }
    return out.pos;
}


// level: the reference's 1-5 dial; redundancy: 0 (hard) .. 255 (easy)
// from the lz4 gate measurement (src/stream.c:304-309; < 0 = neutral
// 128); ttype: 1 = text, 0 = binary, < 0 = the reference's inference
// (redundancy > 192 => text).
// Encode ONE CM block (framing + model header + coded payload).
// e8: apply the E8E9 exe precoder (x86 content) and embed its PCOMP
// inverse so the reference's libzpaq also decodes the block.
static void encode_cm_block(const U8* data, int64_t n, Sink& out,
                            int level, int sb, bool text,
                            bool e8 = false) {
    std::vector<U8> xbuf;
    if (e8) {
        xbuf.assign(data, data + n);
        e8e9_fwd(xbuf.data(), n);
        data = xbuf.data();
    }
    // level 5 analyses each block for record periodicity
    int periods[2];
    int nper = level >= 5 ? find_periods(data, n, periods) : 0;

    // assemble model header for this block; level 5 adds a word
    // model even for binary input (libzpaq's "w1i1",
    // libzpaq.cpp:7654) and refines each periodic context with a
    // chained ISSE
    const int word = text ? 2 : (level >= 5 ? 1 : 0);
    std::vector<U8> hdr = build_model(sb, word, periods, nper,
                                      /*per_isse=*/level >= 5,
                                      /*ph=*/e8 ? 3 : 0);
    // VM wants the full relocated form; reuse read_header
    Source hs{hdr.data(), 0, (int64_t)hdr.size()};
    VM z;
    z.read_header(hs);

    // block framing: tag + "zPQ" + level byte + 1 + header
    out.write(kTag, 13);
    out.put('z'); out.put('P'); out.put('Q');
    out.put(1);  // level 1 (modeled)
    out.put(1);
    for (U8 x : hdr) out.put(x);
    // segment: empty filename, size comment, reserved
    out.put(1);
    out.put(0);
    char cbuf[32];
    int cl = std::snprintf(cbuf, sizeof cbuf, "%lld", (long long)n);
    for (int i = 0; i < cl; i++) out.put(cbuf[i]);
    out.put(0);
    out.put(0);
    // specialized evaluator for our own topologies (always matches
    // build_model's output; Model is the safety net)
    auto code_block = [&](auto& model) {
        RangeEncoder<typename std::remove_reference<
            decltype(model)>::type> enc;
        enc.out = &out;
        enc.pr = &model;
        enc.init();
        if (e8) {
            const std::vector<U8>& prog = e8e9_prog();
            enc.compress(1);  // PCOMP flag: PROG psize[2] bytecode
            enc.compress((int)(prog.size() & 255));
            enc.compress((int)(prog.size() >> 8));
            for (U8 x : prog) enc.compress(x);
        } else {
            enc.compress(0);  // PCOMP flag: 0 = PASS
        }
        for (int64_t i = 0; i < n; i++) enc.compress(data[i]);
        enc.compress(-1);
    };
    FastShape fs = parse_fast_shape(z);
    if (fs.ok && !fs.word && fs.nper == 0) {
        FastModelT<false, 0, false> m(z, fs);
        code_block(m);
    } else if (fs.ok && fs.word && fs.nper == 0) {
        FastModelT<true, 0, false> m(z, fs);
        code_block(m);
    } else if (fs.ok && fs.word && fs.nper == 1 && fs.per_isse) {
        FastModelT<true, 1, true> m(z, fs);
        code_block(m);
    } else if (fs.ok && fs.word && fs.nper == 2 && fs.per_isse) {
        FastModelT<true, 2, true> m(z, fs);
        code_block(m);
    } else {
        Model m(z);
        code_block(m);
    }
    out.put(0); out.put(0); out.put(0); out.put(0);
    out.put(254);  // no checksum (reference decoder discards it)
    out.put(255);  // end of block
}

static int64_t encode_stream(Source& in, Sink& out, int level, int bs,
                             int redundancy = -1, int ttype = -1,
                             int threads = 1) {
    if (redundancy < 0) redundancy = 128;
    if (redundancy > 255) redundancy = 255;
    if (ttype < 0)
        ttype = looks_text(in.p + in.pos, in.len - in.pos) ? 1 : 0;
    if (level <= 3) return encode_stream_lz(in, out, level, bs);
    // barely-compressible data: route to the LZ77 paths instead of
    // burning CM time (libzpaq's level-4/5 low-type arms)
    if (redundancy < 48)
        return encode_stream_lz(in, out, 2, bs);
    // high-redundancy level-4 binary: BWT + small model runs ~2x the
    // CM chain's speed at equal-or-better ratio (the reference's
    // mid-method BWT arm, libzpaq.cpp:7545-7731); text and level 5
    // stay CM (the word/match models win there)
    if (level == 4 && ttype == 0 && redundancy >= 160)
        return encode_stream_bwt(in, out, bs, threads);
    build_tables();
    if (bs < 0) bs = 4;
    if (bs > 11) bs = 11;
    int64_t block_cap = ((int64_t)0x100000 << bs) - 4096;
    // backend MT (the reference's --nobemt dial, LzFindMt role for the
    // CM coder): the coder is bit-serial inside a block, so the 2nd
    // thread comes from splitting into independent blocks - the same
    // block-level parallelism the reference gets by handing zpaq
    // multiple stream blocks (src/stream.c:276-330)
    if (threads >= 2 && in.len - in.pos > (2 << 20)) {
        int64_t half = (in.len - in.pos + threads - 1) / threads;
        if (half < (1 << 20)) half = 1 << 20;
        if (half < block_cap) block_cap = half;
    }
    // model size scales with level and block size, then CONTINUOUSLY
    // with the lz4-gate redundancy measurement (libzpaq derives its
    // component sizes from block size + measured redundancy/type,
    // libzpaq.cpp:7545-7731; lrzip feeds the measurement at
    // src/stream.c:304-309): hard data gets bigger context tables
    // (+1..+2 bits), easy data smaller and faster ones (-1..-2) -
    // its contexts repeat, so small hashes already capture them
    int sb = 16 + (level >= 4) + 2 * (level >= 5);
    if (bs < 5) sb -= (5 - bs);
    sb += (128 - redundancy) / 48;   // -2 .. +2, continuous in rd
    if (sb < 10) sb = 10;
    if (sb > 21) sb = 21;
    const bool text = ttype == 1;

    std::vector<std::pair<int64_t, int64_t>> blocks;
    for (int64_t p = in.pos; p < in.len;) {
        int64_t n = in.len - p;
        if (n > block_cap) n = block_cap;
        blocks.emplace_back(p, n);
        p += n;
    }
    in.pos = in.len;
    if (blocks.size() > 1 && threads >= 2) {
        std::vector<std::vector<U8>> bufs(blocks.size());
        std::atomic<size_t> next{0};
        std::atomic<bool> fail{false};
        auto work = [&]() {
            for (size_t i; (i = next.fetch_add(1)) < blocks.size();) {
                int64_t off = blocks[i].first, n = blocks[i].second;
                bufs[i].resize((size_t)(n + n / 4 + 65536));
                Sink bsk{bufs[i].data(), 0, (int64_t)bufs[i].size()};
                try {
                    encode_cm_block(in.p + off, n, bsk, level, sb,
                                    text,
                                    !text && looks_x86(in.p + off, n));
                } catch (...) {
                    fail = true;
                    return;
                }
                if (bsk.overflow) { fail = true; return; }
                bufs[i].resize((size_t)bsk.pos);
            }
        };
        std::thread t2(work);
        work();
        t2.join();
        if (fail) return -1;
        for (auto& b : bufs) out.write(b.data(), (int64_t)b.size());
        if (out.overflow) return -1;
        return out.pos;
    }
    for (auto& blk : blocks) {
        encode_cm_block(in.p + blk.first, blk.second, out, level, sb,
                        text, !text && looks_x86(in.p + blk.first,
                                                 blk.second));
        if (out.overflow) return -1;
    }
    return out.pos;
}

}  // namespace tpz

extern "C" {

// Decompress a zpaq stream; returns output length or -1 on error.
int64_t zpaq_decode(const uint8_t* in, int64_t in_len, uint8_t* out,
                    int64_t out_cap, char* errbuf, int errcap,
                    int threads) {
    try {
        tpz::Source src{in, 0, in_len};
        tpz::Sink sink{out, 0, out_cap};
        return tpz::decode_stream(src, sink, threads);
    } catch (const std::exception& e) {
        if (errbuf && errcap > 0) {
            std::snprintf(errbuf, errcap, "%s", e.what());
        }
        return -1;
    }
}

// Compress with the built-in CM model; returns output length, -1 on
// overflow/error.
int64_t zpaq_encode(const uint8_t* in, int64_t in_len, uint8_t* out,
                    int64_t out_cap, int level, int block_bits,
                    int redundancy, int ttype,
                    char* errbuf, int errcap, int threads) {
    try {
        tpz::Source src{in, 0, in_len};
        tpz::Sink sink{out, 0, out_cap};
        return tpz::encode_stream(src, sink, level, block_bits,
                                  redundancy, ttype, threads);
    } catch (const std::exception& e) {
        if (errbuf && errcap > 0) {
            std::snprintf(errbuf, errcap, "%s", e.what());
        }
        return -1;
    }
}

}  // extern "C"
