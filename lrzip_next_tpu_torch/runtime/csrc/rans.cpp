// Host mirror of the device interleaved-rANS block codec (ops/rans.py).
//
// Fills the role the reference's native entropy coders play on the CPU
// path (backend dispatch src/stream.c:167-554): a fast sequential
// encoder/decoder of the exact bitstream the TPU kernels produce, used
// for CPU-only encode/decode and for cross-validating the device path.
//
// Bitstream (little-endian; CTYPE_RANS=11, framework extension):
//   u8  magic = 1
//   u8  ctx_bits   (0, 4, 6, 8: context = prev byte >> (8 - ctx_bits))
//   u8  log2(K)    (K = lane count)
//   u8  flags = 0
//   u64 n          (uncompressed length)
//   u32 n_words
//   u32 table_len  (zlib of 12-bit-packed (C,256) frequency table)
//   u32 t_len      (lane span length; lane k covers [k*T, k*T+T) )
//   table, K*u32 decoder-initial states, n_words*u16 stream
//
// Coder: M = 2^12 quantized freqs, 32-bit states in [2^16, 2^32),
// 16-bit renorm (exactly 0/1 word per symbol).  Stream is in decoder
// read order: step-major, lane-minor.  Encode walks spans back to
// front (standard rANS reversal).

#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

constexpr int M_BITS = 12;
constexpr uint32_t M = 1u << M_BITS;
constexpr uint32_t RLOW = 1u << 16;

int pick_lanes(int64_t n) {
    int64_t k = 64;
    while (k < 16384 && k * 2048 <= n) k *= 2;
    return (int)k;
}

// Normalize exact counts to freqs summing to M, every symbol >= 1
// (floor + remainder to argmax - same scheme as ops/rans.quantize_freqs;
// tables are carried in the payload so encoders need not agree bit-wise).
void quantize_row(const uint64_t* cnt, int32_t* f) {
    uint64_t total = 0;
    for (int s = 0; s < 256; s++) total += cnt[s];
    int32_t sum = 0;
    int am = 0;
    uint64_t best = 0;
    for (int s = 0; s < 256; s++) {
        int32_t v = 1;
        if (total) v = 1 + (int32_t)((cnt[s] * (uint64_t)(M - 256)) / total);
        f[s] = v;
        sum += v;
        if (cnt[s] >= best) { best = cnt[s]; am = s; }
    }
    f[am] += (int32_t)M - sum;
}

void pack12(const int32_t* f, size_t n_entries, std::vector<uint8_t>& out) {
    out.resize(n_entries / 2 * 3);
    for (size_t i = 0; i < n_entries / 2; i++) {
        uint32_t a = (uint32_t)f[2 * i], b = (uint32_t)f[2 * i + 1];
        out[3 * i] = (uint8_t)(a & 0xFF);
        out[3 * i + 1] = (uint8_t)(((a >> 8) & 0x0F) | ((b & 0x0F) << 4));
        out[3 * i + 2] = (uint8_t)(b >> 4);
    }
}

bool unpack12(const uint8_t* p, size_t plen, int32_t* f, size_t n_entries) {
    if (plen != n_entries / 2 * 3) return false;
    for (size_t i = 0; i < n_entries / 2; i++) {
        f[2 * i] = (int32_t)(p[3 * i] | ((p[3 * i + 1] & 0x0F) << 8));
        f[2 * i + 1] = (int32_t)((p[3 * i + 1] >> 4) | (p[3 * i + 2] << 4));
    }
    return true;
}

inline uint32_t rd32(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

inline uint64_t rd64(const uint8_t* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v;
}

}  // namespace

extern "C" {

// Encode n bytes; returns payload length, -1 if dst too small, -2 on
// internal error.  ctx_bits in {0, 4, 6, 8}.
int64_t rans_encode(const uint8_t* src, int64_t n, int ctx_bits,
                    uint8_t* dst, int64_t dst_cap) {
    if (ctx_bits != 0 && ctx_bits != 4 && ctx_bits != 6 && ctx_bits != 8)
        return -2;
    const int64_t HDR = 24;
    if (n == 0) {
        if (dst_cap < HDR) return -1;
        memset(dst, 0, HDR);
        dst[0] = 1;
        dst[1] = 6;
        return HDR;
    }
    const int K = pick_lanes(n);
    const int64_t T = (n + K - 1) / K;
    const int C = 1 << ctx_bits;
    const int shift = 8 - ctx_bits;

    // exact joint histogram
    std::vector<uint64_t> cnt((size_t)C * 256, 0);
    for (int k = 0; k < K; k++) {
        const int64_t base = (int64_t)k * T;
        if (base >= n) break;
        const int64_t end = std::min<int64_t>(base + T, n);
        uint8_t prev = 0;
        for (int64_t i = base; i < end; i++) {
            const int ctx = ctx_bits ? (prev >> shift) : 0;
            cnt[(size_t)ctx * 256 + src[i]]++;
            prev = src[i];
        }
    }
    std::vector<int32_t> freqs((size_t)C * 256);
    for (int c = 0; c < C; c++)
        quantize_row(&cnt[(size_t)c * 256], &freqs[(size_t)c * 256]);
    std::vector<int32_t> cum((size_t)C * 256);
    for (int c = 0; c < C; c++) {
        int32_t acc = 0;
        for (int s = 0; s < 256; s++) {
            cum[(size_t)c * 256 + s] = acc;
            acc += freqs[(size_t)c * 256 + s];
        }
    }

    // reverse-order encode; emissions bucketed per span position so the
    // stream can be laid out in decoder read order (step-major)
    std::vector<uint32_t> x((size_t)K, RLOW);
    std::vector<std::vector<uint16_t>> per_t((size_t)T);
    for (int64_t t = T - 1; t >= 0; t--) {
        auto& bucket = per_t[(size_t)t];
        for (int k = 0; k < K; k++) {
            const int64_t pos = (int64_t)k * T + t;
            if (pos >= n) continue;
            const uint8_t sym = src[pos];
            const int ctx =
                (ctx_bits && t > 0) ? (src[pos - 1] >> shift) : 0;
            const uint32_t f = (uint32_t)freqs[(size_t)ctx * 256 + sym];
            const uint32_t c = (uint32_t)cum[(size_t)ctx * 256 + sym];
            uint32_t xx = x[(size_t)k];
            if (xx >= (f << 20)) {
                bucket.push_back((uint16_t)(xx & 0xFFFF));
                xx >>= 16;
            }
            x[(size_t)k] = (xx / f) * M + c + (xx % f);
        }
    }
    // per-step emissions were collected k-ascending; decoder reads them
    // k-ascending too, so concatenation order is already correct
    int64_t n_words = 0;
    for (auto& b : per_t) n_words += (int64_t)b.size();
    if (n_words > 0xFFFFFFFFll) return -2;

    std::vector<uint8_t> packed;
    pack12(freqs.data(), freqs.size(), packed);
    uLongf zcap = compressBound((uLong)packed.size());
    std::vector<uint8_t> table(zcap);
    if (compress2(table.data(), &zcap, packed.data(),
                  (uLong)packed.size(), 6) != Z_OK)
        return -2;
    table.resize(zcap);

    const int64_t total = HDR + (int64_t)table.size() + 4ll * K +
                          2 * n_words;
    if (total > dst_cap) return -1;
    uint8_t* p = dst;
    p[0] = 1;
    p[1] = (uint8_t)ctx_bits;
    int klog = 0;
    while ((1 << klog) < K) klog++;
    p[2] = (uint8_t)klog;
    p[3] = 0;
    uint64_t n64 = (uint64_t)n;
    memcpy(p + 4, &n64, 8);
    uint32_t nw32 = (uint32_t)n_words, tl32 = (uint32_t)table.size(),
             tt32 = (uint32_t)T;
    memcpy(p + 12, &nw32, 4);
    memcpy(p + 16, &tl32, 4);
    memcpy(p + 20, &tt32, 4);
    p += HDR;
    memcpy(p, table.data(), table.size());
    p += table.size();
    memcpy(p, x.data(), 4ull * K);
    p += 4ull * K;
    for (int64_t t = 0; t < T; t++) {
        auto& b = per_t[(size_t)t];
        if (!b.empty()) {
            memcpy(p, b.data(), 2 * b.size());
            p += 2 * b.size();
        }
    }
    return total;
}

// Decode payload into dst (capacity dst_cap). Returns decoded length,
// -1 if dst too small, -3 on corrupt payload.
int64_t rans_decode(const uint8_t* payload, int64_t plen, uint8_t* dst,
                    int64_t dst_cap) {
    const int64_t HDR = 24;
    if (plen < HDR || payload[0] != 1) return -3;
    const int ctx_bits = payload[1];
    const int klog = payload[2];
    if ((ctx_bits != 0 && ctx_bits != 4 && ctx_bits != 6 &&
         ctx_bits != 8) || klog > 14)
        return -3;
    const int64_t n = (int64_t)rd64(payload + 4);
    if (n == 0) return 0;
    if (n > dst_cap) return -1;
    const int64_t n_words = rd32(payload + 12);
    const int64_t tlen = rd32(payload + 16);
    const int64_t T = rd32(payload + 20);
    const int K = 1 << klog;
    const int C = 1 << ctx_bits;
    const int shift = 8 - ctx_bits;
    if (T * (int64_t)K < n || T > (1ll << 26)) return -3;
    if (HDR + tlen + 4ll * K + 2 * n_words > plen) return -3;

    std::vector<int32_t> freqs((size_t)C * 256);
    {
        std::vector<uint8_t> packed((size_t)C * 256 / 2 * 3);
        uLongf dlen = (uLongf)packed.size();
        if (uncompress(packed.data(), &dlen, payload + HDR,
                       (uLong)tlen) != Z_OK ||
            dlen != packed.size())
            return -3;
        if (!unpack12(packed.data(), packed.size(), freqs.data(),
                      freqs.size()))
            return -3;
    }
    // decode tables: per context, symbol/cumfreq by slot
    std::vector<uint8_t> slot_sym((size_t)C * M);
    std::vector<int32_t> cum((size_t)C * 256);
    for (int c = 0; c < C; c++) {
        int32_t acc = 0;
        for (int s = 0; s < 256; s++) {
            const int32_t f = freqs[(size_t)c * 256 + s];
            if (f < 1) return -3;
            cum[(size_t)c * 256 + s] = acc;
            if (acc + f > (int32_t)M) return -3;
            memset(&slot_sym[(size_t)c * M + acc], s, (size_t)f);
            acc += f;
        }
        if (acc != (int32_t)M) return -3;
    }

    const uint8_t* sp = payload + HDR + tlen;
    std::vector<uint32_t> x((size_t)K);
    memcpy(x.data(), sp, 4ull * K);
    const uint8_t* words = sp + 4ull * K;
    int64_t ptr = 0;

    for (int64_t t = 0; t < T; t++) {
        for (int k = 0; k < K; k++) {
            const int64_t pos = (int64_t)k * T + t;
            if (pos >= n) continue;
            uint32_t xx = x[(size_t)k];
            const int ctx =
                (ctx_bits && t > 0) ? (dst[pos - 1] >> shift) : 0;
            const uint32_t slot = xx & (M - 1);
            const uint8_t s = slot_sym[(size_t)ctx * M + slot];
            dst[pos] = s;
            const uint32_t f = (uint32_t)freqs[(size_t)ctx * 256 + s];
            const uint32_t cs = (uint32_t)cum[(size_t)ctx * 256 + s];
            xx = f * (xx >> M_BITS) + slot - cs;
            if (xx < RLOW) {
                if (ptr >= n_words) return -3;
                uint16_t w;
                memcpy(&w, words + 2 * ptr, 2);
                ptr++;
                xx = (xx << 16) | w;
            }
            x[(size_t)k] = xx;
        }
    }
    for (int k = 0; k < K; k++)
        if (x[(size_t)k] != RLOW) return -3;
    if (ptr != n_words) return -3;
    return n;
}

}  // extern "C"
