// rANS order-0/1 codec, byte-exact with kanzi_tpu/entropy/ans.py (and the
// reference wire format K/entropy/ANSRangeEncoder.java / ANSRangeDecoder.java).
// Produces/consumes an MSB-first bit image so the Python layer can splice it
// at any bit offset.  This is the host-side fast path; the device path is
// kanzi_tpu/ops/ans.py (XLA) and native/ans_cuda.cu (CUDA).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

#if defined(_MSC_VER)
#define EXPORT extern "C" __declspec(dllexport)
#else
#define EXPORT extern "C" __attribute__((visibility("default")))
#endif

typedef uint8_t u8;
typedef int32_t i32;
typedef uint32_t u32;
typedef int64_t i64;
typedef uint64_t u64;

namespace ans {

static const i32 ANS_TOP = 1 << 15;
static const i32 DEF_CHUNK = 16384;
static const i64 MAX_CHUNK = 1 << 27;

struct BitSink {
    u8* buf; i64 cap; i64 bitpos; bool overflow;
    void bits(u64 v, i32 n) {
        if (n == 0) return;
        if ((bitpos + n + 7) / 8 > cap) { overflow = true; return; }
        for (i32 k = n - 1; k >= 0; k--) {
            const u64 b = (v >> k) & 1;
            buf[bitpos >> 3] |= (u8)(b << (7 - (bitpos & 7)));
            bitpos++;
        }
    }
    void bytes(const u8* p, i64 n) {
        if ((bitpos + 8 * n + 7) / 8 > cap) { overflow = true; return; }
        if ((bitpos & 7) == 0) {
            std::memcpy(buf + (bitpos >> 3), p, n);
            bitpos += 8 * n;
        } else {
            const i32 sh = bitpos & 7;
            i64 bi = bitpos >> 3;
            for (i64 i = 0; i < n; i++) {
                buf[bi] |= (u8)(p[i] >> sh);
                buf[bi + 1] |= (u8)(p[i] << (8 - sh));
                bi++;
            }
            bitpos += 8 * n;
        }
    }
    void varint(u32 v) {
        while (v >= 128) { bits(0x80 | (v & 0x7F), 8); v >>= 7; }
        bits(v, 8);
    }
};

struct BitSource {
    const u8* buf; i64 nbits; i64 bitpos; bool fail;
    u64 bits(i32 n) {
        if (n == 0) return 0;
        if (bitpos + n > nbits) { fail = true; return 0; }
        u64 v = 0;
        for (i32 k = 0; k < n; k++) {
            v = (v << 1) | ((buf[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
            bitpos++;
        }
        return v;
    }
    void bytes(u8* p, i64 n) {
        if (bitpos + 8 * n > nbits) { fail = true; return; }
        if ((bitpos & 7) == 0) {
            std::memcpy(p, buf + (bitpos >> 3), n);
            bitpos += 8 * n;
        } else {
            const i32 sh = bitpos & 7;
            const i64 lim = (nbits + 7) >> 3;
            i64 bi = bitpos >> 3;
            for (i64 i = 0; i < n; i++) {
                const u8 nxt = (bi + 1 < lim) ? buf[bi + 1] : 0;
                p[i] = (u8)((buf[bi] << sh) | (nxt >> (8 - sh)));
                bi++;
            }
            bitpos += 8 * n;
        }
    }
    u32 varint() {
        u32 value = (u32)bits(8);
        u32 res = value & 0x7F;
        i32 shift = 7;
        while (value >= 128) {
            value = (u32)bits(8);
            res |= ((value & 0x7F) << shift);
            if (shift == 28) break;
            shift += 7;
        }
        return res;
    }
};

// exact mirror of EntropyUtils.normalizeFrequencies (wire-critical)
static i32 normalize(i64* freqs, i32* alphabet, i64 totalFreq, i32 scale) {
    if (totalFreq == 0) return 0;
    if (totalFreq == scale) {
        i32 n = 0;
        for (i32 i = 0; i < 256; i++)
            if (freqs[i] != 0) alphabet[n++] = i;
        return n;
    }
    i32 alphabetSize = 0;
    i64 sumScaled = 0, sumFreq = 0;
    i32 idxMax = 0;
    for (i32 i = 0; i < 256; i++) {
        const i64 f = freqs[i];
        if (f == 0) continue;
        const i64 sf = f * scale;
        const i64 scaled = (sf <= totalFreq) ? 1 : (sf + (totalFreq >> 1)) / totalFreq;
        alphabet[alphabetSize++] = i;
        sumScaled += scaled;
        freqs[i] = scaled;
        sumFreq += f;
        if (scaled > freqs[idxMax]) idxMax = i;
        if (sumFreq >= totalFreq) break;
    }
    if (alphabetSize == 0) return 0;
    if (alphabetSize == 1) { freqs[alphabet[0]] = scale; return 1; }
    if (sumScaled == scale) return alphabetSize;
    i64 delta = sumScaled - scale;
    const i64 errThr = freqs[idxMax] >> 4;
    if ((delta < 0 ? -delta : delta) <= errThr) {
        freqs[idxMax] -= delta;
        return alphabetSize;
    }
    if (delta < 0) { delta += errThr; freqs[idxMax] += errThr; }
    else { delta -= errThr; freqs[idxMax] -= errThr; }
    const i64 inc = (delta > 0) ? -1 : 1;
    delta = delta < 0 ? -delta : delta;
    i32 round = 0;
    while (++round < 6 && delta > 0) {
        i32 adjustments = 0;
        for (i32 i = 0; i < alphabetSize; i++) {
            const i32 idx = alphabet[i];
            if (freqs[idx] <= 2) continue;
            freqs[idx] += inc;
            adjustments++;
            delta--;
            if (delta == 0) break;
        }
        if (adjustments == 0) break;
    }
    freqs[idxMax] = std::max(freqs[idxMax] - delta, (i64)1);
    return alphabetSize;
}

static void encode_alphabet(BitSink& S, const i32* alphabet, i32 count) {
    if (count == 0) { S.bits(0, 1); S.bits(1, 1); return; }
    if (count == 256) { S.bits(0, 1); S.bits(0, 1); return; }
    S.bits(1, 1);
    u8 masks[32] = {0};
    for (i32 i = 0; i < count; i++) masks[alphabet[i] >> 3] |= (1 << (alphabet[i] & 7));
    const i32 lastMask = alphabet[count - 1] >> 3;
    S.bits(lastMask, 5);
    for (i32 i = 0; i <= lastMask; i++) S.bits(masks[i], 8);
}

static i32 decode_alphabet(BitSource& S, i32* alphabet) {
    if (S.bits(1) == 0) {
        if (S.bits(1) == 1) return 0;
        for (i32 i = 0; i < 256; i++) alphabet[i] = i;
        return 256;
    }
    const i32 lastMask = (i32)S.bits(5);
    i32 count = 0;
    for (i32 i = 0; i <= lastMask; i++) {
        const i32 mask = (i32)S.bits(8);
        for (i32 j = 0; j < 8; j++)
            if (mask & (1 << j)) alphabet[count++] = (i << 3) + j;
    }
    return count;
}

static void write_freqs(BitSink& S, const i32* alphabet, i32 count,
                        const i64* freqs, i32 lr) {
    encode_alphabet(S, alphabet, count);
    if (count <= 1) return;
    const i32 chk = (count >= 64) ? 8 : 6;
    i32 llr = 3;
    while ((1 << llr) <= lr) llr++;
    for (i32 i = 1; i < count; i += chk) {
        const i32 endj = std::min(i + chk, count);
        i64 mx = 0;
        for (i32 j = i; j < endj; j++)
            mx = std::max(mx, freqs[alphabet[j]] - 1);
        i32 logMax = 0;
        while ((1LL << logMax) <= mx) logMax++;
        S.bits(logMax, llr);
        if (logMax == 0) continue;
        for (i32 j = i; j < endj; j++)
            S.bits((u64)(freqs[alphabet[j]] - 1), logMax);
    }
}

static i32 read_freqs(BitSource& S, i64* freqs, i32 lr) {
    const i32 scale = 1 << lr;
    i32 alphabet[256];
    const i32 count = decode_alphabet(S, alphabet);
    std::memset(freqs, 0, 256 * sizeof(i64));
    if (count == 0) return 0;
    if (count == 1) { freqs[alphabet[0]] = scale; return 1; }
    const i32 chk = (count >= 64) ? 8 : 6;
    i32 llr = 3;
    while ((1 << llr) <= lr) llr++;
    i64 total = 0;
    for (i32 i = 1; i < count; i += chk) {
        const i32 logMax = (i32)S.bits(llr);
        if ((1 << logMax) > scale) { S.fail = true; return -1; }
        const i32 endj = std::min(i + chk, count);
        for (i32 j = i; j < endj; j++) {
            const i64 f = (logMax == 0) ? 1 : (i64)(1 + S.bits(logMax));
            if (f <= 0 || f >= scale) { S.fail = true; return -1; }
            freqs[alphabet[j]] = f;
            total += f;
        }
    }
    if (scale <= total) { S.fail = true; return -1; }
    freqs[alphabet[0]] = scale - total;
    return count;
}

}  // namespace ans

using namespace ans;

// Encode a block.  order: 0/1. dst: zeroed byte buffer; returns bit count
// written, or -1 on overflow.  log_range: 12 (order0) / 11 (order1)
// semantics applied internally from `order` like the reference.
EXPORT i64 kz_ans_encode(const u8* src, i64 count, u8* dst, i64 cap, i32 order,
                         i64 chunk_size0, i32 log_range_in) {
    BitSink S{dst, cap, 0, false};
    if (count <= 32) {
        S.bytes(src, count);
        return S.overflow ? -1 : S.bitpos;
    }
    const i32 lr = (order == 0) ? log_range_in : std::max(log_range_in - 1, 8);
    const i32 scale = 1 << lr;
    const i64 chunk_size = std::min((i64)chunk_size0 << (8 * order), MAX_CHUNK);
    const i32 dim = (order == 1) ? 256 : 1;
    std::vector<i64> freqs((size_t)dim * 256);
    std::vector<i32> fcap((size_t)dim * 256), cum((size_t)dim * 256);
    std::vector<u8> payload;
    i64 start = 0;
    while (start < count) {
        const i64 end = std::min(start + chunk_size, count);
        const i64 sz = end - start;
        const u8* seg = src + start;
        // statistics
        std::fill(freqs.begin(), freqs.end(), 0);
        if (order == 0) {
            for (i64 i = 0; i < sz; i++) freqs[seg[i]]++;
        } else {
            const i64 q4 = sz & ~3LL;
            const i64 q = q4 >> 2;
            i32 prv = 0;
            for (i64 i = 0; i < q4; i++) {
                if (q > 0 && (i == 0 || i == q || i == 2 * q || i == 3 * q)) prv = 0;
                else if (q == 0 && i == 0) prv = 0;
                freqs[(size_t)prv * 256 + seg[i]]++;
                prv = seg[i];
            }
        }
        S.bits(lr - 8, 3);
        i32 total_alpha = 0;
        for (i32 k = 0; k < dim; k++) {
            i64* f = &freqs[(size_t)k * 256];
            i64 total = 0;
            for (i32 i = 0; i < 256; i++) total += f[i];
            i32 alphabet[256];
            const i32 asize = normalize(f, alphabet, total, scale);
            write_freqs(S, alphabet, asize, f, lr);
            total_alpha += asize;
            i32 sum = 0;
            for (i32 i = 0; i < 256; i++) {
                cum[(size_t)k * 256 + i] = sum;
                sum += (i32)f[i];
                fcap[(size_t)k * 256 + i] = (i32)std::min(f[i], (i64)(scale - 1));
            }
        }
        if (total_alpha <= 1 && order == 0) { start = end; continue; }

        // 4-lane backward encode
        const i64 q4 = sz & ~3LL;
        const i64 q = q4 >> 2;
        payload.clear();
        payload.reserve(sz + 64);
        // leftovers go at the END of the forward payload; we build backward
        std::vector<u8> rev;  // backward bytes (will be reversed)
        rev.reserve(sz + 64);
        for (i64 i = sz - 1; i >= q4; i--) rev.push_back(seg[i]);
        i32 st[4] = {ANS_TOP, ANS_TOP, ANS_TOP, ANS_TOP};
        auto enc_one = [&](i32 lane, i32 ctxv, i32 sym) {
            const i32 f = fcap[(size_t)ctxv * 256 + sym];
            const i32 c = cum[(size_t)ctxv * 256 + sym];
            i32 x = st[lane];
            if ((i64)x >= ((i64)(ANS_TOP >> lr) << 16) * f) {
                rev.push_back((u8)x);
                rev.push_back((u8)(x >> 8));
                x >>= 16;
            }
            const i32 qd = x / f;
            st[lane] = (qd << lr) + (x - qd * f) + c;
        };
        if (order == 0) {
            for (i64 i = q4 - 1; i > 0; i -= 4) {
                enc_one(0, 0, seg[i]);
                enc_one(1, 0, seg[i - 1]);
                enc_one(2, 0, seg[i - 2]);
                enc_one(3, 0, seg[i - 3]);
            }
        } else {
            i64 i0 = 1 * q - 2, i1 = 2 * q - 2, i2 = 3 * q - 2, i3 = q4 - 2;
            i32 prv0 = (q > 0) ? seg[i0 + 1] : 0;
            i32 prv1 = (q > 0) ? seg[i1 + 1] : 0;
            i32 prv2 = (q > 0) ? seg[i2 + 1] : 0;
            i32 prv3 = (q > 0) ? seg[i3 + 1] : 0;
            for (; i0 >= 0; i0--, i1--, i2--, i3--) {
                const i32 c0 = seg[i0]; enc_one(0, c0, prv0);
                const i32 c1 = seg[i1]; enc_one(1, c1, prv1);
                const i32 c2 = seg[i2]; enc_one(2, c2, prv2);
                const i32 c3 = seg[i3]; enc_one(3, c3, prv3);
                prv0 = c0; prv1 = c1; prv2 = c2; prv3 = c3;
            }
            if (q > 0) {
                enc_one(0, 0, prv0);
                enc_one(1, 0, prv1);
                enc_one(2, 0, prv2);
                enc_one(3, 0, prv3);
            }
        }
        S.varint((u32)rev.size());
        for (i32 j = 0; j < 4; j++) S.bits((u32)st[j], 32);
        // forward payload = reverse of rev
        std::reverse(rev.begin(), rev.end());
        S.bytes(rev.data(), (i64)rev.size());
        start = end;
    }
    return S.overflow ? -1 : S.bitpos;
}

// Decode a block of `count` bytes starting at bit `bit_offset` of src.
// Returns bits consumed, or -1 on error.
EXPORT i64 kz_ans_decode(const u8* src, i64 src_bits, i64 bit_offset, u8* dst,
                         i64 count, i32 order, i64 chunk_size0) {
    BitSource S{src, src_bits, bit_offset, false};
    if (count <= 32) {
        S.bytes(dst, count);
        return S.fail ? -1 : S.bitpos - bit_offset;
    }
    const i64 chunk_size = std::min((i64)chunk_size0 << (8 * order), MAX_CHUNK);
    const i32 dim = (order == 1) ? 256 : 1;
    std::vector<i64> freqs((size_t)dim * 256);
    std::vector<i32> fcap((size_t)dim * 256), cum((size_t)dim * 256);
    std::vector<u8> f2s;
    std::vector<u8> buf;
    i64 start = 0;
    while (start < count) {
        const i64 end = std::min(start + chunk_size, count);
        const i64 sz = end - start;
        const i32 lr = (i32)(8 + S.bits(3));
        if (lr < 8 || lr > 15 || S.fail) return -1;
        const i32 scale = 1 << lr;
        f2s.resize((size_t)dim * scale);
        i32 total_alpha = 0;
        i32 single = -1;
        for (i32 k = 0; k < dim; k++) {
            const i32 asize = read_freqs(S, &freqs[(size_t)k * 256], lr);
            if (asize < 0) return -1;
            total_alpha += asize;
            if (k == 0 && asize == 1) {
                for (i32 i = 0; i < 256; i++)
                    if (freqs[i]) single = i;
            }
            i32 sum = 0;
            for (i32 i = 0; i < 256; i++) {
                cum[(size_t)k * 256 + i] = sum;
                const i64 f = freqs[(size_t)k * 256 + i];
                for (i64 j = 0; j < f; j++) f2s[(size_t)k * scale + sum + j] = (u8)i;
                sum += (i32)f;
                fcap[(size_t)k * 256 + i] = (i32)std::min(f, (i64)(scale - 1));
            }
        }
        if (total_alpha == 0) return -1;
        if (order == 0 && total_alpha == 1) {
            std::memset(dst + start, single, sz);
            start = end;
            continue;
        }
        const i64 psz = S.varint();
        if (psz >= MAX_CHUNK || S.fail) return -1;
        i32 st[4];
        for (i32 j = 0; j < 4; j++) st[j] = (i32)S.bits(32);
        buf.resize(psz + 8);
        std::memset(buf.data(), 0, buf.size());
        S.bytes(buf.data(), psz);
        if (S.fail) return -1;
        const i32 mask = scale - 1;
        i64 ptr = 0;
        const i64 buf_end = (i64)buf.size() - 1;   // renorm reads ptr, ptr+1
        const i64 q4 = sz & ~3LL;
        const i64 q = q4 >> 2;
        u8* out = dst + start;
        auto dec_one = [&](i32 lane, i32 ctxv) -> i32 {
            const i32 cur = f2s[(size_t)ctxv * scale + (st[lane] & mask)];
            const i32 f = fcap[(size_t)ctxv * 256 + cur];
            const i32 c = cum[(size_t)ctxv * 256 + cur];
            i32 x = f * ((i32)((u32)st[lane] >> lr)) + (st[lane] & mask) - c;
            if (x < ANS_TOP) {
                // corrupt streams can demand more renorm bytes than the
                // declared payload holds: clamp the cursor (zero feed) and
                // let the final ptr != psz check reject the chunk
                if (ptr < buf_end)
                    x = (x << 16) | ((i32)buf[ptr] << 8) | buf[ptr + 1];
                else
                    x = (x << 16);
                ptr += 2;
            }
            st[lane] = x;
            return cur;
        };
        if (order == 0) {
            for (i64 i = 0; i < q4; i += 4) {
                out[i] = (u8)dec_one(3, 0);
                out[i + 1] = (u8)dec_one(2, 0);
                out[i + 2] = (u8)dec_one(1, 0);
                out[i + 3] = (u8)dec_one(0, 0);
            }
        } else {
            i64 i0 = 0, i1 = q, i2 = 2 * q, i3 = 3 * q;
            i32 prv0 = 0, prv1 = 0, prv2 = 0, prv3 = 0;
            for (; i0 < q; i0++, i1++, i2++, i3++) {
                const i32 c3 = dec_one(3, prv3); out[i3] = (u8)c3;
                const i32 c2 = dec_one(2, prv2); out[i2] = (u8)c2;
                const i32 c1 = dec_one(1, prv1); out[i1] = (u8)c1;
                const i32 c0 = dec_one(0, prv0); out[i0] = (u8)c0;
                prv3 = c3; prv2 = c2; prv1 = c1; prv0 = c0;
            }
        }
        for (i64 i = q4; i < sz; i++) {
            out[i] = (ptr < (i64)buf.size()) ? buf[ptr] : 0;
            ptr++;
        }
        if (ptr != psz) return -1;
        start = end;
    }
    return S.fail ? -1 : S.bitpos - bit_offset;
}
