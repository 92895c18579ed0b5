// kanzi_tpu native runtime kernels (host side).
//
// The device compute path lives in JAX (and native/ans_cuda.cu); this
// library provides the host-side serial kernels that are irreducibly
// sequential per chunk
// (hashes, adaptive binary coders) plus fast helpers for the block engine.
// Exposed as a plain C ABI consumed through ctypes.
//
// Re-derived from the reference semantics:
//   xxhash32/64: K/util/hash/XXHash32.java:94-160, XXHash64.java:95-170

#include <cstdint>
#include <cstring>

#if defined(_MSC_VER)
#define EXPORT extern "C" __declspec(dllexport)
#else
#define EXPORT extern "C" __attribute__((visibility("default")))
#endif

static inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }
static inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

static inline uint32_t read32le(const uint8_t* p) {
    uint32_t v; std::memcpy(&v, p, 4); return v;  // little-endian hosts only
}
static inline uint64_t read64le(const uint8_t* p) {
    uint64_t v; std::memcpy(&v, p, 8); return v;
}

// ---------------- xxhash32 ----------------

static const uint32_t P32_1 = 2654435761u;
static const uint32_t P32_2 = 2246822519u;
static const uint32_t P32_3 = 3266489917u;
static const uint32_t P32_4 = 668265263u;
static const uint32_t P32_5 = 374761393u;

static inline uint32_t xx32_round(uint32_t acc, uint32_t v) {
    return rotl32(acc + v * P32_2, 13) * P32_1;
}

EXPORT uint32_t kz_xxhash32(const uint8_t* data, int64_t length, uint32_t seed) {
    const uint8_t* p = data;
    const uint8_t* end = data + length;
    uint32_t h;
    if (length >= 16) {
        uint32_t v1 = seed + P32_1 + P32_2, v2 = seed + P32_2, v3 = seed, v4 = seed - P32_1;
        const uint8_t* lim = end - 16;
        do {
            v1 = xx32_round(v1, read32le(p));
            v2 = xx32_round(v2, read32le(p + 4));
            v3 = xx32_round(v3, read32le(p + 8));
            v4 = xx32_round(v4, read32le(p + 12));
            p += 16;
        } while (p <= lim);
        h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
    } else {
        h = seed + P32_5;
    }
    h += (uint32_t)length;
    while (p + 4 <= end) {
        h += read32le(p) * P32_3;
        h = rotl32(h, 17) * P32_4;
        p += 4;
    }
    while (p < end) {
        h += (*p) * P32_5;
        h = rotl32(h, 11) * P32_1;
        p++;
    }
    h ^= h >> 15; h *= P32_2;
    h ^= h >> 13; h *= P32_3;
    h ^= h >> 16;
    return h;
}

// ---------------- xxhash64 ----------------

static const uint64_t P64_1 = 0x9E3779B185EBCA87ULL;
static const uint64_t P64_2 = 0xC2B2AE3D27D4EB4FULL;
static const uint64_t P64_3 = 0x165667B19E3779F9ULL;
static const uint64_t P64_4 = 0x85EBCA77C2B2AE63ULL;
static const uint64_t P64_5 = 0x27D4EB2F165667C5ULL;

static inline uint64_t xx64_round(uint64_t acc, uint64_t v) {
    return rotl64(acc + v * P64_2, 31) * P64_1;
}
static inline uint64_t xx64_merge(uint64_t h, uint64_t v) {
    h ^= xx64_round(0, v);
    return h * P64_1 + P64_4;
}

EXPORT uint64_t kz_xxhash64(const uint8_t* data, int64_t length, uint64_t seed) {
    const uint8_t* p = data;
    const uint8_t* end = data + length;
    uint64_t h;
    if (length >= 32) {
        uint64_t v1 = seed + P64_1 + P64_2, v2 = seed + P64_2, v3 = seed, v4 = seed - P64_1;
        const uint8_t* lim = end - 32;
        do {
            v1 = xx64_round(v1, read64le(p));
            v2 = xx64_round(v2, read64le(p + 8));
            v3 = xx64_round(v3, read64le(p + 16));
            v4 = xx64_round(v4, read64le(p + 24));
            p += 32;
        } while (p <= lim);
        // NOTE: the reference uses 32-bit-style shift pairs on 64-bit lanes
        // (XXHash64.java:116-117) — intentionally NOT rotl64.
        h = ((v1 << 1) | (v1 >> 31)) + ((v2 << 7) | (v2 >> 25)) +
            ((v3 << 12) | (v3 >> 20)) + ((v4 << 18) | (v4 >> 14));
        h = xx64_merge(h, v1);
        h = xx64_merge(h, v2);
        h = xx64_merge(h, v3);
        h = xx64_merge(h, v4);
    } else {
        h = seed + P64_5;
    }
    h += (uint64_t)length;
    while (p + 8 <= end) {
        h ^= xx64_round(0, read64le(p));
        h = rotl64(h, 27) * P64_1 + P64_4;
        p += 8;
    }
    while (p + 4 <= end) {
        // sign-extended 32-bit read, as in XXHash64.java:139
        h ^= (uint64_t)((int64_t)(int32_t)read32le(p)) * P64_1;
        h = rotl64(h, 23) * P64_2 + P64_3;
        p += 4;
    }
    while (p < end) {
        h ^= (*p) * P64_5;
        h = rotl64(h, 11) * P64_1;
        p++;
    }
    h ^= h >> 33; h *= P64_2;
    h ^= h >> 29; h *= P64_3;
    h ^= h >> 32;
    return h;
}
