// Native host-side runtime kernels for kanter_core_tpu.
//
// The reference implements its whole runtime in native (Rust) code; the
// JAX rebuild keeps compute on the device, but three host paths stay hot
// and byte-oriented, so they live here as a small C++ library loaded via
// ctypes (plain C ABI, no Python headers needed):
//
//  - salted_hash64: spill-file integrity hash (reference: salted
//    DefaultHasher over every pixel, `transient_buffer.rs:98-133`). An
//    XXH64-style mixing function, ~an order of magnitude faster than
//    feeding 67 MB planes through hashlib.
//  - pack_rgba_u8 / pack_gray_u8: f32 → u8 export with the exact reference
//    semantics (clamp to [0,1], NaN→255, truncating cast,
//    `slot_image.rs:142-170`) for host-resident planes.
//  - planes_from_u8: interleaved u8 decode → separate f32 planes (/255),
//    mirroring `deconstruct_image` (`shared.rs:16-56`).
//
// Build: g++ -O3 -march=native -shared -fPIC -o _kanter_native.so kanter_native.cpp

#include <cstdint>
#include <cstddef>
#include <cmath>
#include <cstring>

extern "C" {

// ---- XXH64-style 64-bit hash (algorithm per the public xxHash spec) ----
static const uint64_t P1 = 11400714785074694791ULL;
static const uint64_t P2 = 14029467366897019727ULL;
static const uint64_t P3 = 1609587929392839161ULL;
static const uint64_t P4 = 9650029242287828579ULL;
static const uint64_t P5 = 2870177450012600261ULL;

static inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

static inline uint64_t round64(uint64_t acc, uint64_t input) {
    acc += input * P2;
    acc = rotl64(acc, 31);
    acc *= P1;
    return acc;
}

static inline uint64_t merge_round(uint64_t acc, uint64_t val) {
    val = round64(0, val);
    acc ^= val;
    acc = acc * P1 + P4;
    return acc;
}

static inline uint64_t read64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
}

static inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

uint64_t salted_hash64(const uint8_t* data, size_t len, uint64_t seed) {
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    uint64_t h;

    if (len >= 32) {
        uint64_t v1 = seed + P1 + P2;
        uint64_t v2 = seed + P2;
        uint64_t v3 = seed + 0;
        uint64_t v4 = seed - P1;
        const uint8_t* limit = end - 32;
        do {
            v1 = round64(v1, read64(p)); p += 8;
            v2 = round64(v2, read64(p)); p += 8;
            v3 = round64(v3, read64(p)); p += 8;
            v4 = round64(v4, read64(p)); p += 8;
        } while (p <= limit);
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
        h = merge_round(h, v1);
        h = merge_round(h, v2);
        h = merge_round(h, v3);
        h = merge_round(h, v4);
    } else {
        h = seed + P5;
    }

    h += (uint64_t)len;
    while (p + 8 <= end) {
        h ^= round64(0, read64(p));
        h = rotl64(h, 27) * P1 + P4;
        p += 8;
    }
    if (p + 4 <= end) {
        h ^= (uint64_t)read32(p) * P1;
        h = rotl64(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= (*p) * P5;
        h = rotl64(h, 11) * P1;
        p++;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

// ---- f32 → u8 export (reference semantics, `slot_image.rs:142-144`) ----
static inline uint8_t f32_to_u8(float v) {
    // clamp(0,1): NaN stays NaN (Rust clamp), * 255 → NaN, .min(255) → 255
    float c = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
    float scaled = c * 255.0f;
    if (std::isnan(scaled)) return 255;
    if (scaled > 255.0f) scaled = 255.0f;
    return (uint8_t)scaled;  // truncating cast, matches Rust `as u8`
}

void pack_rgba_u8(const float* r, const float* g, const float* b,
                  const float* a, size_t n, uint8_t* out) {
    for (size_t i = 0; i < n; i++) {
        out[4 * i + 0] = f32_to_u8(r[i]);
        out[4 * i + 1] = f32_to_u8(g[i]);
        out[4 * i + 2] = f32_to_u8(b[i]);
        out[4 * i + 3] = f32_to_u8(a[i]);
    }
}

void pack_gray_u8(const float* gray, size_t n, uint8_t* out) {
    for (size_t i = 0; i < n; i++) {
        uint8_t v = f32_to_u8(gray[i]);
        out[4 * i + 0] = v;
        out[4 * i + 1] = v;
        out[4 * i + 2] = v;
        out[4 * i + 3] = 255;
    }
}

// ---- interleaved u8 → f32 planes (`shared.rs:16-56`) ----
// channels ∈ {1,2,3,4}; missing channels default to 0.0, alpha to 1.0.
// Each sample is one IEEE f32 division by 255.0 (exact reference math).
void planes_from_u8(const uint8_t* pixels, size_t npx, int channels,
                    float* p0, float* p1, float* p2, float* p3) {
    float* planes[4] = {p0, p1, p2, p3};
    for (size_t i = 0; i < npx; i++) {
        for (int c = 0; c < channels; c++) {
            planes[c][i] = (float)pixels[i * channels + c] / 255.0f;
        }
    }
    for (int c = channels; c < 4; c++) {
        float fill = (c == 3) ? 1.0f : 0.0f;
        for (size_t i = 0; i < npx; i++) planes[c][i] = fill;
    }
}

}  // extern "C"
