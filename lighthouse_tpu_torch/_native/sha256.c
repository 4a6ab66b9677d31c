/* Batched SHA-256 for the merkleization hot loop.
 *
 * Native analogue of the reference's crypto/eth2_hashing
 * (reference: crypto/eth2_hashing/src/lib.rs:87-177): runtime
 * CPU-feature dispatch between a portable scalar implementation and the
 * x86 SHA-NI extension path. The exported surface is batch-first —
 * `sha256_hash_pairs` hashes n independent 64-byte messages (one merkle
 * tree level) in one call, so Python pays one FFI transition per level
 * instead of one interpreter round-trip per node.
 *
 * Build: cc -O3 -fPIC -shared (the SHA-NI unit is compiled with
 * -msha -msse4.1; it is only ever entered after __builtin_cpu_supports
 * confirms the extension).
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#ifdef __cplusplus
extern "C" {
#endif

#if defined(__x86_64__) || defined(_M_X64)
#define HAVE_X86 1
#include <immintrin.h>
#endif

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};

static const uint32_t IV[8] = {
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
};

/* The constant second block of every 64-byte message:
 * 0x80, zeros, 64-bit big-endian bit length (512). */
static const uint8_t PAD64[64] = {
    0x80, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0,    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0,    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0,    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 0,
};

/* ------------------------------------------------------------------ */
/* Portable scalar compression                                         */
/* ------------------------------------------------------------------ */

#define ROTR(x, n) (((x) >> (n)) | ((x) << (32 - (n))))

static void compress_scalar(uint32_t st[8], const uint8_t block[64]) {
    uint32_t w[64];
    for (int t = 0; t < 16; t++)
        w[t] = ((uint32_t)block[4 * t] << 24) | ((uint32_t)block[4 * t + 1] << 16) |
               ((uint32_t)block[4 * t + 2] << 8) | block[4 * t + 3];
    for (int t = 16; t < 64; t++) {
        uint32_t s0 = ROTR(w[t - 15], 7) ^ ROTR(w[t - 15], 18) ^ (w[t - 15] >> 3);
        uint32_t s1 = ROTR(w[t - 2], 17) ^ ROTR(w[t - 2], 19) ^ (w[t - 2] >> 10);
        w[t] = w[t - 16] + s0 + w[t - 7] + s1;
    }
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
    for (int t = 0; t < 64; t++) {
        uint32_t S1 = ROTR(e, 6) ^ ROTR(e, 11) ^ ROTR(e, 25);
        uint32_t ch = g ^ (e & (f ^ g));
        uint32_t t1 = h + S1 + ch + K[t] + w[t];
        uint32_t S0 = ROTR(a, 2) ^ ROTR(a, 13) ^ ROTR(a, 22);
        uint32_t maj = (a & b) | (c & (a | b));
        uint32_t t2 = S0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

/* ------------------------------------------------------------------ */
/* SHA-NI compression (x86)                                            */
/* ------------------------------------------------------------------ */

#ifdef HAVE_X86

__attribute__((target("sha,sse4.1")))
static inline __m128i sched_ni(__m128i w0, __m128i w1, __m128i w2, __m128i w3) {
    /* W[t..t+3] from the previous four schedule blocks. */
    __m128i t0 = _mm_sha256msg1_epu32(w0, w1);        /* W[t-16..]+s0(W[t-15..]) */
    __m128i t1 = _mm_alignr_epi8(w3, w2, 4);          /* W[t-7..t-4] */
    t0 = _mm_add_epi32(t0, t1);
    return _mm_sha256msg2_epu32(t0, w3);              /* + s1(W[t-2..]) */
}

__attribute__((target("sha,sse4.1")))
static void compress_ni(uint32_t st[8], const uint8_t *block) {
    const __m128i MASK =
        _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);

    __m128i TMP = _mm_loadu_si128((const __m128i *)&st[0]);     /* DCBA */
    __m128i STATE1 = _mm_loadu_si128((const __m128i *)&st[4]);  /* HGFE */
    TMP = _mm_shuffle_epi32(TMP, 0xB1);                         /* CDAB */
    STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);                   /* EFGH */
    __m128i STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);           /* ABEF */
    STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0);                /* CDGH */

    const __m128i ABEF_SAVE = STATE0;
    const __m128i CDGH_SAVE = STATE1;

    __m128i w[4];
    __m128i MSG;
    for (int t = 0; t < 16; t++) {
        __m128i cur;
        if (t < 4) {
            cur = _mm_loadu_si128((const __m128i *)(block + 16 * t));
            cur = _mm_shuffle_epi8(cur, MASK);
        } else {
            cur = sched_ni(w[t % 4], w[(t + 1) % 4], w[(t + 2) % 4], w[(t + 3) % 4]);
        }
        w[t % 4] = cur;
        MSG = _mm_add_epi32(cur, _mm_loadu_si128((const __m128i *)&K[4 * t]));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    }

    STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
    STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);

    TMP = _mm_shuffle_epi32(STATE0, 0x1B);                      /* FEBA */
    STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);                   /* DCHG */
    STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0);                /* DCBA */
    STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);                   /* HGFE */
    _mm_storeu_si128((__m128i *)&st[0], STATE0);
    _mm_storeu_si128((__m128i *)&st[4], STATE1);
}

static int have_sha_ni(void) {
    static int cached = -1;
    if (cached < 0)
        cached = __builtin_cpu_supports("sha") ? 1 : 0;
    return cached;
}

#else
static int have_sha_ni(void) { return 0; }
static void compress_ni(uint32_t st[8], const uint8_t *block) { (void)st; (void)block; }
#endif

/* ------------------------------------------------------------------ */
/* Exports                                                             */
/* ------------------------------------------------------------------ */

static void store_be(uint8_t out[32], const uint32_t st[8]) {
    for (int i = 0; i < 8; i++) {
        out[4 * i] = (uint8_t)(st[i] >> 24);
        out[4 * i + 1] = (uint8_t)(st[i] >> 16);
        out[4 * i + 2] = (uint8_t)(st[i] >> 8);
        out[4 * i + 3] = (uint8_t)st[i];
    }
}

/* n independent 64-byte messages -> n 32-byte digests. */
void sha256_hash_pairs(const uint8_t *in, uint8_t *out, size_t n) {
    if (have_sha_ni()) {
        for (size_t i = 0; i < n; i++) {
            uint32_t st[8];
            memcpy(st, IV, sizeof st);
            compress_ni(st, in + 64 * i);
            compress_ni(st, PAD64);
            store_be(out + 32 * i, st);
        }
    } else {
        for (size_t i = 0; i < n; i++) {
            uint32_t st[8];
            memcpy(st, IV, sizeof st);
            compress_scalar(st, in + 64 * i);
            compress_scalar(st, PAD64);
            store_be(out + 32 * i, st);
        }
    }
}

/* General SHA-256 (arbitrary length), for non-merkle callers. */
void sha256_oneshot(const uint8_t *in, size_t len, uint8_t *out) {
    uint32_t st[8];
    memcpy(st, IV, sizeof st);
    size_t off = 0;
    void (*comp)(uint32_t *, const uint8_t *) =
        have_sha_ni() ? compress_ni : compress_scalar;
    while (len - off >= 64) {
        comp(st, in + off);
        off += 64;
    }
    uint8_t tail[128];
    size_t rem = len - off;
    memcpy(tail, in + off, rem);
    tail[rem] = 0x80;
    size_t tlen = (rem + 9 <= 64) ? 64 : 128;
    memset(tail + rem + 1, 0, tlen - rem - 1 - 8);
    uint64_t bits = (uint64_t)len * 8;
    for (int i = 0; i < 8; i++)
        tail[tlen - 1 - i] = (uint8_t)(bits >> (8 * i));
    comp(st, tail);
    if (tlen == 128)
        comp(st, tail + 64);
    store_be(out, st);
}

int sha256_has_sha_ni(void) { return have_sha_ni(); }

#ifdef __cplusplus
}
#endif
