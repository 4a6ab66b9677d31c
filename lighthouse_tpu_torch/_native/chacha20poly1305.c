/* ChaCha20-Poly1305 AEAD (RFC 8439) for the transport's Noise sessions.
 *
 * Every frame on the wire is sealed with it, so it runs once per gossip
 * message and once per req/resp chunk (a mainnet block is about 1,600
 * ChaCha blocks). The pure-Python twin in ``utils/crypto.py`` gives the
 * same bytes; this file is built at first use by ``_native.build_and_load``.
 *
 *   int lt_aead_seal(key[32], nonce[12], ad, adlen, pt, len, out[len + 16])
 *   int lt_aead_open(key[32], nonce[12], ad, adlen, ct, ctlen, out[ctlen - 16])
 *
 * Both return 0; open returns -1 (and writes nothing) when the tag does not
 * authenticate or ``ctlen`` is shorter than a tag.
 *
 * Poly1305 uses five 26-bit limbs with 64-bit products (the "donna" 32-bit
 * layout), so no 128-bit integer type is needed.
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>

static inline uint32_t rotl32(uint32_t v, int c) { return (v << c) | (v >> (32 - c)); }

static inline uint32_t load32_le(const uint8_t *p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}

static inline void store32_le(uint8_t *p, uint32_t v) {
    p[0] = (uint8_t)v;
    p[1] = (uint8_t)(v >> 8);
    p[2] = (uint8_t)(v >> 16);
    p[3] = (uint8_t)(v >> 24);
}

static inline void store64_le(uint8_t *p, uint64_t v) {
    store32_le(p, (uint32_t)v);
    store32_le(p + 4, (uint32_t)(v >> 32));
}

#define QR(a, b, c, d)                    \
    a += b; d ^= a; d = rotl32(d, 16);    \
    c += d; b ^= c; b = rotl32(b, 12);    \
    a += b; d ^= a; d = rotl32(d, 8);     \
    c += d; b ^= c; b = rotl32(b, 7);

/* One 64-byte ChaCha20 block for (key, counter, nonce) (RFC 8439 §2.3). */
static void chacha20_block(const uint32_t key[8], uint32_t counter, const uint32_t nonce[3],
                           uint8_t out[64]) {
    uint32_t s[16], x[16];
    s[0] = 0x61707865; s[1] = 0x3320646e; s[2] = 0x79622d32; s[3] = 0x6b206574;
    for (int i = 0; i < 8; i++) s[4 + i] = key[i];
    s[12] = counter;
    s[13] = nonce[0]; s[14] = nonce[1]; s[15] = nonce[2];
    memcpy(x, s, sizeof x);
    for (int i = 0; i < 10; i++) {
        QR(x[0], x[4], x[8], x[12]);
        QR(x[1], x[5], x[9], x[13]);
        QR(x[2], x[6], x[10], x[14]);
        QR(x[3], x[7], x[11], x[15]);
        QR(x[0], x[5], x[10], x[15]);
        QR(x[1], x[6], x[11], x[12]);
        QR(x[2], x[7], x[8], x[13]);
        QR(x[3], x[4], x[9], x[14]);
    }
    for (int i = 0; i < 16; i++) store32_le(out + 4 * i, x[i] + s[i]);
}

/* XOR ``len`` bytes of ``in`` with the key stream from block ``counter``. */
static void chacha20_xor(const uint32_t key[8], uint32_t counter, const uint32_t nonce[3],
                         const uint8_t *in, size_t len, uint8_t *out) {
    uint8_t ks[64];
    while (len > 0) {
        size_t n = len < 64 ? len : 64;
        chacha20_block(key, counter++, nonce, ks);
        for (size_t i = 0; i < n; i++) out[i] = in[i] ^ ks[i];
        in += n;
        out += n;
        len -= n;
    }
}

typedef struct {
    uint32_t r[5], h[5], pad[4];
    uint8_t buf[16];
    size_t fill;
} poly1305;

static void poly_init(poly1305 *st, const uint8_t key[32]) {
    /* r is clamped (RFC 8439 §2.5) and split into 26-bit limbs */
    st->r[0] = (load32_le(key + 0)) & 0x3ffffff;
    st->r[1] = (load32_le(key + 3) >> 2) & 0x3ffff03;
    st->r[2] = (load32_le(key + 6) >> 4) & 0x3ffc0ff;
    st->r[3] = (load32_le(key + 9) >> 6) & 0x3f03fff;
    st->r[4] = (load32_le(key + 12) >> 8) & 0x00fffff;
    for (int i = 0; i < 5; i++) st->h[i] = 0;
    for (int i = 0; i < 4; i++) st->pad[i] = load32_le(key + 16 + 4 * i);
    st->fill = 0;
}

/* h = (h + m) * r mod 2^130 - 5 for each 16-byte block; ``hibit`` is 2^128
 * in limb 4 for a full block, 0 for the padded final one. */
static void poly_blocks(poly1305 *st, const uint8_t *m, size_t len, uint32_t hibit) {
    const uint32_t r0 = st->r[0], r1 = st->r[1], r2 = st->r[2], r3 = st->r[3], r4 = st->r[4];
    const uint32_t s1 = r1 * 5, s2 = r2 * 5, s3 = r3 * 5, s4 = r4 * 5;
    uint32_t h0 = st->h[0], h1 = st->h[1], h2 = st->h[2], h3 = st->h[3], h4 = st->h[4];
    while (len >= 16) {
        h0 += (load32_le(m + 0)) & 0x3ffffff;
        h1 += (load32_le(m + 3) >> 2) & 0x3ffffff;
        h2 += (load32_le(m + 6) >> 4) & 0x3ffffff;
        h3 += (load32_le(m + 9) >> 6) & 0x3ffffff;
        h4 += (load32_le(m + 12) >> 8) | hibit;
        uint64_t d0 = (uint64_t)h0 * r0 + (uint64_t)h1 * s4 + (uint64_t)h2 * s3 +
                      (uint64_t)h3 * s2 + (uint64_t)h4 * s1;
        uint64_t d1 = (uint64_t)h0 * r1 + (uint64_t)h1 * r0 + (uint64_t)h2 * s4 +
                      (uint64_t)h3 * s3 + (uint64_t)h4 * s2;
        uint64_t d2 = (uint64_t)h0 * r2 + (uint64_t)h1 * r1 + (uint64_t)h2 * r0 +
                      (uint64_t)h3 * s4 + (uint64_t)h4 * s3;
        uint64_t d3 = (uint64_t)h0 * r3 + (uint64_t)h1 * r2 + (uint64_t)h2 * r1 +
                      (uint64_t)h3 * r0 + (uint64_t)h4 * s4;
        uint64_t d4 = (uint64_t)h0 * r4 + (uint64_t)h1 * r3 + (uint64_t)h2 * r2 +
                      (uint64_t)h3 * r1 + (uint64_t)h4 * r0;
        uint32_t c;
        c = (uint32_t)(d0 >> 26); h0 = (uint32_t)d0 & 0x3ffffff;
        d1 += c; c = (uint32_t)(d1 >> 26); h1 = (uint32_t)d1 & 0x3ffffff;
        d2 += c; c = (uint32_t)(d2 >> 26); h2 = (uint32_t)d2 & 0x3ffffff;
        d3 += c; c = (uint32_t)(d3 >> 26); h3 = (uint32_t)d3 & 0x3ffffff;
        d4 += c; c = (uint32_t)(d4 >> 26); h4 = (uint32_t)d4 & 0x3ffffff;
        h0 += c * 5; c = h0 >> 26; h0 &= 0x3ffffff;
        h1 += c;
        m += 16;
        len -= 16;
    }
    st->h[0] = h0; st->h[1] = h1; st->h[2] = h2; st->h[3] = h3; st->h[4] = h4;
}

static void poly_update(poly1305 *st, const uint8_t *m, size_t len) {
    if (st->fill) {
        size_t want = 16 - st->fill;
        if (want > len) want = len;
        memcpy(st->buf + st->fill, m, want);
        st->fill += want;
        m += want;
        len -= want;
        if (st->fill < 16) return;
        poly_blocks(st, st->buf, 16, 1u << 24);
        st->fill = 0;
    }
    size_t whole = len & ~(size_t)15;
    if (whole) {
        poly_blocks(st, m, whole, 1u << 24);
        m += whole;
        len -= whole;
    }
    if (len) {
        memcpy(st->buf, m, len);
        st->fill = len;
    }
}

/* Zero bytes up to the next 16-byte boundary of the MAC input (§2.8). */
static void poly_pad16(poly1305 *st) {
    static const uint8_t zeros[16] = {0};
    if (st->fill) poly_update(st, zeros, 16 - st->fill);
}

static void poly_finish(poly1305 *st, uint8_t tag[16]) {
    if (st->fill) {  /* a short final block: 0x01 then zeros, no 2^128 bit */
        st->buf[st->fill] = 1;
        for (size_t i = st->fill + 1; i < 16; i++) st->buf[i] = 0;
        poly_blocks(st, st->buf, 16, 0);
    }
    uint32_t h0 = st->h[0], h1 = st->h[1], h2 = st->h[2], h3 = st->h[3], h4 = st->h[4];
    uint32_t c;
    c = h1 >> 26; h1 &= 0x3ffffff;
    h2 += c; c = h2 >> 26; h2 &= 0x3ffffff;
    h3 += c; c = h3 >> 26; h3 &= 0x3ffffff;
    h4 += c; c = h4 >> 26; h4 &= 0x3ffffff;
    h0 += c * 5; c = h0 >> 26; h0 &= 0x3ffffff;
    h1 += c;
    /* g = h + 5 - 2^130; take g when it does not borrow */
    uint32_t g0 = h0 + 5; c = g0 >> 26; g0 &= 0x3ffffff;
    uint32_t g1 = h1 + c; c = g1 >> 26; g1 &= 0x3ffffff;
    uint32_t g2 = h2 + c; c = g2 >> 26; g2 &= 0x3ffffff;
    uint32_t g3 = h3 + c; c = g3 >> 26; g3 &= 0x3ffffff;
    uint32_t g4 = h4 + c - (1u << 26);
    uint32_t mask = (g4 >> 31) - 1;  /* all ones when g4 did not borrow */
    h0 = (h0 & ~mask) | (g0 & mask);
    h1 = (h1 & ~mask) | (g1 & mask);
    h2 = (h2 & ~mask) | (g2 & mask);
    h3 = (h3 & ~mask) | (g3 & mask);
    h4 = (h4 & ~mask) | (g4 & mask);
    /* h mod 2^128 as four 32-bit words, plus the pad */
    uint32_t w0 = h0 | (h1 << 26);
    uint32_t w1 = (h1 >> 6) | (h2 << 20);
    uint32_t w2 = (h2 >> 12) | (h3 << 14);
    uint32_t w3 = (h3 >> 18) | (h4 << 8);
    uint64_t f;
    f = (uint64_t)w0 + st->pad[0]; store32_le(tag + 0, (uint32_t)f);
    f = (uint64_t)w1 + st->pad[1] + (f >> 32); store32_le(tag + 4, (uint32_t)f);
    f = (uint64_t)w2 + st->pad[2] + (f >> 32); store32_le(tag + 8, (uint32_t)f);
    f = (uint64_t)w3 + st->pad[3] + (f >> 32); store32_le(tag + 12, (uint32_t)f);
}

static void setup(const uint8_t *key, const uint8_t *nonce, uint32_t k[8], uint32_t n[3],
                  poly1305 *st) {
    uint8_t otk[64];
    for (int i = 0; i < 8; i++) k[i] = load32_le(key + 4 * i);
    for (int i = 0; i < 3; i++) n[i] = load32_le(nonce + 4 * i);
    chacha20_block(k, 0, n, otk);  /* the one-time Poly1305 key (§2.6) */
    poly_init(st, otk);
}

static void mac(poly1305 *st, const uint8_t *ad, size_t adlen, const uint8_t *ct, size_t len,
                uint8_t tag[16]) {
    uint8_t lens[16];
    poly_update(st, ad, adlen);
    poly_pad16(st);
    poly_update(st, ct, len);
    poly_pad16(st);
    store64_le(lens, (uint64_t)adlen);
    store64_le(lens + 8, (uint64_t)len);
    poly_update(st, lens, 16);
    poly_finish(st, tag);
}

int lt_aead_seal(const uint8_t *key, const uint8_t *nonce, const uint8_t *ad, size_t adlen,
                 const uint8_t *pt, size_t len, uint8_t *out) {
    uint32_t k[8], n[3];
    poly1305 st;
    setup(key, nonce, k, n, &st);
    chacha20_xor(k, 1, n, pt, len, out);
    mac(&st, ad, adlen, out, len, out + len);
    return 0;
}

int lt_aead_open(const uint8_t *key, const uint8_t *nonce, const uint8_t *ad, size_t adlen,
                 const uint8_t *ct, size_t ctlen, uint8_t *out) {
    uint32_t k[8], n[3];
    poly1305 st;
    uint8_t tag[16];
    if (ctlen < 16) return -1;
    size_t len = ctlen - 16;
    setup(key, nonce, k, n, &st);
    mac(&st, ad, adlen, ct, len, tag);
    uint8_t diff = 0;  /* compared in constant time */
    for (int i = 0; i < 16; i++) diff |= tag[i] ^ ct[len + i];
    if (diff) return -1;
    chacha20_xor(k, 1, n, ct, len, out);
    return 0;
}
