/* The benchmark's input maker: a frozen copy of the port's C BLS12-381
 * library (bls12381.c, included whole and unchanged) plus two bulk entry
 * points, so that the inputs of a run do not move when the program does.
 *
 *   bench_g1_range  the registry: [s0 + i] G1 for i < n, by Jacobian
 *                   additions of G and one batch inversion;
 *   bench_sign_many [s_j] H(msg) for many scalars over one message: the
 *                   message is hashed to G2 once, and with four or more
 *                   scalars a table of [d 16^w] H(msg) turns each scalar
 *                   multiplication into 64 additions.
 *
 * Build: cc -O3 -fPIC -shared bench_inputs.c (the directory holds the
 * included source and its tables header).
 */

#include <stdlib.h>

#include "bls12381.c"

static void bench_fp_to_be(uint8_t out[48], const fp *a) { fp_to_bytes(out, a); }

/* out: n * 96 bytes, raw affine x || y (48 + 48 big-endian) of [s0 + i] G1.
 * Requires s0 >= 1 and s0 + n below the group order (no point is
 * infinity and no addition meets a doubling for s0 >= 2). */
int bench_g1_range(uint64_t s0, uint32_t n, uint8_t *out) {
    ensure_init();
    if (n == 0) return 1;
    if (s0 < 1) return 0;
    g1p *pts = (g1p *)malloc(sizeof(g1p) * (size_t)n);
    fp *prefix = (fp *)malloc(sizeof(fp) * (size_t)n);
    if (!pts || !prefix) { free(pts); free(prefix); return 0; }
    g1p g, p;
    g1_from_affine(&g, &G1_GEN);
    /* p = [s0] G */
    uint64_t e[1] = {s0};
    g1_mul(&p, &g, e, 1);
    for (uint32_t i = 0; i < n; i++) {
        pts[i] = p;
        if (i + 1 < n) {
            if (s0 + i == 1) g1_dbl(&p, &p);
            else g1_add(&p, &p, &g);
        }
    }
    fp acc = FP_ONE;
    for (uint32_t i = 0; i < n; i++) {
        prefix[i] = acc;
        fp_mul(&acc, &acc, &pts[i].z);
    }
    fp inv;
    fp_inv(&inv, &acc);
    for (uint32_t k = n; k-- > 0;) {
        fp zi, zi2, zi3, x, y;
        fp_mul(&zi, &inv, &prefix[k]);
        fp_mul(&inv, &inv, &pts[k].z);
        fp_sqr(&zi2, &zi);
        fp_mul(&zi3, &zi2, &zi);
        fp_mul(&x, &pts[k].x, &zi2);
        fp_mul(&y, &pts[k].y, &zi3);
        bench_fp_to_be(out + 96 * (size_t)k, &x);
        bench_fp_to_be(out + 96 * (size_t)k + 48, &y);
    }
    free(pts);
    free(prefix);
    return 1;
}

/* 32 big-endian bytes -> four little-endian limbs */
static void bench_scalar_limbs(uint64_t e[4], const uint8_t be[32]) {
    for (int i = 0; i < 4; i++) {
        e[i] = 0;
        for (int j = 0; j < 8; j++)
            e[i] |= (uint64_t)be[32 - 8 * (i + 1) + (7 - j)] << (8 * j);
    }
}

/* scalars: n * 32 big-endian bytes (reduced mod r by the caller);
 * out: n * 96 bytes, the compressed signatures [s_j] H(msg). */
int bench_sign_many(const uint8_t *msg, uint32_t msg_len,
                    const uint8_t *dst, uint32_t dst_len,
                    uint32_t n, const uint8_t *scalars, uint8_t *out) {
    ensure_init();
    g2a h;
    hash_to_g2(&h, msg, msg_len, dst, dst_len);
    g2p base;
    g2_from_affine(&base, &h);
    g2p *table = NULL;
    if (n >= 4) {
        /* table[w * 16 + d] = [d 16^w] H, w < 64, d < 16 */
        table = (g2p *)malloc(sizeof(g2p) * 64 * 16);
        if (!table) return 0;
        g2p b = base;
        for (int w = 0; w < 64; w++) {
            g2_set_inf(&table[w * 16]);
            table[w * 16 + 1] = b;
            for (int d = 2; d < 16; d++) {
                if (d == 2) g2_dbl(&table[w * 16 + 2], &b);
                else g2_add(&table[w * 16 + d], &table[w * 16 + d - 1], &b);
            }
            g2_dbl(&b, &table[w * 16 + 8]);  /* [16^(w+1)] H */
        }
    }
    for (uint32_t j = 0; j < n; j++) {
        uint64_t e[4];
        bench_scalar_limbs(e, scalars + 32 * (size_t)j);
        g2p s;
        g2_set_inf(&s);
        if (table) {
            for (int w = 0; w < 64; w++) {
                int d = (int)((e[w / 16] >> (4 * (w % 16))) & 15);
                if (d) g2_add(&s, &s, &table[w * 16 + d]);
            }
        } else {
            int started = 0;
            for (int i = 3; i >= 0; i--)
                for (int b = 63; b >= 0; b--) {
                    if (started) g2_dbl(&s, &s);
                    if ((e[i] >> b) & 1) {
                        if (!started) { s = base; started = 1; }
                        else g2_add(&s, &s, &base);
                    }
                }
        }
        g2a sa;
        g2_to_affine(&sa, &s);
        g2_compress(out + 96 * (size_t)j, &sa);
    }
    free(table);
    return 1;
}
