/* Native BLS12-381 batch signature-set verification (backend "cpu-native").
 *
 * This is the blst-class CPU baseline the TPU backend is measured against
 * (BASELINE.md; the reference's default backend is
 * crypto/bls/src/impls/blst.rs:36-119 — random-linear-
 * combination batching over an aggregated Miller loop). Everything here is
 * an independent implementation: Montgomery 6x64 field arithmetic (CIOS),
 * the 2-3-2 tower, Jacobian curve ops, an aggregated optimal-ate Miller
 * loop with sparse line multiplication, the machine-checked x-chain final
 * exponentiation (same chain as crypto/device/pairing.py), RFC 9380
 * hash-to-curve for G2, and the batch verification equation
 *
 *   prod_i e([r_i] agg_pk_i, H(m_i)) * e(-g1, sum_i [r_i] sig_i) == 1.
 *
 * Curve constants are generated from the repo's own params by
 * tools/gen_bls_c_tables.py into bls12381_tables.h.
 *
 * Build: cc -O3 -fPIC -shared bls12381.c (needs __uint128_t; x86-64/ARM64).
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#include "bls12381_tables.h"

#ifdef __cplusplus
extern "C" {
#endif

typedef unsigned __int128 u128;

/* ===================================================================== */
/* fp: 6x64 Montgomery                                                    */
/* ===================================================================== */

typedef struct { uint64_t l[6]; } fp;

static fp FP_ZERO;          /* 0 */
static fp FP_ONE;           /* R mod p (Montgomery 1) */
static fp FP_R2;            /* 2^768 mod p */

static inline int fp_is_zero(const fp *a) {
    uint64_t v = 0;
    for (int i = 0; i < 6; i++) v |= a->l[i];
    return v == 0;
}

static inline int fp_eq(const fp *a, const fp *b) {
    uint64_t v = 0;
    for (int i = 0; i < 6; i++) v |= a->l[i] ^ b->l[i];
    return v == 0;
}

/* a >= p ? */
static inline int fp_ge_p(const fp *a) {
    for (int i = 5; i >= 0; i--) {
        if (a->l[i] > BLS_P[i]) return 1;
        if (a->l[i] < BLS_P[i]) return 0;
    }
    return 1; /* equal */
}

static inline void fp_sub_p(fp *a) {
    u128 bw = 0;
    for (int i = 0; i < 6; i++) {
        u128 t = (u128)a->l[i] - BLS_P[i] - bw;
        a->l[i] = (uint64_t)t;
        bw = (t >> 64) & 1; /* borrow */
    }
}

static void fp_add(fp *o, const fp *a, const fp *b) {
    u128 c = 0;
    for (int i = 0; i < 6; i++) {
        c += (u128)a->l[i] + b->l[i];
        o->l[i] = (uint64_t)c;
        c >>= 64;
    }
    if (c || fp_ge_p(o)) fp_sub_p(o);
}

static void fp_sub(fp *o, const fp *a, const fp *b) {
    u128 bw = 0;
    for (int i = 0; i < 6; i++) {
        u128 t = (u128)a->l[i] - b->l[i] - bw;
        o->l[i] = (uint64_t)t;
        bw = (t >> 64) & 1;
    }
    if (bw) { /* += p */
        u128 c = 0;
        for (int i = 0; i < 6; i++) {
            c += (u128)o->l[i] + BLS_P[i];
            o->l[i] = (uint64_t)c;
            c >>= 64;
        }
    }
}

static void fp_neg(fp *o, const fp *a) {
    if (fp_is_zero(a)) { *o = *a; return; }
    fp z = FP_ZERO;
    fp_sub(o, &z, a);
}

static void fp_dbl(fp *o, const fp *a) { fp_add(o, a, a); }

/* Montgomery CIOS multiplication: o = a*b*R^-1 mod p */
static void fp_mul(fp *o, const fp *a, const fp *b) {
    uint64_t t[8] = {0};
    for (int i = 0; i < 6; i++) {
        u128 c = 0;
        uint64_t ai = a->l[i];
        for (int j = 0; j < 6; j++) {
            c = (u128)ai * b->l[j] + t[j] + (uint64_t)c;
            t[j] = (uint64_t)c;
            c >>= 64;
        }
        c = (u128)t[6] + (uint64_t)c;
        t[6] = (uint64_t)c;
        t[7] = (uint64_t)(c >> 64);

        uint64_t m = t[0] * BLS_PINV;
        c = (u128)m * BLS_P[0] + t[0];
        c >>= 64;
        for (int j = 1; j < 6; j++) {
            c = (u128)m * BLS_P[j] + t[j] + (uint64_t)c;
            t[j - 1] = (uint64_t)c;
            c >>= 64;
        }
        c = (u128)t[6] + (uint64_t)c;
        t[5] = (uint64_t)c;
        t[6] = t[7] + (uint64_t)(c >> 64);
        t[7] = 0;
    }
    for (int i = 0; i < 6; i++) o->l[i] = t[i];
    if (t[6] || fp_ge_p(o)) fp_sub_p(o);
}

static void fp_sqr(fp *o, const fp *a) { fp_mul(o, a, a); }

static void fp_from_raw(fp *o, const uint64_t raw[6]) {
    fp t;
    for (int i = 0; i < 6; i++) t.l[i] = raw[i];
    fp_mul(o, &t, &FP_R2); /* to Montgomery */
}

static void fp_to_raw(uint64_t raw[6], const fp *a) {
    fp one = {{1, 0, 0, 0, 0, 0}};
    fp t;
    fp_mul(&t, a, &one); /* from Montgomery */
    for (int i = 0; i < 6; i++) raw[i] = t.l[i];
}

/* generic fixed-window-free pow: e is n_limbs little-endian (raw int) */
static void fp_pow(fp *o, const fp *a, const uint64_t *e, int n_limbs) {
    fp acc = FP_ONE;
    int started = 0;
    for (int i = n_limbs - 1; i >= 0; i--) {
        for (int b = 63; b >= 0; b--) {
            if (started) fp_sqr(&acc, &acc);
            if ((e[i] >> b) & 1) {
                if (!started) { acc = *a; started = 1; }
                else fp_mul(&acc, &acc, a);
            }
        }
    }
    *o = started ? acc : FP_ONE;
}

static void fp_inv(fp *o, const fp *a) { fp_pow(o, a, BLS_P_MINUS_2, 6); }

/* sqrt for p = 3 mod 4: a^((p+1)/4); returns 0 if a is not a square */
static int fp_sqrt(fp *o, const fp *a) {
    fp r, chk;
    fp_pow(&r, a, BLS_P_PLUS_1_DIV_4, 6);
    fp_sqr(&chk, &r);
    if (!fp_eq(&chk, a)) return 0;
    *o = r;
    return 1;
}

/* canonical big-endian 48-byte IO */
static void fp_to_bytes(uint8_t out[48], const fp *a) {
    uint64_t raw[6];
    fp_to_raw(raw, a);
    for (int i = 0; i < 6; i++)
        for (int j = 0; j < 8; j++)
            out[48 - 8 * (i + 1) + (7 - j)] = (uint8_t)(raw[i] >> (8 * j));
}

static int fp_from_bytes(fp *o, const uint8_t in[48]) {
    uint64_t raw[6] = {0};
    for (int i = 0; i < 6; i++)
        for (int j = 0; j < 8; j++)
            raw[i] |= (uint64_t)in[48 - 8 * (i + 1) + (7 - j)] << (8 * j);
    /* must be < p */
    for (int i = 5; i >= 0; i--) {
        if (raw[i] < BLS_P[i]) break;
        if (raw[i] > BLS_P[i]) return 0;
        if (i == 0) return 0; /* == p */
    }
    fp_from_raw(o, raw);
    return 1;
}

/* lexicographic compare of canonical values: sign of a - b */
static int fp_cmp(const fp *a, const fp *b) {
    uint64_t ra[6], rb[6];
    fp_to_raw(ra, a);
    fp_to_raw(rb, b);
    for (int i = 5; i >= 0; i--) {
        if (ra[i] > rb[i]) return 1;
        if (ra[i] < rb[i]) return -1;
    }
    return 0;
}

static int fp_sgn0(const fp *a) {
    uint64_t raw[6];
    fp_to_raw(raw, a);
    return (int)(raw[0] & 1);
}

/* ===================================================================== */
/* fp2 = fp[u]/(u^2+1)                                                    */
/* ===================================================================== */

typedef struct { fp c0, c1; } fp2;

static fp2 FP2_ZERO, FP2_ONE;

static inline int fp2_is_zero(const fp2 *a) { return fp_is_zero(&a->c0) && fp_is_zero(&a->c1); }
static inline int fp2_eq(const fp2 *a, const fp2 *b) { return fp_eq(&a->c0, &b->c0) && fp_eq(&a->c1, &b->c1); }

static void fp2_add(fp2 *o, const fp2 *a, const fp2 *b) { fp_add(&o->c0, &a->c0, &b->c0); fp_add(&o->c1, &a->c1, &b->c1); }
static void fp2_sub(fp2 *o, const fp2 *a, const fp2 *b) { fp_sub(&o->c0, &a->c0, &b->c0); fp_sub(&o->c1, &a->c1, &b->c1); }
static void fp2_neg(fp2 *o, const fp2 *a) { fp_neg(&o->c0, &a->c0); fp_neg(&o->c1, &a->c1); }
static void fp2_dbl(fp2 *o, const fp2 *a) { fp2_add(o, a, a); }
static void fp2_conj(fp2 *o, const fp2 *a) { o->c0 = a->c0; fp_neg(&o->c1, &a->c1); }

/* Karatsuba: 3 fp muls */
static void fp2_mul(fp2 *o, const fp2 *a, const fp2 *b) {
    fp aa, bb, t0, t1, t2;
    fp_mul(&aa, &a->c0, &b->c0);
    fp_mul(&bb, &a->c1, &b->c1);
    fp_add(&t0, &a->c0, &a->c1);
    fp_add(&t1, &b->c0, &b->c1);
    fp_mul(&t2, &t0, &t1);
    fp_sub(&t2, &t2, &aa);
    fp_sub(&t2, &t2, &bb);
    fp_sub(&o->c0, &aa, &bb);
    o->c1 = t2;
}

static void fp2_sqr(fp2 *o, const fp2 *a) {
    /* (c0+c1 u)^2 = (c0+c1)(c0-c1) + 2 c0 c1 u */
    fp s, d, m;
    fp_add(&s, &a->c0, &a->c1);
    fp_sub(&d, &a->c0, &a->c1);
    fp_mul(&m, &a->c0, &a->c1);
    fp_mul(&o->c0, &s, &d);
    fp_dbl(&o->c1, &m);
}

static void fp2_mul_fp(fp2 *o, const fp2 *a, const fp *s) {
    fp_mul(&o->c0, &a->c0, s);
    fp_mul(&o->c1, &a->c1, s);
}

/* multiply by the non-residue xi = u + 1: (c0+c1u)(1+u) = c0-c1 + (c0+c1)u */
static void fp2_mul_xi(fp2 *o, const fp2 *a) {
    fp t0, t1;
    fp_sub(&t0, &a->c0, &a->c1);
    fp_add(&t1, &a->c0, &a->c1);
    o->c0 = t0;
    o->c1 = t1;
}

static void fp2_inv(fp2 *o, const fp2 *a) {
    fp t0, t1;
    fp_sqr(&t0, &a->c0);
    fp_sqr(&t1, &a->c1);
    fp_add(&t0, &t0, &t1);
    fp_inv(&t0, &t0);
    fp_mul(&o->c0, &a->c0, &t0);
    fp_mul(&t1, &a->c1, &t0);
    fp_neg(&o->c1, &t1);
}

static void fp2_pow(fp2 *o, const fp2 *a, const uint64_t *e, int n_limbs) {
    fp2 acc = FP2_ONE;
    int started = 0;
    for (int i = n_limbs - 1; i >= 0; i--) {
        for (int b = 63; b >= 0; b--) {
            if (started) fp2_sqr(&acc, &acc);
            if ((e[i] >> b) & 1) {
                if (!started) { acc = *a; started = 1; }
                else fp2_mul(&acc, &acc, a);
            }
        }
    }
    *o = started ? acc : FP2_ONE;
}

/* sqrt in Fp2 for p = 3 mod 4 (Adj-Rodriguez alg. 9); 0 if not square */
static int fp2_sqrt(fp2 *o, const fp2 *a) {
    if (fp2_is_zero(a)) { *o = FP2_ZERO; return 1; }
    fp2 a1, alpha, x0, t, neg1;
    fp2_pow(&a1, a, BLS_P_MINUS_3_DIV_4, 6);
    fp2_sqr(&alpha, &a1);
    fp2_mul(&alpha, &alpha, a);
    fp2_mul(&x0, &a1, a);
    neg1 = FP2_ONE;
    fp2_neg(&neg1, &neg1);
    if (fp2_eq(&alpha, &neg1)) {
        /* x = u * x0 */
        fp_neg(&o->c0, &x0.c1);
        o->c1 = x0.c0;
    } else {
        fp2_add(&t, &alpha, &FP2_ONE);
        fp2_pow(&t, &t, BLS_P_MINUS_1_DIV_2, 6);
        fp2_mul(o, &t, &x0);
    }
    fp2_sqr(&t, o);
    return fp2_eq(&t, a);
}

static int fp2_sgn0(const fp2 *a) {
    /* RFC 9380 sgn0 for m=2 */
    int s0 = fp_sgn0(&a->c0);
    int z0 = fp_is_zero(&a->c0);
    int s1 = fp_sgn0(&a->c1);
    return s0 | (z0 & s1);
}

/* lexicographically larger rule for compressed-point sign: compare (c1, c0) */
static int fp2_lex_gt(const fp2 *a, const fp2 *b) {
    int c = fp_cmp(&a->c1, &b->c1);
    if (c != 0) return c > 0;
    return fp_cmp(&a->c0, &b->c0) > 0;
}

static void fp2_from_raw(fp2 *o, const fp2_raw *r) {
    fp_from_raw(&o->c0, r->c0.l);
    fp_from_raw(&o->c1, r->c1.l);
}

/* ===================================================================== */
/* fp6 = fp2[v]/(v^3 - xi),  fp12 = fp6[w]/(w^2 - v)                      */
/* ===================================================================== */

typedef struct { fp2 c0, c1, c2; } fp6;
typedef struct { fp6 c0, c1; } fp12;

static void fp6_add(fp6 *o, const fp6 *a, const fp6 *b) { fp2_add(&o->c0, &a->c0, &b->c0); fp2_add(&o->c1, &a->c1, &b->c1); fp2_add(&o->c2, &a->c2, &b->c2); }
static void fp6_sub(fp6 *o, const fp6 *a, const fp6 *b) { fp2_sub(&o->c0, &a->c0, &b->c0); fp2_sub(&o->c1, &a->c1, &b->c1); fp2_sub(&o->c2, &a->c2, &b->c2); }
static void fp6_neg(fp6 *o, const fp6 *a) { fp2_neg(&o->c0, &a->c0); fp2_neg(&o->c1, &a->c1); fp2_neg(&o->c2, &a->c2); }
static int fp6_is_zero(const fp6 *a) { return fp2_is_zero(&a->c0) && fp2_is_zero(&a->c1) && fp2_is_zero(&a->c2); }

/* multiply by v: (c0, c1, c2) -> (xi*c2, c0, c1) */
static void fp6_mul_v(fp6 *o, const fp6 *a) {
    fp2 t;
    fp2_mul_xi(&t, &a->c2);
    o->c2 = a->c1;
    o->c1 = a->c0;
    o->c0 = t;
}

static void fp6_mul(fp6 *o, const fp6 *a, const fp6 *b) {
    /* schoolbook with xi folds (6 fp2 muls via Toom-ish grouping kept
     * simple: 9 muls schoolbook — clarity over the last 15%) */
    fp2 t00, t11, t22, t, u;
    fp6 r;
    fp2_mul(&t00, &a->c0, &b->c0);
    fp2_mul(&t11, &a->c1, &b->c1);
    fp2_mul(&t22, &a->c2, &b->c2);

    /* r0 = t00 + xi*(a1 b2 + a2 b1) */
    fp2_mul(&t, &a->c1, &b->c2);
    fp2_mul(&u, &a->c2, &b->c1);
    fp2_add(&t, &t, &u);
    fp2_mul_xi(&t, &t);
    fp2_add(&r.c0, &t00, &t);

    /* r1 = a0 b1 + a1 b0 + xi * t22 */
    fp2_mul(&t, &a->c0, &b->c1);
    fp2_mul(&u, &a->c1, &b->c0);
    fp2_add(&t, &t, &u);
    fp2_mul_xi(&u, &t22);
    fp2_add(&r.c1, &t, &u);

    /* r2 = a0 b2 + a2 b0 + t11 */
    fp2_mul(&t, &a->c0, &b->c2);
    fp2_mul(&u, &a->c2, &b->c0);
    fp2_add(&t, &t, &u);
    fp2_add(&r.c2, &t, &t11);
    *o = r;
}

static void fp6_sqr(fp6 *o, const fp6 *a) { fp6_mul(o, a, a); }

static void fp6_mul_fp2(fp6 *o, const fp6 *a, const fp2 *s) {
    fp2_mul(&o->c0, &a->c0, s);
    fp2_mul(&o->c1, &a->c1, s);
    fp2_mul(&o->c2, &a->c2, s);
}

static void fp6_inv(fp6 *o, const fp6 *a) {
    /* standard: c = a0^2 - xi a1 a2, etc. */
    fp2 c0, c1, c2, t, u, d;
    fp2_sqr(&c0, &a->c0);
    fp2_mul(&t, &a->c1, &a->c2);
    fp2_mul_xi(&t, &t);
    fp2_sub(&c0, &c0, &t);

    fp2_sqr(&c1, &a->c2);
    fp2_mul_xi(&c1, &c1);
    fp2_mul(&t, &a->c0, &a->c1);
    fp2_sub(&c1, &c1, &t);

    fp2_sqr(&c2, &a->c1);
    fp2_mul(&t, &a->c0, &a->c2);
    fp2_sub(&c2, &c2, &t);

    /* d = a0 c0 + xi (a2 c1 + a1 c2) */
    fp2_mul(&t, &a->c2, &c1);
    fp2_mul(&u, &a->c1, &c2);
    fp2_add(&t, &t, &u);
    fp2_mul_xi(&t, &t);
    fp2_mul(&d, &a->c0, &c0);
    fp2_add(&d, &d, &t);
    fp2_inv(&d, &d);

    fp2_mul(&o->c0, &c0, &d);
    fp2_mul(&o->c1, &c1, &d);
    fp2_mul(&o->c2, &c2, &d);
}

static fp12 FP12_ONE;

static void fp12_mul(fp12 *o, const fp12 *a, const fp12 *b) {
    fp6 aa, bb, t0, t1;
    fp12 r;
    fp6_mul(&aa, &a->c0, &b->c0);
    fp6_mul(&bb, &a->c1, &b->c1);
    fp6_add(&t0, &a->c0, &a->c1);
    fp6_add(&t1, &b->c0, &b->c1);
    fp6_mul(&t0, &t0, &t1);
    fp6_sub(&t0, &t0, &aa);
    fp6_sub(&t0, &t0, &bb);   /* a0 b1 + a1 b0 */
    fp6_mul_v(&t1, &bb);
    fp6_add(&r.c0, &aa, &t1);
    r.c1 = t0;
    *o = r;
}

static void fp12_sqr(fp12 *o, const fp12 *a) {
    /* (a0 + a1 w)^2 = a0^2 + v a1^2 + 2 a0 a1 w */
    fp6 t0, t1, t2;
    fp6_mul(&t2, &a->c0, &a->c1);
    fp6_add(&t0, &a->c0, &a->c1);
    fp6_mul_v(&t1, &a->c1);
    fp6_add(&t1, &t1, &a->c0);
    fp6_mul(&t0, &t0, &t1);       /* (a0+a1)(a0+v a1) = a0^2 + v a1^2 + (1+v) a0a1 */
    fp6_sub(&t0, &t0, &t2);
    fp6_mul_v(&t1, &t2);
    fp6_sub(&o->c0, &t0, &t1);
    fp6_add(&o->c1, &t2, &t2);
}

static void fp12_conj(fp12 *o, const fp12 *a) { o->c0 = a->c0; fp6_neg(&o->c1, &a->c1); }

static void fp12_inv(fp12 *o, const fp12 *a) {
    fp6 t0, t1;
    fp6_sqr(&t0, &a->c0);
    fp6_sqr(&t1, &a->c1);
    fp6_mul_v(&t1, &t1);
    fp6_sub(&t0, &t0, &t1);
    fp6_inv(&t0, &t0);
    fp6_mul(&o->c0, &a->c0, &t0);
    fp6_mul(&t1, &a->c1, &t0);
    fp6_neg(&o->c1, &t1);
}

static int fp12_is_one(const fp12 *a) {
    fp6 d;
    if (!fp6_is_zero(&a->c1)) return 0;
    fp6 one = {{{0}}};
    one.c0 = FP2_ONE;
    fp6_sub(&d, &a->c0, &one);
    return fp6_is_zero(&d);
}

/* Frobenius: gamma1[k] = xi^(k (p-1)/6), k = 1..5, set up at init */
static fp2 G1F[6];

static void fp12_frobenius(fp12 *o, const fp12 *a) {
    /* w-basis coefficient at w^k is (k even: c0.a_{k/2}) / (k odd:
     * c1.a_{(k-1)/2}); frob conjugates it and scales by gamma1[k]. */
    fp2 x[6], y[6];
    x[0] = a->c0.c0; x[2] = a->c0.c1; x[4] = a->c0.c2;
    x[1] = a->c1.c0; x[3] = a->c1.c1; x[5] = a->c1.c2;
    for (int k = 0; k < 6; k++) {
        fp2_conj(&y[k], &x[k]);
        if (k) fp2_mul(&y[k], &y[k], &G1F[k]);
    }
    o->c0.c0 = y[0]; o->c0.c1 = y[2]; o->c0.c2 = y[4];
    o->c1.c0 = y[1]; o->c1.c1 = y[3]; o->c1.c2 = y[5];
}

static void fp12_frobenius2(fp12 *o, const fp12 *a) {
    fp12 t;
    fp12_frobenius(&t, a);
    fp12_frobenius(o, &t);
}

/* f^e for 64-bit e (square-and-multiply, MSB first), e >= 1 */
static void fp12_pow_u64(fp12 *o, const fp12 *a, uint64_t e) {
    fp12 acc = *a;
    int top = 63;
    while (top > 0 && !((e >> top) & 1)) top--;
    for (int b = top - 1; b >= 0; b--) {
        fp12_sqr(&acc, &acc);
        if ((e >> b) & 1) fp12_mul(&acc, &acc, a);
    }
    *o = acc;
}

/* conj(a^e) — a^(−e) for unitary a */
static void fp12_conj_pow_u64(fp12 *o, const fp12 *a, uint64_t e) {
    fp12 t;
    fp12_pow_u64(&t, a, e);
    fp12_conj(o, &t);
}

/* ===================================================================== */
/* G1 (E: y^2 = x^3 + 4) — Jacobian                                       */
/* ===================================================================== */

typedef struct { fp x, y, z; int inf; } g1p;
typedef struct { fp x, y; int inf; } g1a;

static g1a G1_GEN;
static fp G1_B_M;

static void g1_set_inf(g1p *p) { p->inf = 1; p->x = FP_ONE; p->y = FP_ONE; p->z = FP_ZERO; }

static void g1_from_affine(g1p *o, const g1a *a) {
    if (a->inf) { g1_set_inf(o); return; }
    o->x = a->x; o->y = a->y; o->z = FP_ONE; o->inf = 0;
}

static void g1_dbl(g1p *o, const g1p *p) {
    if (p->inf || fp_is_zero(&p->y)) { g1_set_inf(o); return; }
    fp a, b, c, d, e, f, t;
    fp_sqr(&a, &p->x);
    fp_sqr(&b, &p->y);
    fp_sqr(&c, &b);
    fp_add(&t, &p->x, &b);
    fp_sqr(&d, &t);
    fp_sub(&d, &d, &a);
    fp_sub(&d, &d, &c);
    fp_dbl(&d, &d);          /* 4 X Y^2 */
    fp_dbl(&e, &a);
    fp_add(&e, &e, &a);      /* 3 X^2 */
    fp_sqr(&f, &e);
    fp_sub(&o->x, &f, &d);
    fp_sub(&o->x, &o->x, &d);
    fp_sub(&t, &d, &o->x);
    fp_mul(&t, &e, &t);
    fp dc8; fp_dbl(&dc8, &c); fp_dbl(&dc8, &dc8); fp_dbl(&dc8, &dc8);
    fp zz;
    fp_mul(&zz, &p->y, &p->z);
    fp_sub(&o->y, &t, &dc8);
    fp_dbl(&o->z, &zz);
    o->inf = 0;
}

static void g1_add(g1p *o, const g1p *p, const g1p *q) {
    if (p->inf) { *o = *q; return; }
    if (q->inf) { *o = *p; return; }
    fp z1z1, z2z2, u1, u2, s1, s2, h, i, j, r, v, t;
    fp_sqr(&z1z1, &p->z);
    fp_sqr(&z2z2, &q->z);
    fp_mul(&u1, &p->x, &z2z2);
    fp_mul(&u2, &q->x, &z1z1);
    fp_mul(&s1, &p->y, &q->z); fp_mul(&s1, &s1, &z2z2);
    fp_mul(&s2, &q->y, &p->z); fp_mul(&s2, &s2, &z1z1);
    if (fp_eq(&u1, &u2)) {
        if (fp_eq(&s1, &s2)) { g1_dbl(o, p); return; }
        g1_set_inf(o);
        return;
    }
    fp_sub(&h, &u2, &u1);
    fp_dbl(&i, &h); fp_sqr(&i, &i);
    fp_mul(&j, &h, &i);
    fp_sub(&r, &s2, &s1); fp_dbl(&r, &r);
    fp_mul(&v, &u1, &i);
    fp_sqr(&o->x, &r);
    fp_sub(&o->x, &o->x, &j);
    fp_sub(&o->x, &o->x, &v);
    fp_sub(&o->x, &o->x, &v);
    fp_sub(&t, &v, &o->x);
    fp_mul(&t, &r, &t);
    fp s1j; fp_mul(&s1j, &s1, &j); fp_dbl(&s1j, &s1j);
    fp_sub(&o->y, &t, &s1j);
    fp_add(&o->z, &p->z, &q->z);
    fp_sqr(&o->z, &o->z);
    fp_sub(&o->z, &o->z, &z1z1);
    fp_sub(&o->z, &o->z, &z2z2);
    fp_mul(&o->z, &o->z, &h);
    o->inf = 0;
}

static void g1_neg(g1p *o, const g1p *p) { *o = *p; fp_neg(&o->y, &p->y); }

/* scalar mul, scalar little-endian limbs */
static void g1_mul(g1p *o, const g1p *p, const uint64_t *e, int n_limbs) {
    g1p acc; g1_set_inf(&acc);
    int started = 0;
    for (int i = n_limbs - 1; i >= 0; i--)
        for (int b = 63; b >= 0; b--) {
            if (started) g1_dbl(&acc, &acc);
            if ((e[i] >> b) & 1) {
                if (!started) { acc = *p; started = 1; }
                else g1_add(&acc, &acc, p);
            }
        }
    *o = acc;
}

static void g1_to_affine(g1a *o, const g1p *p) {
    if (p->inf || fp_is_zero(&p->z)) { o->inf = 1; o->x = FP_ZERO; o->y = FP_ZERO; return; }
    fp zi, zi2, zi3;
    fp_inv(&zi, &p->z);
    fp_sqr(&zi2, &zi);
    fp_mul(&zi3, &zi2, &zi);
    fp_mul(&o->x, &p->x, &zi2);
    fp_mul(&o->y, &p->y, &zi3);
    o->inf = 0;
}

static int g1_on_curve(const g1a *a) {
    if (a->inf) return 1;
    fp l, r;
    fp_sqr(&l, &a->y);
    fp_sqr(&r, &a->x);
    fp_mul(&r, &r, &a->x);
    fp_add(&r, &r, &G1_B_M);
    return fp_eq(&l, &r);
}

static int g1_in_subgroup(const g1a *a) {
    if (a->inf) return 1;
    g1p p, t;
    g1_from_affine(&p, a);
    g1_mul(&t, &p, BLS_ORDER, 4);
    return t.inf || fp_is_zero(&t.z);
}

/* 48-byte compressed G1 -> affine; returns 0 on malformed/off-curve */
static int g1_decompress(g1a *o, const uint8_t in[48]) {
    uint8_t flags = in[0];
    if (!(flags & 0x80)) return 0;            /* must be compressed */
    int infinity = (flags >> 6) & 1;
    int sign = (flags >> 5) & 1;
    uint8_t buf[48];
    memcpy(buf, in, 48);
    buf[0] &= 0x1f;
    if (infinity) {
        for (int i = 0; i < 48; i++) if (buf[i]) return 0;
        if (sign) return 0;
        o->inf = 1; o->x = FP_ZERO; o->y = FP_ZERO;
        return 1;
    }
    fp x, gx, y, ny;
    if (!fp_from_bytes(&x, buf)) return 0;
    fp_sqr(&gx, &x);
    fp_mul(&gx, &gx, &x);
    fp_add(&gx, &gx, &G1_B_M);
    if (!fp_sqrt(&y, &gx)) return 0;
    fp_neg(&ny, &y);
    int y_larger = fp_cmp(&y, &ny) > 0;
    if (y_larger != sign) y = ny;
    o->x = x; o->y = y; o->inf = 0;
    return 1;
}

/* ===================================================================== */
/* G2 (E': y^2 = x^3 + 4(1+u)) — Jacobian                                 */
/* ===================================================================== */

typedef struct { fp2 x, y, z; int inf; } g2p;
typedef struct { fp2 x, y; int inf; } g2a;

static g2a G2_GEN_A;
static fp2 G2_B_M;
static fp2 PSI_CX_M, PSI_CY_M;

static void g2_set_inf(g2p *p) { p->inf = 1; p->x = FP2_ONE; p->y = FP2_ONE; p->z = FP2_ZERO; }

static void g2_from_affine(g2p *o, const g2a *a) {
    if (a->inf) { g2_set_inf(o); return; }
    o->x = a->x; o->y = a->y; o->z = FP2_ONE; o->inf = 0;
}

static void g2_dbl(g2p *o, const g2p *p) {
    if (p->inf || fp2_is_zero(&p->y)) { g2_set_inf(o); return; }
    fp2 a, b, c, d, e, f, t, zz, dc8;
    fp2_sqr(&a, &p->x);
    fp2_sqr(&b, &p->y);
    fp2_sqr(&c, &b);
    fp2_add(&t, &p->x, &b);
    fp2_sqr(&d, &t);
    fp2_sub(&d, &d, &a);
    fp2_sub(&d, &d, &c);
    fp2_dbl(&d, &d);
    fp2_dbl(&e, &a);
    fp2_add(&e, &e, &a);
    fp2_sqr(&f, &e);
    fp2_sub(&o->x, &f, &d);
    fp2_sub(&o->x, &o->x, &d);
    fp2_sub(&t, &d, &o->x);
    fp2_mul(&t, &e, &t);
    fp2_dbl(&dc8, &c); fp2_dbl(&dc8, &dc8); fp2_dbl(&dc8, &dc8);
    fp2_mul(&zz, &p->y, &p->z);
    fp2_sub(&o->y, &t, &dc8);
    fp2_dbl(&o->z, &zz);
    o->inf = 0;
}

static void g2_add(g2p *o, const g2p *p, const g2p *q) {
    if (p->inf) { *o = *q; return; }
    if (q->inf) { *o = *p; return; }
    fp2 z1z1, z2z2, u1, u2, s1, s2, h, i, j, r, v, t, s1j;
    fp2_sqr(&z1z1, &p->z);
    fp2_sqr(&z2z2, &q->z);
    fp2_mul(&u1, &p->x, &z2z2);
    fp2_mul(&u2, &q->x, &z1z1);
    fp2_mul(&s1, &p->y, &q->z); fp2_mul(&s1, &s1, &z2z2);
    fp2_mul(&s2, &q->y, &p->z); fp2_mul(&s2, &s2, &z1z1);
    if (fp2_eq(&u1, &u2)) {
        if (fp2_eq(&s1, &s2)) { g2_dbl(o, p); return; }
        g2_set_inf(o);
        return;
    }
    fp2_sub(&h, &u2, &u1);
    fp2_dbl(&i, &h); fp2_sqr(&i, &i);
    fp2_mul(&j, &h, &i);
    fp2_sub(&r, &s2, &s1); fp2_dbl(&r, &r);
    fp2_mul(&v, &u1, &i);
    fp2_sqr(&o->x, &r);
    fp2_sub(&o->x, &o->x, &j);
    fp2_sub(&o->x, &o->x, &v);
    fp2_sub(&o->x, &o->x, &v);
    fp2_sub(&t, &v, &o->x);
    fp2_mul(&t, &r, &t);
    fp2_mul(&s1j, &s1, &j); fp2_dbl(&s1j, &s1j);
    fp2_sub(&o->y, &t, &s1j);
    fp2_add(&o->z, &p->z, &q->z);
    fp2_sqr(&o->z, &o->z);
    fp2_sub(&o->z, &o->z, &z1z1);
    fp2_sub(&o->z, &o->z, &z2z2);
    fp2_mul(&o->z, &o->z, &h);
    o->inf = 0;
}

static void g2_neg(g2p *o, const g2p *p) { *o = *p; fp2_neg(&o->y, &p->y); }

static void g2_mul_u64(g2p *o, const g2p *p, uint64_t e) {
    g2p acc; g2_set_inf(&acc);
    int started = 0;
    for (int b = 63; b >= 0; b--) {
        if (started) g2_dbl(&acc, &acc);
        if ((e >> b) & 1) {
            if (!started) { acc = *p; started = 1; }
            else g2_add(&acc, &acc, p);
        }
    }
    if (!started) g2_set_inf(o); else *o = acc;
}

static void g2_to_affine(g2a *o, const g2p *p) {
    if (p->inf || fp2_is_zero(&p->z)) { o->inf = 1; o->x = FP2_ZERO; o->y = FP2_ZERO; return; }
    fp2 zi, zi2, zi3;
    fp2_inv(&zi, &p->z);
    fp2_sqr(&zi2, &zi);
    fp2_mul(&zi3, &zi2, &zi);
    fp2_mul(&o->x, &p->x, &zi2);
    fp2_mul(&o->y, &p->y, &zi3);
    o->inf = 0;
}

static int g2_jac_eq(const g2p *p, const g2p *q) {
    int pi = p->inf || fp2_is_zero(&p->z);
    int qi = q->inf || fp2_is_zero(&q->z);
    if (pi || qi) return pi == qi;
    fp2 z1z1, z2z2, a, b, z13, z23;
    fp2_sqr(&z1z1, &p->z);
    fp2_sqr(&z2z2, &q->z);
    fp2_mul(&a, &p->x, &z2z2);
    fp2_mul(&b, &q->x, &z1z1);
    if (!fp2_eq(&a, &b)) return 0;
    fp2_mul(&z13, &z1z1, &p->z);
    fp2_mul(&z23, &z2z2, &q->z);
    fp2_mul(&a, &p->y, &z23);
    fp2_mul(&b, &q->y, &z13);
    return fp2_eq(&a, &b);
}

/* psi (untwist-Frobenius-twist), Jacobian */
static void g2_psi(g2p *o, const g2p *p) {
    fp2_conj(&o->x, &p->x); fp2_mul(&o->x, &o->x, &PSI_CX_M);
    fp2_conj(&o->y, &p->y); fp2_mul(&o->y, &o->y, &PSI_CY_M);
    fp2_conj(&o->z, &p->z);
    o->inf = p->inf;
}

static int g2_on_curve(const g2a *a) {
    if (a->inf) return 1;
    fp2 l, r;
    fp2_sqr(&l, &a->y);
    fp2_sqr(&r, &a->x);
    fp2_mul(&r, &r, &a->x);
    fp2_add(&r, &r, &G2_B_M);
    return fp2_eq(&l, &r);
}

/* Scott's test: Q in G2 iff psi(Q) == [x]Q (x negative: negate) */
static int g2_in_subgroup(const g2a *a) {
    if (a->inf) return 1;
    g2p p, xq, ps;
    g2_from_affine(&p, a);
    g2_mul_u64(&xq, &p, BLS_X_ABS);
    g2_neg(&xq, &xq);
    g2_psi(&ps, &p);
    return g2_jac_eq(&ps, &xq);
}

/* 96-byte compressed G2 -> affine (x.c1 || x.c0 big-endian) */
static int g2_decompress(g2a *o, const uint8_t in[96]) {
    uint8_t flags = in[0];
    if (!(flags & 0x80)) return 0;
    int infinity = (flags >> 6) & 1;
    int sign = (flags >> 5) & 1;
    uint8_t buf[96];
    memcpy(buf, in, 96);
    buf[0] &= 0x1f;
    if (infinity) {
        for (int i = 0; i < 96; i++) if (buf[i]) return 0;
        if (sign) return 0;
        o->inf = 1; o->x = FP2_ZERO; o->y = FP2_ZERO;
        return 1;
    }
    fp2 x, gx, y, ny;
    if (!fp_from_bytes(&x.c1, buf)) return 0;
    if (!fp_from_bytes(&x.c0, buf + 48)) return 0;
    fp2_sqr(&gx, &x);
    fp2_mul(&gx, &gx, &x);
    fp2_add(&gx, &gx, &G2_B_M);
    if (!fp2_sqrt(&y, &gx)) return 0;
    fp2_neg(&ny, &y);
    int y_larger = fp2_lex_gt(&y, &ny);
    if (y_larger != sign) y = ny;
    o->x = x; o->y = y; o->inf = 0;
    return 1;
}

/* ===================================================================== */
/* Pairing: aggregated Miller loop + final exponentiation                 */
/* ===================================================================== */

/* Sparse line element (s0, sv, sv2) occupies Fp12 slots (c0.c0, c1.c1,
 * c1.c2) in the 2-3-2 tower — same derivation as device/pairing.py. */
static void fp12_mul_line(fp12 *f, const fp2 *s0, const fp2 *sv, const fp2 *sv2) {
    fp6 a = f->c0, b = f->c1;
    fp6 al0, bl0, al1, bl1;
    fp2 t, u;

    fp6_mul_fp2(&al0, &a, s0);
    fp6_mul_fp2(&bl0, &b, s0);

    /* b * (sv w^3 + sv2 w^5): in fp6-slot terms the product with
     * (0, sv, sv2) in the v-basis of the OTHER fp6 half:
     * bl1 = b * (sv v + sv2 v^2) where the result lands back shifted. */
    /* bl1_0 = xi*(b1 sv2 + b2 sv); bl1_1 = b0 sv + xi b2 sv2;
       bl1_2 = b0 sv2 + b1 sv */
    fp2_mul(&t, &b.c1, sv2);
    fp2_mul(&u, &b.c2, sv);
    fp2_add(&t, &t, &u);
    fp2_mul_xi(&bl1.c0, &t);
    fp2_mul(&t, &b.c0, sv);
    fp2_mul(&u, &b.c2, sv2);
    fp2_mul_xi(&u, &u);
    fp2_add(&bl1.c1, &t, &u);
    fp2_mul(&t, &b.c0, sv2);
    fp2_mul(&u, &b.c1, sv);
    fp2_add(&bl1.c2, &t, &u);

    fp2_mul(&t, &a.c1, sv2);
    fp2_mul(&u, &a.c2, sv);
    fp2_add(&t, &t, &u);
    fp2_mul_xi(&al1.c0, &t);
    fp2_mul(&t, &a.c0, sv);
    fp2_mul(&u, &a.c2, sv2);
    fp2_mul_xi(&u, &u);
    fp2_add(&al1.c1, &t, &u);
    fp2_mul(&t, &a.c0, sv2);
    fp2_mul(&u, &a.c1, sv);
    fp2_add(&al1.c2, &t, &u);

    /* f = (a + b w)(L0 + L1 w) = (a L0 + v b L1) + (a L1 + b L0) w */
    fp6 vb;
    fp6_mul_v(&vb, &bl1);
    fp6_add(&f->c0, &al0, &vb);
    fp6_add(&f->c1, &al1, &bl0);
}

/* dbl step: T <- 2T, line coefficients at P = (xP, yP) */
static void miller_dbl(g2p *T, fp2 *s0, fp2 *sv, fp2 *sv2, const fp *xP, const fp *yP) {
    fp2 A, B, C, D, E, F, X3, Y3, Z3, Z2, t, z3z2;
    fp2_sqr(&A, &T->x);
    fp2_sqr(&B, &T->y);
    fp2_sqr(&C, &B);
    fp2_add(&t, &T->x, &B);
    fp2_sqr(&D, &t);
    fp2_sub(&D, &D, &A);
    fp2_sub(&D, &D, &C);
    fp2_dbl(&D, &D);
    fp2_dbl(&E, &A); fp2_add(&E, &E, &A);
    fp2_sqr(&F, &E);
    fp2_sub(&X3, &F, &D); fp2_sub(&X3, &X3, &D);
    fp2_sub(&t, &D, &X3);
    fp2_mul(&Y3, &E, &t);
    fp2 c8; fp2_dbl(&c8, &C); fp2_dbl(&c8, &c8); fp2_dbl(&c8, &c8);
    fp2_sub(&Y3, &Y3, &c8);
    fp2_add(&t, &T->y, &T->y);
    fp2_mul(&Z3, &t, &T->z);

    fp2_sqr(&Z2, &T->z);
    fp2_mul(&z3z2, &Z3, &Z2);
    fp2_mul_fp(&t, &z3z2, yP);
    fp2_neg(&t, &t);
    fp2_mul_xi(s0, &t);                  /* s0 = -2YZ^3 yP xi */
    fp2_mul(&t, &E, &T->x);
    fp2_add(sv, &B, &B);
    fp2_sub(sv, sv, &t);                 /* sv = 2Y^2 - 3X^3 */
    fp2_mul(&t, &E, &Z2);
    fp2_mul_fp(sv2, &t, xP);             /* sv2 = 3X^2 Z^2 xP */

    T->x = X3; T->y = Y3; T->z = Z3;
}

/* add step: T <- T + Q (Q affine), line coefficients at P */
static void miller_add(g2p *T, fp2 *s0, fp2 *sv, fp2 *sv2,
                       const g2a *Q, const fp *xP, const fp *yP) {
    fp2 Z2, U2, S2, H, R, HH, HHH, V, X3, Y3, Z3, t, u;
    fp2_sqr(&Z2, &T->z);
    fp2_mul(&U2, &Q->x, &Z2);
    fp2_mul(&t, &T->z, &Z2);
    fp2_mul(&S2, &Q->y, &t);
    fp2_sub(&H, &U2, &T->x);
    fp2_sub(&R, &S2, &T->y);
    fp2_sqr(&HH, &H);
    fp2_mul(&HHH, &H, &HH);
    fp2_mul(&V, &T->x, &HH);
    fp2_sqr(&X3, &R);
    fp2_sub(&X3, &X3, &HHH);
    fp2_sub(&X3, &X3, &V);
    fp2_sub(&X3, &X3, &V);
    fp2_sub(&t, &V, &X3);
    fp2_mul(&Y3, &R, &t);
    fp2_mul(&t, &T->y, &HHH);
    fp2_sub(&Y3, &Y3, &t);
    fp2_mul(&Z3, &T->z, &H);

    fp2_mul_fp(&t, &Z3, yP);
    fp2_neg(&t, &t);
    fp2_mul_xi(s0, &t);                  /* s0 = -HZ yP xi */
    fp2_mul(&t, &Z3, &Q->y);
    fp2_mul(&u, &R, &Q->x);
    fp2_sub(sv, &t, &u);                 /* sv = HZ y2 - R x2 */
    fp2_mul_fp(sv2, &R, xP);             /* sv2 = R xP */

    T->x = X3; T->y = Y3; T->z = Z3;
}

/* Aggregated Miller loop over n pairs; skips pairs with either side at
 * infinity. Result conjugated for the negative parameter. */
static void miller_loop_n(fp12 *f, const g1a *ps, const g2a *qs, int n, g2p *Ts /* scratch n */) {
    *f = FP12_ONE;
    int live = 0;
    for (int i = 0; i < n; i++) {
        if (!ps[i].inf && !qs[i].inf) { g2_from_affine(&Ts[i], &qs[i]); live = 1; }
        else Ts[i].inf = 1;
    }
    if (!live) return;
    int top = 63;
    while (top > 0 && !((BLS_X_ABS >> top) & 1)) top--;
    for (int b = top - 1; b >= 0; b--) {
        fp12_sqr(f, f);
        int bit = (BLS_X_ABS >> b) & 1;
        for (int i = 0; i < n; i++) {
            if (Ts[i].inf) continue;
            fp2 s0, sv, sv2;
            miller_dbl(&Ts[i], &s0, &sv, &sv2, &ps[i].x, &ps[i].y);
            fp12_mul_line(f, &s0, &sv, &sv2);
            if (bit) {
                miller_add(&Ts[i], &s0, &sv, &sv2, &qs[i], &ps[i].x, &ps[i].y);
                fp12_mul_line(f, &s0, &sv, &sv2);
            }
        }
    }
    fp12_conj(f, f); /* negative x */
}

/* final exponentiation, exact (easy part + machine-checked x-chain) */
static void final_exp(fp12 *o, const fp12 *f) {
    fp12 t, inv, a, b, c, u;
    /* easy: f^((p^6-1)(p^2+1)) */
    fp12_conj(&t, f);
    fp12_inv(&inv, f);
    fp12_mul(&t, &t, &inv);
    fp12_frobenius2(&u, &t);
    fp12_mul(&t, &u, &t);
    /* hard: d = (x-1)^2 (x+p)(x^2+p^2-1)/3 + 1  via the chain
     * a = t^((x-1)^2/3); b = a^(x+p); c = b^(x^2+p^2-1); o = c*t.
     * Negative exponents on unitary values via conjugate. */
    fp12_conj_pow_u64(&a, &t, BLS_LAM);            /* t^((x-1)/3), (x-1)<0 */
    fp12_conj_pow_u64(&a, &a, BLS_X_MINUS_1_ABS);  /* ^(x-1) */
    fp12_conj_pow_u64(&b, &a, BLS_X_ABS);          /* a^x */
    fp12_frobenius(&u, &a);
    fp12_mul(&b, &b, &u);                          /* * a^p */
    fp12_conj_pow_u64(&c, &b, BLS_X_ABS);
    fp12_conj_pow_u64(&c, &c, BLS_X_ABS);          /* b^(x^2) */
    fp12_frobenius2(&u, &b);
    fp12_mul(&c, &c, &u);                          /* * b^(p^2) */
    fp12_conj(&u, &b);
    fp12_mul(&c, &c, &u);                          /* * b^-1 */
    fp12_mul(o, &c, &t);                           /* * t */
}

/* ===================================================================== */
/* SHA-256 (compact scalar; hashing is not this library's hot loop)       */
/* ===================================================================== */

static const uint32_t SK[64] = {
    0x428a2f98,0x71374491,0xb5c0fbcf,0xe9b5dba5,0x3956c25b,0x59f111f1,0x923f82a4,0xab1c5ed5,
    0xd807aa98,0x12835b01,0x243185be,0x550c7dc3,0x72be5d74,0x80deb1fe,0x9bdc06a7,0xc19bf174,
    0xe49b69c1,0xefbe4786,0x0fc19dc6,0x240ca1cc,0x2de92c6f,0x4a7484aa,0x5cb0a9dc,0x76f988da,
    0x983e5152,0xa831c66d,0xb00327c8,0xbf597fc7,0xc6e00bf3,0xd5a79147,0x06ca6351,0x14292967,
    0x27b70a85,0x2e1b2138,0x4d2c6dfc,0x53380d13,0x650a7354,0x766a0abb,0x81c2c92e,0x92722c85,
    0xa2bfe8a1,0xa81a664b,0xc24b8b70,0xc76c51a3,0xd192e819,0xd6990624,0xf40e3585,0x106aa070,
    0x19a4c116,0x1e376c08,0x2748774c,0x34b0bcb5,0x391c0cb3,0x4ed8aa4a,0x5b9cca4f,0x682e6ff3,
    0x748f82ee,0x78a5636f,0x84c87814,0x8cc70208,0x90befffa,0xa4506ceb,0xbef9a3f7,0xc67178f2,
};

typedef struct { uint32_t h[8]; uint8_t buf[64]; uint64_t len; size_t fill; } sha256_ctx;

static inline uint32_t ror32(uint32_t x, int r) { return (x >> r) | (x << (32 - r)); }

static void sha256_block(uint32_t h[8], const uint8_t p[64]) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
        w[i] = ((uint32_t)p[4*i] << 24) | ((uint32_t)p[4*i+1] << 16) | ((uint32_t)p[4*i+2] << 8) | p[4*i+3];
    for (int i = 16; i < 64; i++) {
        uint32_t s0 = ror32(w[i-15], 7) ^ ror32(w[i-15], 18) ^ (w[i-15] >> 3);
        uint32_t s1 = ror32(w[i-2], 17) ^ ror32(w[i-2], 19) ^ (w[i-2] >> 10);
        w[i] = w[i-16] + s0 + w[i-7] + s1;
    }
    uint32_t a=h[0],b=h[1],c=h[2],d=h[3],e=h[4],f=h[5],g=h[6],hh=h[7];
    for (int i = 0; i < 64; i++) {
        uint32_t S1 = ror32(e,6) ^ ror32(e,11) ^ ror32(e,25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = hh + S1 + ch + SK[i] + w[i];
        uint32_t S0 = ror32(a,2) ^ ror32(a,13) ^ ror32(a,22);
        uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
        uint32_t t2 = S0 + mj;
        hh=g; g=f; f=e; e=d+t1; d=c; c=b; b=a; a=t1+t2;
    }
    h[0]+=a; h[1]+=b; h[2]+=c; h[3]+=d; h[4]+=e; h[5]+=f; h[6]+=g; h[7]+=hh;
}

static void sha256_init(sha256_ctx *c) {
    static const uint32_t IV[8] = {0x6a09e667,0xbb67ae85,0x3c6ef372,0xa54ff53a,0x510e527f,0x9b05688c,0x1f83d9ab,0x5be0cd19};
    memcpy(c->h, IV, sizeof IV);
    c->len = 0; c->fill = 0;
}

static void sha256_update(sha256_ctx *c, const uint8_t *p, size_t n) {
    c->len += n;
    while (n) {
        size_t k = 64 - c->fill;
        if (k > n) k = n;
        memcpy(c->buf + c->fill, p, k);
        c->fill += k; p += k; n -= k;
        if (c->fill == 64) { sha256_block(c->h, c->buf); c->fill = 0; }
    }
}

static void sha256_final(sha256_ctx *c, uint8_t out[32]) {
    uint64_t bits = c->len * 8;
    uint8_t pad = 0x80;
    sha256_update(c, &pad, 1);
    uint8_t z = 0;
    while (c->fill != 56) sha256_update(c, &z, 1);
    uint8_t lb[8];
    for (int i = 0; i < 8; i++) lb[i] = (uint8_t)(bits >> (56 - 8 * i));
    sha256_update(c, lb, 8);
    for (int i = 0; i < 8; i++) {
        out[4*i]   = (uint8_t)(c->h[i] >> 24);
        out[4*i+1] = (uint8_t)(c->h[i] >> 16);
        out[4*i+2] = (uint8_t)(c->h[i] >> 8);
        out[4*i+3] = (uint8_t)(c->h[i]);
    }
}

/* ===================================================================== */
/* Hash-to-curve G2 (RFC 9380: expand_message_xmd + SSWU + iso3 + h_eff)  */
/* ===================================================================== */

static fp2 ISO_A, ISO_B, ISO_Z;
static fp2 XNUM[4], XDEN[3], YNUM[4], YDEN[4];
static int N_XNUM = 4, N_XDEN = 3, N_YNUM = 4, N_YDEN = 4;

/* fold acc (7 limbs) below 2^384: acc = lo + hi * (2^384 mod p), looped —
 * a single fold leaves residue ~hi/8 which the caller's next *256 shift
 * would outgrow. The limbs of FP_ONE (Montgomery 1) ARE 2^384 mod p. */
static void fold384(uint64_t acc[7]) {
    while (acc[6]) {
        uint64_t hi = acc[6];
        acc[6] = 0;
        u128 c = 0;
        for (int j = 0; j < 6; j++) {
            c += (u128)FP_ONE.l[j] * hi + acc[j];
            acc[j] = (uint64_t)c;
            c >>= 64;
        }
        acc[6] = (uint64_t)c;
    }
}

/* 64 big-endian bytes -> fp (mod p), byte-Horner with fold reduction */
static void fp_from_be64_mod(fp *o, const uint8_t in[64]) {
    /* value = sum b_i 256^i; process high->low: acc = acc*256 + b */
    uint64_t acc[7] = {0};
    for (int i = 0; i < 64; i++) {
        uint64_t carry = 0;
        for (int j = 0; j < 7; j++) {
            uint64_t nv = (acc[j] << 8) | carry;
            carry = acc[j] >> 56;
            acc[j] = nv;
        }
        acc[0] |= in[i];
        fold384(acc);
    }
    fp t;
    for (int i = 0; i < 6; i++) t.l[i] = acc[i];
    while (fp_ge_p(&t)) fp_sub_p(&t);
    fp_mul(o, &t, &FP_R2);
}

static void expand_xmd(uint8_t *out, size_t len_out,
                       const uint8_t *msg, size_t msg_len,
                       const uint8_t *dst, size_t dst_len) {
    uint8_t b0[32], bi[32];
    uint8_t zpad[64] = {0};
    uint8_t lib[2] = {(uint8_t)(len_out >> 8), (uint8_t)len_out};
    uint8_t dstp_tail = (uint8_t)dst_len;
    sha256_ctx c;
    sha256_init(&c);
    sha256_update(&c, zpad, 64);
    sha256_update(&c, msg, msg_len);
    sha256_update(&c, lib, 2);
    uint8_t zero = 0;
    sha256_update(&c, &zero, 1);
    sha256_update(&c, dst, dst_len);
    sha256_update(&c, &dstp_tail, 1);
    sha256_final(&c, b0);

    uint8_t ctr = 1;
    sha256_init(&c);
    sha256_update(&c, b0, 32);
    sha256_update(&c, &ctr, 1);
    sha256_update(&c, dst, dst_len);
    sha256_update(&c, &dstp_tail, 1);
    sha256_final(&c, bi);

    size_t off = 0;
    for (;;) {
        size_t k = len_out - off < 32 ? len_out - off : 32;
        memcpy(out + off, bi, k);
        off += k;
        if (off >= len_out) break;
        uint8_t x[32];
        for (int i = 0; i < 32; i++) x[i] = b0[i] ^ bi[i];
        ctr++;
        sha256_init(&c);
        sha256_update(&c, x, 32);
        sha256_update(&c, &ctr, 1);
        sha256_update(&c, dst, dst_len);
        sha256_update(&c, &dstp_tail, 1);
        sha256_final(&c, bi);
    }
}

static void sswu(fp2 *xo, fp2 *yo, const fp2 *u) {
    fp2 zu2, tv1, x1, gx1, x2, gx2, y, t, u2;
    fp2_sqr(&u2, u);
    fp2_mul(&zu2, &ISO_Z, &u2);
    fp2_sqr(&tv1, &zu2);
    fp2_add(&tv1, &tv1, &zu2);
    if (fp2_is_zero(&tv1)) {
        fp2_mul(&t, &ISO_Z, &ISO_A);
        fp2_inv(&t, &t);
        fp2_mul(&x1, &ISO_B, &t);
    } else {
        fp2_inv(&t, &ISO_A);
        fp2_neg(&t, &t);
        fp2_mul(&t, &t, &ISO_B);
        fp2 inv1;
        fp2_inv(&inv1, &tv1);
        fp2_add(&inv1, &inv1, &FP2_ONE);
        fp2_mul(&x1, &t, &inv1);
    }
    fp2_sqr(&gx1, &x1);
    fp2_add(&gx1, &gx1, &ISO_A);
    fp2_mul(&gx1, &gx1, &x1);
    fp2_add(&gx1, &gx1, &ISO_B);
    if (fp2_sqrt(&y, &gx1)) {
        *xo = x1;
    } else {
        fp2_mul(&x2, &zu2, &x1);
        fp2_sqr(&gx2, &x2);
        fp2_add(&gx2, &gx2, &ISO_A);
        fp2_mul(&gx2, &gx2, &x2);
        fp2_add(&gx2, &gx2, &ISO_B);
        fp2_sqrt(&y, &gx2); /* must succeed */
        *xo = x2;
    }
    if (fp2_sgn0(u) != fp2_sgn0(&y)) fp2_neg(&y, &y);
    *yo = y;
}

static void horner(fp2 *o, const fp2 *coef, int n, const fp2 *x) {
    fp2 acc = FP2_ZERO;
    for (int i = n - 1; i >= 0; i--) {
        fp2_mul(&acc, &acc, x);
        fp2_add(&acc, &acc, &coef[i]);
    }
    *o = acc;
}

static void iso3(g2a *o, const fp2 *x, const fp2 *y) {
    fp2 xn, xd, yn, yd, t;
    horner(&xn, XNUM, N_XNUM, x);
    horner(&xd, XDEN, N_XDEN, x);
    horner(&yn, YNUM, N_YNUM, x);
    horner(&yd, YDEN, N_YDEN, x);
    fp2_inv(&t, &xd);
    fp2_mul(&o->x, &xn, &t);
    fp2_inv(&t, &yd);
    fp2_mul(&o->y, &yn, &t);
    fp2_mul(&o->y, &o->y, y);
    o->inf = 0;
}

/* [x]P for the NEGATIVE parameter x: -( [|x|] P ) */
static void g2_mul_param(g2p *o, const g2p *p) {
    g2_mul_u64(o, p, BLS_X_ABS);
    g2_neg(o, o);
}

static void clear_cofactor(g2p *o, const g2p *p) {
    /* [X^2-X-1]P + [X-1]psi(P) + psi^2([2]P)  (Budroni-Pintore) */
    g2p xp, x2p, part1, part2, part3, t, np;
    g2_mul_param(&xp, p);
    g2_mul_param(&x2p, &xp);
    g2_neg(&np, &xp);
    g2_add(&part1, &x2p, &np);
    g2_neg(&np, (g2p *)p);
    g2_add(&part1, &part1, &np);       /* x2p - xp - p */
    g2_add(&t, &xp, &np);              /* xp - p */
    g2_psi(&part2, &t);
    g2_dbl(&t, p);
    g2_psi(&t, &t);
    g2_psi(&part3, &t);
    g2_add(o, &part1, &part2);
    g2_add(o, o, &part3);
}

static void hash_to_g2(g2a *o, const uint8_t *msg, size_t msg_len,
                       const uint8_t *dst, size_t dst_len) {
    uint8_t uni[256];
    expand_xmd(uni, 256, msg, msg_len, dst, dst_len);
    fp2 u0, u1, x, y;
    fp_from_be64_mod(&u0.c0, uni);
    fp_from_be64_mod(&u0.c1, uni + 64);
    fp_from_be64_mod(&u1.c0, uni + 128);
    fp_from_be64_mod(&u1.c1, uni + 192);
    g2a q0, q1;
    sswu(&x, &y, &u0);
    iso3(&q0, &x, &y);
    sswu(&x, &y, &u1);
    iso3(&q1, &x, &y);
    g2p j0, j1, s, c;
    g2_from_affine(&j0, &q0);
    g2_from_affine(&j1, &q1);
    g2_add(&s, &j0, &j1);
    clear_cofactor(&c, &s);
    g2_to_affine(o, &c);
}

/* ===================================================================== */
/* init + public API                                                      */
/* ===================================================================== */

static int INITED = 0;

static void ensure_init(void) {
    if (INITED) return;
    for (int i = 0; i < 6; i++) { FP_ZERO.l[i] = 0; FP_R2.l[i] = BLS_R2[i]; }
    /* FP_ONE = R mod p = mont(1): raw 1 -> mont via R2 needs mont mul with
     * the not-yet-set FP_ONE? No: mont mul is self-contained. */
    fp one_raw = {{1, 0, 0, 0, 0, 0}};
    fp_mul(&FP_ONE, &one_raw, &FP_R2);
    FP2_ZERO.c0 = FP_ZERO; FP2_ZERO.c1 = FP_ZERO;
    FP2_ONE.c0 = FP_ONE; FP2_ONE.c1 = FP_ZERO;
    memset(&FP12_ONE, 0, sizeof FP12_ONE);
    FP12_ONE.c0.c0 = FP2_ONE;

    fp_from_raw(&G1_GEN.x, G1_GEN_X.l);
    fp_from_raw(&G1_GEN.y, G1_GEN_Y.l);
    G1_GEN.inf = 0;
    fp_from_raw(&G1_B_M, G1_B.l);
    fp2_from_raw(&G2_GEN_A.x, &G2_GEN_X);
    fp2_from_raw(&G2_GEN_A.y, &G2_GEN_Y);
    G2_GEN_A.inf = 0;
    fp2_from_raw(&G2_B_M, &G2_B);
    fp2_from_raw(&PSI_CX_M, &PSI_CX_T);
    fp2_from_raw(&PSI_CY_M, &PSI_CY_T);

    fp2 g;
    fp2_from_raw(&g, &FROB12_C1);
    G1F[0] = FP2_ONE;
    for (int k = 1; k < 6; k++) fp2_mul(&G1F[k], &G1F[k - 1], &g);

    fp2_from_raw(&ISO_A, &ISO3_A_T);
    fp2_from_raw(&ISO_B, &ISO3_B_T);
    fp2_from_raw(&ISO_Z, &ISO3_Z_T);
    for (int i = 0; i < 4; i++) fp2_from_raw(&XNUM[i], &ISO3_XNUM[i]);
    for (int i = 0; i < 3; i++) fp2_from_raw(&XDEN[i], &ISO3_XDEN[i]);
    for (int i = 0; i < 4; i++) fp2_from_raw(&YNUM[i], &ISO3_YNUM[i]);
    for (int i = 0; i < 4; i++) fp2_from_raw(&YDEN[i], &ISO3_YDEN[i]);
    INITED = 1;
}

/* ---- exported surface (ctypes) -------------------------------------- */

/* Decompress + KeyValidate a G1 pubkey: writes x||y (96 raw BE bytes).
 * Returns 1 ok; 0 invalid (off-curve / wrong subgroup / infinity). */
int bls_g1_pubkey_check(const uint8_t in[48], uint8_t out_xy[96]) {
    ensure_init();
    g1a a;
    if (!g1_decompress(&a, in)) return 0;
    if (a.inf) return 0;
    if (!g1_on_curve(&a)) return 0;
    if (!g1_in_subgroup(&a)) return 0;
    fp_to_bytes(out_xy, &a.x);
    fp_to_bytes(out_xy + 48, &a.y);
    return 1;
}

/* Decompress a G2 signature with the host oracle's checks (flags, x in
 * range, on the curve; no subgroup check): writes x.c0||x.c1||y.c0||y.c1
 * (192 raw BE bytes). Returns 1 ok; 0 when the encoding is invalid or the
 * infinity, which the caller's own path decides. */
int bls_g2_decompress(const uint8_t in[96], uint8_t out[192]) {
    ensure_init();
    g2a a;
    if (!g2_decompress(&a, in) || a.inf) return 0;
    fp_to_bytes(out, &a.x.c0);
    fp_to_bytes(out + 48, &a.x.c1);
    fp_to_bytes(out + 96, &a.y.c0);
    fp_to_bytes(out + 144, &a.y.c1);
    return 1;
}

/* hash a message to G2, writing x.c0||x.c1||y.c0||y.c1 (192 raw BE). */
int bls_hash_to_g2(const uint8_t *msg, uint32_t msg_len,
                   const uint8_t *dst, uint32_t dst_len,
                   uint8_t out[192]) {
    ensure_init();
    g2a h;
    hash_to_g2(&h, msg, msg_len, dst, dst_len);
    fp_to_bytes(out, &h.x.c0);
    fp_to_bytes(out + 48, &h.x.c1);
    fp_to_bytes(out + 96, &h.y.c0);
    fp_to_bytes(out + 144, &h.y.c1);
    return 1;
}

/* internal: read an uncompressed raw G1 affine point (x||y, 48+48 BE) */
static int g1_from_xy(g1a *o, const uint8_t in[96]) {
    if (!fp_from_bytes(&o->x, in)) return 0;
    if (!fp_from_bytes(&o->y, in + 48)) return 0;
    o->inf = fp_is_zero(&o->x) && fp_is_zero(&o->y);
    return 1;
}

/* Batch verification (the reference seam, blst.rs:36-119):
 *   sigs:      n_sets * 96 bytes, compressed G2
 *   pks:       sum(pk_counts) * 96 bytes, RAW affine x||y (pre-validated
 *              at admission by bls_g1_pubkey_check — mirrors the
 *              reference's decompress-once ValidatorPubkeyCache)
 *   pk_counts: n_sets u32
 *   msgs:      n_sets * 32 bytes
 *   rands:     n_sets * 8 bytes little-endian, nonzero 64-bit scalars
 *   dst:       domain separation tag for hash-to-curve
 * Returns 1 iff every set verifies. Caller screens the blst edge rules
 * (empty batch / empty set / infinity signature => false) beforehand;
 * this function re-checks what it can see cheaply. */
int bls_verify_signature_sets(uint32_t n_sets,
                              const uint8_t *sigs,
                              const uint8_t *pks,
                              const uint32_t *pk_counts,
                              const uint8_t *msgs,
                              const uint8_t *rands,
                              const uint8_t *dst, uint32_t dst_len) {
    ensure_init();
    if (n_sets == 0) return 0;

    enum { MAXN = 1024, MAXMSG = 1024 };
    if (n_sets > MAXN) {
        /* split recursively: all chunks must pass */
        uint32_t half = n_sets / 2;
        uint64_t pk_off = 0;
        for (uint32_t i = 0; i < half; i++) pk_off += pk_counts[i];
        return bls_verify_signature_sets(half, sigs, pks, pk_counts, msgs, rands, dst, dst_len)
            && bls_verify_signature_sets(n_sets - half, sigs + (uint64_t)half * 96,
                                         pks + pk_off * 96, pk_counts + half,
                                         msgs + (uint64_t)half * 32,
                                         rands + (uint64_t)half * 8, dst, dst_len);
    }

    static __thread g1a g1_sides[MAXN + 1];
    static __thread g2a g2_sides[MAXN + 1];
    static __thread g2p scratch[MAXN + 1];
    /* distinct-message hash cache (linear scan; gossip batches share few
     * distinct AttestationData roots) */
    static __thread uint8_t seen_msg[MAXMSG][32];
    static __thread g2a seen_h[MAXMSG];
    int n_seen = 0;

    g2p sig_acc;
    g2_set_inf(&sig_acc);

    uint64_t pk_off = 0;
    for (uint32_t i = 0; i < n_sets; i++) {
        uint32_t k = pk_counts[i];
        if (k == 0) return 0;

        g2a sig;
        if (!g2_decompress(&sig, sigs + (uint64_t)i * 96)) return 0;
        if (sig.inf) return 0;
        if (!g2_on_curve(&sig)) return 0;
        if (!g2_in_subgroup(&sig)) return 0;

        /* aggregate the set's pubkeys */
        g1p agg;
        g1_set_inf(&agg);
        for (uint32_t j = 0; j < k; j++) {
            g1a pk;
            if (!g1_from_xy(&pk, pks + (pk_off + j) * 96)) return 0;
            if (pk.inf) return 0;
            g1p pkj;
            g1_from_affine(&pkj, &pk);
            g1_add(&agg, &agg, &pkj);
        }
        pk_off += k;
        if (agg.inf || fp_is_zero(&agg.z)) return 0;

        uint64_t r = 0;
        for (int b = 0; b < 8; b++) r |= (uint64_t)rands[i * 8 + b] << (8 * b);
        if (r == 0) return 0;

        /* [r] agg_pk */
        uint64_t rl[1] = {r};
        g1p ra;
        g1_mul(&ra, &agg, rl, 1);
        g1_to_affine(&g1_sides[i], &ra);

        /* sig_acc += [r] sig */
        g2p sj, rs;
        g2_from_affine(&sj, &sig);
        g2_mul_u64(&rs, &sj, r);
        g2_add(&sig_acc, &sig_acc, &rs);

        /* H(m): cached per distinct message */
        const uint8_t *m = msgs + (uint64_t)i * 32;
        int found = -1;
        for (int s = 0; s < n_seen; s++)
            if (memcmp(seen_msg[s], m, 32) == 0) { found = s; break; }
        if (found < 0) {
            if (n_seen >= MAXMSG) return 0;
            memcpy(seen_msg[n_seen], m, 32);
            hash_to_g2(&seen_h[n_seen], m, 32, dst, dst_len);
            found = n_seen++;
        }
        g2_sides[i] = seen_h[found];
    }

    /* last pair: (-g1_gen, sig_acc) */
    g1_sides[n_sets] = G1_GEN;
    fp_neg(&g1_sides[n_sets].y, &G1_GEN.y);
    g2_to_affine(&g2_sides[n_sets], &sig_acc);

    fp12 f, e;
    miller_loop_n(&f, g1_sides, g2_sides, (int)n_sets + 1, scratch);
    final_exp(&e, &f);
    return fp12_is_one(&e);
}

/* aggregate_verify: ONE signature over per-pubkey messages.
 * pks raw affine (n*96), msgs n*32. */
int bls_aggregate_verify(uint32_t n,
                         const uint8_t sig_comp[96],
                         const uint8_t *pks,
                         const uint8_t *msgs,
                         const uint8_t *dst, uint32_t dst_len) {
    ensure_init();
    if (n == 0) return 0;
    enum { MAXN = 1024 };
    if (n > MAXN) return 0;
    static __thread g1a g1_sides[MAXN + 1];
    static __thread g2a g2_sides[MAXN + 1];
    static __thread g2p scratch[MAXN + 1];

    g2a sig;
    if (!g2_decompress(&sig, sig_comp)) return 0;
    if (sig.inf) return 0;
    if (!g2_on_curve(&sig) || !g2_in_subgroup(&sig)) return 0;

    for (uint32_t i = 0; i < n; i++) {
        if (!g1_from_xy(&g1_sides[i], pks + (uint64_t)i * 96)) return 0;
        if (g1_sides[i].inf) return 0;
        hash_to_g2(&g2_sides[i], msgs + (uint64_t)i * 32, 32, dst, dst_len);
    }
    g1_sides[n] = G1_GEN;
    fp_neg(&g1_sides[n].y, &G1_GEN.y);
    g2_sides[n] = sig;

    fp12 f, e;
    miller_loop_n(&f, g1_sides, g2_sides, (int)n + 1, scratch);
    final_exp(&e, &f);
    return fp12_is_one(&e);
}

/* compress a G2 affine point to the 96-byte wire form */
static void g2_compress(uint8_t out[96], const g2a *a) {
    if (a->inf) {
        memset(out, 0, 96);
        out[0] = 0xC0;
        return;
    }
    fp_to_bytes(out, &a->x.c1);
    fp_to_bytes(out + 48, &a->x.c0);
    fp2 ny;
    fp2_neg(&ny, &a->y);
    int larger = fp2_lex_gt(&a->y, &ny);
    out[0] |= 0x80 | (larger ? 0x20 : 0);
}

/* sign: [sk] H(msg) -> compressed G2. sk is 32 big-endian bytes (mod r
 * already enforced by the caller). Bench/test helper — validator signing
 * stays host-side in production, this keeps workload generation fast. */
int bls_sign(const uint8_t sk_be[32], const uint8_t *msg, uint32_t msg_len,
             const uint8_t *dst, uint32_t dst_len, uint8_t out_sig[96]) {
    ensure_init();
    g2a h;
    hash_to_g2(&h, msg, msg_len, dst, dst_len);
    uint64_t e[4] = {0};
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++)
            e[i] |= (uint64_t)sk_be[32 - 8 * (i + 1) + (7 - j)] << (8 * j);
    g2p p, s;
    g2_from_affine(&p, &h);
    /* 256-bit double-and-add */
    g2_set_inf(&s);
    int started = 0;
    for (int i = 3; i >= 0; i--)
        for (int b = 63; b >= 0; b--) {
            if (started) g2_dbl(&s, &s);
            if ((e[i] >> b) & 1) {
                if (!started) { s = p; started = 1; }
                else g2_add(&s, &s, &p);
            }
        }
    g2a sa;
    if (!started) { sa.inf = 1; sa.x = FP2_ZERO; sa.y = FP2_ZERO; }
    else g2_to_affine(&sa, &s);
    g2_compress(out_sig, &sa);
    return 1;
}

/* sk -> pubkey: [sk] G1_gen, written as raw affine x||y (96 BE bytes). */
int bls_sk_to_pk(const uint8_t sk_be[32], uint8_t out_xy[96]) {
    ensure_init();
    uint64_t e[4] = {0};
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++)
            e[i] |= (uint64_t)sk_be[32 - 8 * (i + 1) + (7 - j)] << (8 * j);
    g1p g, s;
    g1_from_affine(&g, &G1_GEN);
    g1_mul(&s, &g, e, 4);
    g1a a;
    g1_to_affine(&a, &s);
    if (a.inf) return 0;
    fp_to_bytes(out_xy, &a.x);
    fp_to_bytes(out_xy + 48, &a.y);
    return 1;
}

/* debug taps for the hash-to-curve pipeline (used by tests only) */
int bls_dbg_expand(const uint8_t *msg, uint32_t msg_len,
                   const uint8_t *dst, uint32_t dst_len, uint8_t out[256]) {
    ensure_init();
    expand_xmd(out, 256, msg, msg_len, dst, dst_len);
    return 1;
}

int bls_dbg_field(const uint8_t in[64], uint8_t out[48]) {
    ensure_init();
    fp u;
    fp_from_be64_mod(&u, in);
    fp_to_bytes(out, &u);
    return 1;
}

int bls_dbg_sswu(const uint8_t u_raw[96], uint8_t out[192]) {
    ensure_init();
    fp2 u, x, y;
    if (!fp_from_bytes(&u.c0, u_raw)) return 0;
    if (!fp_from_bytes(&u.c1, u_raw + 48)) return 0;
    sswu(&x, &y, &u);
    fp_to_bytes(out, &x.c0);
    fp_to_bytes(out + 48, &x.c1);
    fp_to_bytes(out + 96, &y.c0);
    fp_to_bytes(out + 144, &y.c1);
    return 1;
}

int bls_dbg_iso3(const uint8_t xy_raw[192], uint8_t out[192]) {
    ensure_init();
    fp2 x, y;
    g2a o;
    if (!fp_from_bytes(&x.c0, xy_raw)) return 0;
    if (!fp_from_bytes(&x.c1, xy_raw + 48)) return 0;
    if (!fp_from_bytes(&y.c0, xy_raw + 96)) return 0;
    if (!fp_from_bytes(&y.c1, xy_raw + 144)) return 0;
    iso3(&o, &x, &y);
    fp_to_bytes(out, &o.x.c0);
    fp_to_bytes(out + 48, &o.x.c1);
    fp_to_bytes(out + 96, &o.y.c0);
    fp_to_bytes(out + 144, &o.y.c1);
    return 1;
}

/* Self-test: bilinearity e(2P, Q) == e(P, Q)^2 on the generators, plus a
 * sign/hash sanity loop. Returns 1 on success. */
int bls_selftest(void) {
    ensure_init();
    /* e(G1, G2) should be != 1; e(-G1, G2)*e(G1, G2) == 1 */
    g1a ps[2];
    g2a qs[2];
    g2p scratch[2];
    ps[0] = G1_GEN;
    ps[1] = G1_GEN;
    fp_neg(&ps[1].y, &G1_GEN.y);
    qs[0] = G2_GEN_A;
    qs[1] = G2_GEN_A;
    fp12 f, e;
    miller_loop_n(&f, ps, qs, 2, scratch);
    final_exp(&e, &f);
    if (!fp12_is_one(&e)) return 0;
    /* single pairing must NOT be one */
    miller_loop_n(&f, ps, qs, 1, scratch);
    final_exp(&e, &f);
    if (fp12_is_one(&e)) return 0;
    /* generators on curve + in subgroup */
    if (!g1_on_curve(&G1_GEN) || !g1_in_subgroup(&G1_GEN)) return 0;
    if (!g2_on_curve(&G2_GEN_A) || !g2_in_subgroup(&G2_GEN_A)) return 0;
    return 1;
}

#ifdef __cplusplus
}
#endif
