/* Native Snappy raw-block codec (the wire codec of the gossip/req-resp
 * layer and the .ssz_snappy vector files).
 *
 * The reference links the Rust `snap` crate for its SSZ-snappy codecs
 * (lighthouse_network/src/rpc/codec/ssz_snappy.rs); this is the same
 * algorithm in plain C: greedy 4-byte hash matching within 64 KiB
 * blocks, literal + copy1/copy2 emission. The Python layer keeps a
 * pure-Python fallback (utils/snappy.py) so a missing toolchain degrades
 * to slow-not-broken.
 *
 * Exported ABI (ctypes):
 *   size_t lt_snappy_max_compressed(size_t n);
 *   size_t lt_snappy_compress(const uint8_t* in, size_t n, uint8_t* out);
 *   long   lt_snappy_uncompressed_length(const uint8_t* in, size_t n);
 *   long   lt_snappy_decompress(const uint8_t* in, size_t n,
 *                               uint8_t* out, size_t cap);
 *       -> bytes written, or -1 on malformed input / overflow.
 */

#include <stdint.h>
#include <string.h>
#include <stddef.h>

#define BLOCK_LOG 16
#define BLOCK_SIZE (1u << BLOCK_LOG)
#define HASH_BITS 14
#define HASH_SIZE (1u << HASH_BITS)

static inline uint32_t load32(const uint8_t *p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

static inline uint32_t hash32(uint32_t v) {
    return (v * 0x1e35a7bdu) >> (32 - HASH_BITS);
}

static uint8_t *emit_uvarint(uint8_t *out, size_t n) {
    while (n >= 0x80) {
        *out++ = (uint8_t)(n | 0x80);
        n >>= 7;
    }
    *out++ = (uint8_t)n;
    return out;
}

static uint8_t *emit_literal(uint8_t *out, const uint8_t *src, size_t len) {
    if (len == 0) return out;
    size_t n = len - 1;
    if (n < 60) {
        *out++ = (uint8_t)(n << 2);
    } else if (n < (1u << 8)) {
        *out++ = 60 << 2;
        *out++ = (uint8_t)n;
    } else if (n < (1u << 16)) {
        *out++ = 61 << 2;
        *out++ = (uint8_t)n;
        *out++ = (uint8_t)(n >> 8);
    } else if (n < (1u << 24)) {
        *out++ = 62 << 2;
        *out++ = (uint8_t)n;
        *out++ = (uint8_t)(n >> 8);
        *out++ = (uint8_t)(n >> 16);
    } else {
        *out++ = 63 << 2;
        *out++ = (uint8_t)n;
        *out++ = (uint8_t)(n >> 8);
        *out++ = (uint8_t)(n >> 16);
        *out++ = (uint8_t)(n >> 24);
    }
    memcpy(out, src, len);
    return out + len;
}

/* one copy element, 4 <= len <= 64, offset < 65536 */
static uint8_t *emit_copy_one(uint8_t *out, size_t offset, size_t len) {
    if (len >= 4 && len <= 11 && offset < 2048) {
        *out++ = (uint8_t)(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
        *out++ = (uint8_t)offset;
    } else {
        *out++ = (uint8_t)(2 | ((len - 1) << 2));
        *out++ = (uint8_t)offset;
        *out++ = (uint8_t)(offset >> 8);
    }
    return out;
}

static uint8_t *emit_copy(uint8_t *out, size_t offset, size_t len) {
    /* chunk >64 so every element is legal and the tail stays >= 4 */
    while (len >= 68) {
        out = emit_copy_one(out, offset, 64);
        len -= 64;
    }
    if (len > 64) {
        out = emit_copy_one(out, offset, 60);
        len -= 60;
    }
    return emit_copy_one(out, offset, len);
}

size_t lt_snappy_max_compressed(size_t n) {
    return 32 + n + n / 6;
}

static uint8_t *compress_block(const uint8_t *in, size_t n, uint8_t *out,
                               uint16_t *table) {
    memset(table, 0, HASH_SIZE * sizeof(uint16_t));
    size_t ip = 0, anchor = 0;
    if (n >= 15) {
        size_t ip_limit = n - 4;
        uint32_t skip = 32; /* snappy's literal-run acceleration */
        ip = 1;
        while (ip <= ip_limit) {
            uint32_t v = load32(in + ip);
            uint32_t h = hash32(v);
            size_t cand = table[h];
            table[h] = (uint16_t)ip;
            if (cand < ip && load32(in + cand) == v) {
                out = emit_literal(out, in + anchor, ip - anchor);
                size_t len = 4;
                size_t maxlen = n - ip;
                while (len < maxlen && in[cand + len] == in[ip + len]) len++;
                out = emit_copy(out, ip - cand, len);
                ip += len;
                anchor = ip;
                skip = 32;
                if (ip <= ip_limit && ip >= 2) {
                    /* re-prime the table at the new position - 1 */
                    table[hash32(load32(in + ip - 1))] = (uint16_t)(ip - 1);
                }
            } else {
                ip += (skip++ >> 5);
            }
        }
    }
    return emit_literal(out, in + anchor, n - anchor);
}

size_t lt_snappy_compress(const uint8_t *in, size_t n, uint8_t *out) {
    uint16_t table[HASH_SIZE];
    uint8_t *op = emit_uvarint(out, n);
    size_t pos = 0;
    while (pos < n) {
        size_t blk = n - pos < BLOCK_SIZE ? n - pos : BLOCK_SIZE;
        op = compress_block(in + pos, blk, op, table);
        pos += blk;
    }
    return (size_t)(op - out);
}

static long read_uvarint(const uint8_t *in, size_t n, size_t *pos) {
    size_t out = 0;
    unsigned shift = 0;
    while (1) {
        if (*pos >= n || shift > 63) return -1;
        uint8_t b = in[(*pos)++];
        out |= (size_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) return (long)out;
        shift += 7;
    }
}

long lt_snappy_uncompressed_length(const uint8_t *in, size_t n) {
    size_t pos = 0;
    return read_uvarint(in, n, &pos);
}

long lt_snappy_decompress(const uint8_t *in, size_t n, uint8_t *out,
                          size_t cap) {
    size_t pos = 0;
    long want = read_uvarint(in, n, &pos);
    if (want < 0 || (size_t)want > cap) return -1;
    size_t op = 0;
    while (pos < n) {
        uint8_t tag = in[pos++];
        uint32_t kind = tag & 3;
        if (kind == 0) { /* literal */
            size_t len = (tag >> 2) + 1;
            if (len > 60) {
                unsigned extra = (unsigned)(len - 60);
                if (pos + extra > n) return -1;
                len = 0;
                for (unsigned i = 0; i < extra; i++)
                    len |= (size_t)in[pos + i] << (8 * i);
                len += 1;
                pos += extra;
            }
            if (pos + len > n || op + len > cap) return -1;
            memcpy(out + op, in + pos, len);
            pos += len;
            op += len;
        } else {
            size_t len, offset;
            if (kind == 1) {
                len = ((tag >> 2) & 0x7) + 4;
                if (pos >= n) return -1;
                offset = ((size_t)(tag >> 5) << 8) | in[pos++];
            } else if (kind == 2) {
                len = (tag >> 2) + 1;
                if (pos + 2 > n) return -1;
                offset = (size_t)in[pos] | ((size_t)in[pos + 1] << 8);
                pos += 2;
            } else {
                len = (tag >> 2) + 1;
                if (pos + 4 > n) return -1;
                offset = (size_t)in[pos] | ((size_t)in[pos + 1] << 8) |
                         ((size_t)in[pos + 2] << 16) |
                         ((size_t)in[pos + 3] << 24);
                pos += 4;
            }
            if (offset == 0 || offset > op || op + len > cap) return -1;
            /* byte-wise: copies may overlap (run-length encoding) */
            for (size_t i = 0; i < len; i++) {
                out[op + i] = out[op + i - offset];
            }
            op += len;
        }
    }
    if ((long)op != want) return -1;
    return (long)op;
}
