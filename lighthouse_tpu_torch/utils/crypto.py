"""The port's own symmetric and Diffie-Hellman primitives, so that the
network and the keystores need no ``cryptography`` package:

* :func:`x25519` (RFC 7748 §5), pure Python: the Noise handshake runs it
  four times per connection;
* :class:`ChaCha20Poly1305` (RFC 8439 §2.8), the AEAD of every transport
  frame: the C library ``_native/chacha20poly1305.c``, built at first use
  through ``_native.build_and_load``, with a pure-Python twin that gives
  the same bytes. When the build fails the twin serves, and the fallback
  is logged once;
* :func:`aes128_ctr` (FIPS 197 with the 128-bit big-endian counter of
  NIST SP 800-38A), pure Python: an EIP-2335 keystore secret is two
  blocks.

The interfaces are those of the ``cryptography`` calls the JAX package
makes (``ChaCha20Poly1305(key).encrypt(nonce, data, ad)``, ``InvalidTag``),
so the ported modules keep their shape. None of this is constant-time
Python; the C AEAD compares tags in constant time.
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import threading

_log = logging.getLogger(__name__)


class InvalidTag(Exception):
    """The AEAD tag does not authenticate the ciphertext and data."""


# ---------------------------------------------------------------------------
# X25519 (RFC 7748)
# ---------------------------------------------------------------------------

_P = 2**255 - 19
_A24 = 121665
BASE_POINT = (9).to_bytes(32, "little")


def _clamp(k: bytes) -> int:
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(b, "little")


def x25519(k: bytes, u: bytes) -> bytes:
    """The X25519 function of scalar ``k`` and u-coordinate ``u`` (both 32
    bytes, little-endian). Raises ``ValueError`` when the result is all
    zeros (a small-order ``u``), as ``cryptography``'s exchange does."""
    if len(k) != 32 or len(u) != 32:
        raise ValueError("X25519 keys are 32 bytes")
    scalar = _clamp(k)
    x1 = int.from_bytes(u, "little") & ((1 << 255) - 1)
    x2, z2, x3, z3, swap = 1, 0, x1, 1, 0
    for t in range(254, -1, -1):
        bit = (scalar >> t) & 1
        if swap ^ bit:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = bit
        a = x2 + z2
        aa = a * a % _P
        b = x2 - z2
        bb = b * b % _P
        e = aa - bb
        c = x3 + z3
        d = x3 - z3
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) ** 2 % _P
        z3 = x1 * (da - cb) ** 2 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, z2 = x3, z3
    out = (x2 * pow(z2, _P - 2, _P) % _P).to_bytes(32, "little")
    if out == bytes(32):
        raise ValueError("X25519 result is all zeros (small-order point)")
    return out


def x25519_public(k: bytes) -> bytes:
    """The public key (u-coordinate) of private key ``k``."""
    return x25519(k, BASE_POINT)


def x25519_private() -> bytes:
    """A fresh private key from the operating system's generator."""
    return os.urandom(32)


# ---------------------------------------------------------------------------
# ChaCha20-Poly1305 (RFC 8439)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _chacha20_block(key_words, counter: int, nonce_words) -> bytes:
    s = [*_SIGMA, *key_words, counter & _M32, *nonce_words]
    x = list(s)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & _M32
        v = x[d] ^ x[a]
        x[d] = ((v << 16) | (v >> 16)) & _M32
        x[c] = (x[c] + x[d]) & _M32
        v = x[b] ^ x[c]
        x[b] = ((v << 12) | (v >> 20)) & _M32
        x[a] = (x[a] + x[b]) & _M32
        v = x[d] ^ x[a]
        x[d] = ((v << 8) | (v >> 24)) & _M32
        x[c] = (x[c] + x[d]) & _M32
        v = x[b] ^ x[c]
        x[b] = ((v << 7) | (v >> 25)) & _M32

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return struct.pack("<16I", *((a + b) & _M32 for a, b in zip(x, s)))


def _chacha20_xor(key_words, counter: int, nonce_words, data: bytes) -> bytes:
    out = bytearray(len(data))
    for i in range(0, len(data), 64):
        chunk = data[i:i + 64]
        ks = _chacha20_block(key_words, counter + i // 64, nonce_words)
        n = len(chunk)
        out[i:i + n] = (int.from_bytes(chunk, "little")
                        ^ int.from_bytes(ks[:n], "little")).to_bytes(n, "little")
    return bytes(out)


def _poly1305(key: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key[16:], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        block = msg[i:i + 16]
        acc = (acc + int.from_bytes(block + b"\x01", "little")) * r % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(n: int) -> bytes:
    return bytes(-n % 16)


def _mac_data(ad: bytes, ct: bytes) -> bytes:
    return (ad + _pad16(len(ad)) + ct + _pad16(len(ct))
            + struct.pack("<QQ", len(ad), len(ct)))


def _py_seal(key: bytes, nonce: bytes, data: bytes, ad: bytes) -> bytes:
    kw, nw = struct.unpack("<8I", key), struct.unpack("<3I", nonce)
    otk = _chacha20_block(kw, 0, nw)[:32]
    ct = _chacha20_xor(kw, 1, nw, data)
    return ct + _poly1305(otk, _mac_data(ad, ct))


def _py_open(key: bytes, nonce: bytes, data: bytes, ad: bytes) -> bytes:
    if len(data) < 16:
        raise InvalidTag("ciphertext shorter than a tag")
    kw, nw = struct.unpack("<8I", key), struct.unpack("<3I", nonce)
    ct, tag = data[:-16], data[-16:]
    otk = _chacha20_block(kw, 0, nw)[:32]
    import hmac

    if not hmac.compare_digest(_poly1305(otk, _mac_data(ad, ct)), tag):
        raise InvalidTag("AEAD tag mismatch")
    return _chacha20_xor(kw, 1, nw, ct)


_lib = None
_loaded = False
_load_lock = threading.Lock()


def _native():
    """The C AEAD, or None when it cannot be built (decided once; the
    fallback to the twin is logged)."""
    global _lib, _loaded
    if not _loaded:
        with _load_lock:
            if not _loaded:
                from .. import _native as native_build

                try:
                    lib = native_build.build_and_load("chacha20poly1305")
                    args = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                            ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
                            ctypes.c_char_p]
                    for fn in (lib.lt_aead_seal, lib.lt_aead_open):
                        fn.argtypes = args
                        fn.restype = ctypes.c_int
                    _lib = lib
                except (native_build.NativeBuildError, OSError, AttributeError) as e:
                    _log.warning("ChaCha20-Poly1305: the C build failed, the pure-Python "
                                 "twin serves (%s)", str(e).splitlines()[0] if str(e) else e)
                    _lib = None
                _loaded = True
    return _lib


class ChaCha20Poly1305:
    """``cryptography``'s AEAD interface: ``encrypt(nonce, data, ad)``
    returns ciphertext and tag, ``decrypt`` raises :class:`InvalidTag`."""

    __slots__ = ("_key",)

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)

    @staticmethod
    def _check(nonce: bytes) -> None:
        if len(nonce) != 12:
            raise ValueError("ChaCha20Poly1305 nonce must be 12 bytes")

    def encrypt(self, nonce: bytes, data: bytes, associated_data: bytes | None) -> bytes:
        self._check(nonce)
        ad = associated_data or b""
        lib = _native()
        if lib is None:
            return _py_seal(self._key, nonce, bytes(data), bytes(ad))
        out = ctypes.create_string_buffer(len(data) + 16)
        lib.lt_aead_seal(self._key, bytes(nonce), bytes(ad), len(ad), bytes(data), len(data),
                         out)
        return out.raw

    def decrypt(self, nonce: bytes, data: bytes, associated_data: bytes | None) -> bytes:
        self._check(nonce)
        ad = associated_data or b""
        lib = _native()
        if lib is None:
            return _py_open(self._key, nonce, bytes(data), bytes(ad))
        if len(data) < 16:
            raise InvalidTag("ciphertext shorter than a tag")
        out = ctypes.create_string_buffer(max(1, len(data) - 16))
        if lib.lt_aead_open(self._key, bytes(nonce), bytes(ad), len(ad), bytes(data),
                            len(data), out) != 0:
            raise InvalidTag("AEAD tag mismatch")
        return out.raw[:len(data) - 16]


# ---------------------------------------------------------------------------
# AES-128-CTR (FIPS 197)
# ---------------------------------------------------------------------------

def _sbox() -> bytes:
    """The AES S-box from its definition: the inverse in GF(2^8) followed
    by the affine map."""
    def mul(a, b):
        p = 0
        while b:
            if b & 1:
                p ^= a
            a = ((a << 1) ^ 0x11B) if a & 0x80 else a << 1
            b >>= 1
        return p

    inv = [0] * 256
    for a in range(1, 256):
        for b in range(1, 256):
            if mul(a, b) == 1:
                inv[a] = b
                break
    out = bytearray(256)
    for a in range(256):
        x = inv[a]
        y = x
        for _ in range(4):
            x = ((x << 1) | (x >> 7)) & 0xFF
            y ^= x
        out[a] = y ^ 0x63
    return bytes(out)


_SBOX = None


def _xtime(a: int) -> int:
    return ((a << 1) ^ 0x1B) & 0xFF if a & 0x80 else a << 1


def _expand_key(key: bytes) -> list:
    """The eleven 16-byte round keys of AES-128."""
    words = [list(key[i:i + 4]) for i in range(0, 16, 4)]
    rcon = 1
    for i in range(4, 44):
        w = list(words[i - 1])
        if i % 4 == 0:
            w = [_SBOX[b] for b in w[1:] + w[:1]]
            w[0] ^= rcon
            rcon = _xtime(rcon)
        words.append([a ^ b for a, b in zip(words[i - 4], w)])
    return [sum(words[4 * r:4 * r + 4], []) for r in range(11)]


def _encrypt_block(round_keys: list, block: bytes) -> bytes:
    s = [b ^ k for b, k in zip(block, round_keys[0])]
    for r in range(1, 11):
        s = [_SBOX[b] for b in s]
        # ShiftRows: the state is column-major, byte (row, col) at 4 * col + row
        s = [s[(4 * (c + row) + row) % 16] for c in range(4) for row in range(4)]
        if r < 10:
            mixed = []
            for c in range(4):
                a = s[4 * c:4 * c + 4]
                t = a[0] ^ a[1] ^ a[2] ^ a[3]
                mixed += [a[i] ^ t ^ _xtime(a[i] ^ a[(i + 1) % 4]) for i in range(4)]
            s = mixed
        s = [b ^ k for b, k in zip(s, round_keys[r])]
    return bytes(s)


def aes128_ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    """AES-128 in counter mode: ``iv`` is the first 16-byte counter block,
    incremented as one big-endian 128-bit integer (``cryptography``'s
    ``modes.CTR``). Encryption and decryption are the same call."""
    global _SBOX
    if len(key) != 16 or len(iv) != 16:
        raise ValueError("AES-128-CTR takes a 16-byte key and a 16-byte counter block")
    if _SBOX is None:
        _SBOX = _sbox()
    rks = _expand_key(bytes(key))
    ctr = int.from_bytes(iv, "big")
    out = bytearray()
    for i in range(0, len(data), 16):
        ks = _encrypt_block(rks, ((ctr + i // 16) % (1 << 128)).to_bytes(16, "big"))
        out += bytes(a ^ b for a, b in zip(data[i:i + 16], ks))
    return bytes(out)
