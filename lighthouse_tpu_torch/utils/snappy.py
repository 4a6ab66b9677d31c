"""Snappy codec: raw block format + framing format.

Used by the ef_tests harness (``.ssz_snappy`` vector files) and the
networking layer's SSZ-snappy encodings (reference: gossip payloads use
raw snappy blocks; req/resp streams use the framing format —
``lighthouse_network/src/rpc/codec/ssz_snappy.rs``).

The raw-block hot path (every gossip frame) prefers the NATIVE C codec
(``_native/snappy.c`` — real hash-match compression, the algorithm the
reference gets from the Rust ``snap`` crate); the pure-Python
implementation remains as fallback and as the framing-format layer. The
port's copy of the JAX package's codec: ``_native/snappy.c`` is built at
the first call through ``_native.build_and_load``, as ``ssz/sha256.py``
builds its C source.
"""

from __future__ import annotations

import struct
import threading

_FRAME_MAGIC = b"\xff\x06\x00\x00sNaPpY"


class SnappyError(ValueError):
    pass


# ---------------------------------------------------------------------------
# varint
# ---------------------------------------------------------------------------

def _read_uvarint(data: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise SnappyError("truncated varint")
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 63:
            raise SnappyError("varint too long")


def _write_uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


# ---------------------------------------------------------------------------
# raw block format
# ---------------------------------------------------------------------------

def _native_lib():
    """The C codec, or None when it cannot be built (decided once, at the
    first call, never at import; the pure-Python codec then serves)."""
    global _NATIVE
    if _NATIVE is _UNSET:
        with _LOAD_LOCK:
            if _NATIVE is _UNSET:
                _NATIVE = _load()
    return _NATIVE


def _load():
    import ctypes

    from .. import _native as native_build

    try:
        lib = native_build.build_and_load("snappy")
    except (native_build.NativeBuildError, OSError):
        return None
    lib.lt_snappy_max_compressed.restype = ctypes.c_size_t
    lib.lt_snappy_max_compressed.argtypes = [ctypes.c_size_t]
    lib.lt_snappy_compress.restype = ctypes.c_size_t
    lib.lt_snappy_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    lib.lt_snappy_uncompressed_length.restype = ctypes.c_long
    lib.lt_snappy_uncompressed_length.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.lt_snappy_decompress.restype = ctypes.c_long
    lib.lt_snappy_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    return lib


_UNSET = object()
_NATIVE = _UNSET
_LOAD_LOCK = threading.Lock()


def decompress_raw(data: bytes) -> bytes:
    """Snappy raw (frame-less) block (native fast path)."""
    lib = _native_lib()
    if lib is not None:
        import ctypes

        want = lib.lt_snappy_uncompressed_length(data, len(data))
        # An attacker controls the length header: allocate only what a
        # VALID stream of this size could produce (a 3-byte copy element
        # emits <= 64 bytes, so expansion is < 64x + slack) — a 5-byte
        # frame claiming 2 GiB must fail before any big allocation.
        if want < 0 or want > 64 * len(data) + 64:
            raise SnappyError("bad uncompressed length")
        buf = ctypes.create_string_buffer(max(int(want), 1))
        got = lib.lt_snappy_decompress(data, len(data), buf, want)
        if got < 0:
            raise SnappyError("malformed snappy block")
        return ctypes.string_at(buf, got)
    return _decompress_raw_py(data)


def _decompress_raw_py(data: bytes) -> bytes:
    """Snappy raw (frame-less) block, pure Python."""
    expected, pos = _read_uvarint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = tag >> 2
            if length >= 60:
                extra = length - 59
                if pos + extra > n:
                    raise SnappyError("truncated literal length")
                length = int.from_bytes(data[pos:pos + extra], "little")
                pos += extra
            length += 1
            if pos + length > n:
                raise SnappyError("truncated literal")
            out += data[pos:pos + length]
            pos += length
            continue
        if kind == 1:  # copy, 1-byte offset
            length = ((tag >> 2) & 0x7) + 4
            if pos >= n:
                raise SnappyError("truncated copy-1")
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            if pos + 2 > n:
                raise SnappyError("truncated copy-2")
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            if pos + 4 > n:
                raise SnappyError("truncated copy-4")
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise SnappyError("invalid copy offset")
        # overlapping copies are the point (RLE-style); copy byte-wise
        start = len(out) - offset
        for i in range(length):
            out.append(out[start + i])
    if len(out) != expected:
        raise SnappyError(
            f"decompressed length {len(out)} != header {expected}"
        )
    return bytes(out)


def compress_raw(data: bytes) -> bytes:
    """Raw block (native hash-match compression when available)."""
    lib = _native_lib()
    if lib is not None:
        import ctypes

        cap = lib.lt_snappy_max_compressed(len(data))
        buf = ctypes.create_string_buffer(int(cap))
        n = lib.lt_snappy_compress(data, len(data), buf)
        return ctypes.string_at(buf, n)
    return _compress_raw_py(data)


def _compress_raw_py(data: bytes) -> bytes:
    """Literal-only raw block (valid per the format spec)."""
    out = bytearray(_write_uvarint(len(data)))
    pos = 0
    while pos < len(data):
        chunk = data[pos:pos + 65536]
        pos += len(chunk)
        L = len(chunk) - 1
        if L < 60:
            out.append(L << 2)
        elif L < 1 << 8:
            out.append(60 << 2)
            out.append(L)
        elif L < 1 << 16:
            out.append(61 << 2)
            out += L.to_bytes(2, "little")
        else:
            out.append(62 << 2)
            out += L.to_bytes(3, "little")
        out += chunk
    return bytes(out)


# ---------------------------------------------------------------------------
# framing format
# ---------------------------------------------------------------------------

_CRC32C_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    # snappy frame "masked" crc
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def decompress_frames(data: bytes) -> bytes:
    """Snappy framing format stream."""
    if not data.startswith(_FRAME_MAGIC):
        raise SnappyError("missing stream identifier")
    pos = len(_FRAME_MAGIC)
    out = bytearray()
    n = len(data)
    while pos < n:
        if pos + 4 > n:
            raise SnappyError("truncated chunk header")
        kind = data[pos]
        length = int.from_bytes(data[pos + 1:pos + 4], "little")
        pos += 4
        chunk = data[pos:pos + length]
        if len(chunk) != length:
            raise SnappyError("truncated chunk body")
        pos += length
        if kind == 0x00:  # compressed data
            body = decompress_raw(chunk[4:])
            _check_crc(chunk[:4], body)
            out += body
        elif kind == 0x01:  # uncompressed data
            body = chunk[4:]
            _check_crc(chunk[:4], body)
            out += body
        elif kind == 0xFF:  # stream identifier (repeated)
            continue
        elif 0x80 <= kind <= 0xFE:  # skippable padding (0xFE = spec padding chunk)
            continue
        else:
            raise SnappyError(f"unknown chunk type 0x{kind:02x}")
    return bytes(out)


def _check_crc(crc_bytes: bytes, body: bytes) -> None:
    want = int.from_bytes(crc_bytes, "little")
    got = _crc32c(body)
    if want != got:
        raise SnappyError("frame CRC mismatch")


def compress_frames(data: bytes) -> bytes:
    out = bytearray(_FRAME_MAGIC)
    pos = 0
    while pos < len(data):
        body = data[pos:pos + 65536]
        pos += len(body)
        comp = compress_raw(body)
        payload = struct.pack("<I", _crc32c(body)) + comp
        out.append(0x00)
        out += len(payload).to_bytes(3, "little")
        out += payload
    return bytes(out)


def decompress(data: bytes) -> bytes:
    """Sniff frame magic vs raw block."""
    if data.startswith(_FRAME_MAGIC):
        return decompress_frames(data)
    return decompress_raw(data)
