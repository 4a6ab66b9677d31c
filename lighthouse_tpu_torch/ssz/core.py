"""SSZ type descriptors: encode/decode + structural metadata.

Spec semantics follow the consensus-spec SimpleSerialize rules the
reference implements with derive macros (``consensus/ssz/src/``,
``consensus/ssz_derive``): little-endian uints, 4-byte offsets for
variable-size members, Bitlist delimiter bits, strict decode (every byte
consumed, offsets monotone).

Descriptors are lightweight objects; ``Container`` subclasses are both the
descriptor and the value class (fields declared in an ordered ``fields``
list, instances get attribute storage + zeroed defaults — the analogue of
the reference's ``#[derive(Encode, Decode, TreeHash)]`` structs).
"""

from __future__ import annotations

from typing import Any, Sequence

BYTES_PER_LENGTH_OFFSET = 4


class SSZError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Basic types
# ---------------------------------------------------------------------------

class _Uint:
    def __init__(self, bits: int):
        self.bits = bits
        self.size = bits // 8

    def __repr__(self):
        return f"Uint{self.bits}"

    def is_fixed(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return self.size

    def default(self) -> int:
        return 0

    def encode(self, v: int) -> bytes:
        if not 0 <= v < (1 << self.bits):
            raise SSZError(f"uint{self.bits} out of range: {v}")
        return int(v).to_bytes(self.size, "little")

    def decode(self, data: bytes) -> int:
        if len(data) != self.size:
            raise SSZError(f"uint{self.bits}: expected {self.size} bytes, got {len(data)}")
        return int.from_bytes(data, "little")


class _Boolean:
    size = 1

    def __repr__(self):
        return "Boolean"

    def is_fixed(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return 1

    def default(self) -> bool:
        return False

    def encode(self, v: bool) -> bytes:
        return b"\x01" if v else b"\x00"

    def decode(self, data: bytes) -> bool:
        if data == b"\x00":
            return False
        if data == b"\x01":
            return True
        raise SSZError(f"invalid boolean byte {data!r}")


Uint8 = _Uint(8)
Uint16 = _Uint(16)
Uint32 = _Uint(32)
Uint64 = _Uint(64)
Uint128 = _Uint(128)
Uint256 = _Uint(256)
Boolean = _Boolean()


# ---------------------------------------------------------------------------
# Byte vectors / lists (special-cased for compactness: values are `bytes`)
# ---------------------------------------------------------------------------

class ByteVector:
    def __init__(self, length: int):
        self.length = length

    def __repr__(self):
        return f"ByteVector({self.length})"

    def is_fixed(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return self.length

    def default(self) -> bytes:
        return bytes(self.length)

    def encode(self, v: bytes) -> bytes:
        v = bytes(v)
        if len(v) != self.length:
            raise SSZError(f"ByteVector({self.length}): got {len(v)} bytes")
        return v

    def decode(self, data: bytes) -> bytes:
        if len(data) != self.length:
            raise SSZError(f"ByteVector({self.length}): got {len(data)} bytes")
        return bytes(data)


class ByteList:
    def __init__(self, limit: int):
        self.limit = limit

    def __repr__(self):
        return f"ByteList({self.limit})"

    def is_fixed(self) -> bool:
        return False

    def default(self) -> bytes:
        return b""

    def encode(self, v: bytes) -> bytes:
        v = bytes(v)
        if len(v) > self.limit:
            raise SSZError(f"ByteList limit {self.limit} exceeded: {len(v)}")
        return v

    def decode(self, data: bytes) -> bytes:
        if len(data) > self.limit:
            raise SSZError(f"ByteList limit {self.limit} exceeded: {len(data)}")
        return bytes(data)


Bytes4 = ByteVector(4)
Bytes20 = ByteVector(20)
Bytes32 = ByteVector(32)
Bytes48 = ByteVector(48)
Bytes96 = ByteVector(96)


# ---------------------------------------------------------------------------
# Bit types (values are lists of bools)
# ---------------------------------------------------------------------------

def _pack_bits(bits: Sequence[bool], extra_bit_at: int | None = None) -> bytes:
    n = len(bits) + (1 if extra_bit_at is not None else 0)
    out = bytearray((n + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            out[i // 8] |= 1 << (i % 8)
    if extra_bit_at is not None:
        out[extra_bit_at // 8] |= 1 << (extra_bit_at % 8)
    return bytes(out)


class Bitvector:
    def __init__(self, length: int):
        if length <= 0:
            raise SSZError("Bitvector length must be positive")
        self.length = length

    def __repr__(self):
        return f"Bitvector({self.length})"

    def is_fixed(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return (self.length + 7) // 8

    def default(self) -> list:
        return [False] * self.length

    def encode(self, v: Sequence[bool]) -> bytes:
        if len(v) != self.length:
            raise SSZError(f"Bitvector({self.length}): got {len(v)} bits")
        return _pack_bits(v)

    def decode(self, data: bytes) -> list:
        if len(data) != self.fixed_size():
            raise SSZError(f"Bitvector({self.length}): got {len(data)} bytes")
        bits = [bool((data[i // 8] >> (i % 8)) & 1) for i in range(self.length)]
        # trailing padding bits must be zero
        for i in range(self.length, len(data) * 8):
            if (data[i // 8] >> (i % 8)) & 1:
                raise SSZError("Bitvector: nonzero padding bits")
        return bits


class Bitlist:
    def __init__(self, limit: int):
        self.limit = limit

    def __repr__(self):
        return f"Bitlist({self.limit})"

    def is_fixed(self) -> bool:
        return False

    def default(self) -> list:
        return []

    def encode(self, v: Sequence[bool]) -> bytes:
        if len(v) > self.limit:
            raise SSZError(f"Bitlist limit {self.limit} exceeded: {len(v)}")
        return _pack_bits(v, extra_bit_at=len(v))

    def decode(self, data: bytes) -> list:
        if not data:
            raise SSZError("Bitlist: empty encoding (delimiter bit required)")
        last = data[-1]
        if last == 0:
            raise SSZError("Bitlist: missing delimiter bit")
        # position of the highest set bit in the last byte
        top = last.bit_length() - 1
        n = (len(data) - 1) * 8 + top
        if n > self.limit:
            raise SSZError(f"Bitlist limit {self.limit} exceeded: {n}")
        return [bool((data[i // 8] >> (i % 8)) & 1) for i in range(n)]


# ---------------------------------------------------------------------------
# Homogeneous collections
# ---------------------------------------------------------------------------

def _encode_sequence(elem, values) -> bytes:
    if elem.is_fixed():
        return b"".join(elem.encode(v) for v in values)
    parts = [elem.encode(v) for v in values]
    offset = BYTES_PER_LENGTH_OFFSET * len(parts)
    out = bytearray()
    for p in parts:
        out += offset.to_bytes(BYTES_PER_LENGTH_OFFSET, "little")
        offset += len(p)
    for p in parts:
        out += p
    return bytes(out)


def _decode_sequence(elem, data: bytes, count: int | None) -> list:
    """count=None: infer from data (list); else exact count (vector)."""
    if elem.is_fixed():
        size = elem.fixed_size()
        if count is None:
            if len(data) % size:
                raise SSZError("sequence length not a multiple of element size")
            count = len(data) // size
        elif len(data) != size * count:
            raise SSZError("vector byte length mismatch")
        return [elem.decode(data[i * size:(i + 1) * size]) for i in range(count)]
    # variable-size elements: offset table
    if not data:
        if count not in (None, 0):
            raise SSZError("empty data for non-empty vector")
        return []
    first = int.from_bytes(data[:BYTES_PER_LENGTH_OFFSET], "little")
    if first % BYTES_PER_LENGTH_OFFSET or first == 0:
        raise SSZError("malformed first offset")
    n = first // BYTES_PER_LENGTH_OFFSET
    if count is not None and n != count:
        raise SSZError("vector element count mismatch")
    offsets = []
    for i in range(n):
        o = int.from_bytes(
            data[i * BYTES_PER_LENGTH_OFFSET:(i + 1) * BYTES_PER_LENGTH_OFFSET],
            "little",
        )
        offsets.append(o)
    offsets.append(len(data))
    if offsets[0] != n * BYTES_PER_LENGTH_OFFSET:
        raise SSZError("first offset does not point past the offset table")
    out = []
    for i in range(n):
        if offsets[i + 1] < offsets[i]:
            raise SSZError("offsets not monotone")
        out.append(elem.decode(data[offsets[i]:offsets[i + 1]]))
    return out


class Vector:
    def __init__(self, elem, length: int):
        if length <= 0:
            raise SSZError("Vector length must be positive")
        self.elem = elem
        self.length = length

    def __repr__(self):
        return f"Vector({self.elem!r}, {self.length})"

    def is_fixed(self) -> bool:
        return self.elem.is_fixed()

    def fixed_size(self) -> int:
        return self.elem.fixed_size() * self.length

    def default(self) -> list:
        return [self.elem.default() for _ in range(self.length)]

    def encode(self, v) -> bytes:
        if len(v) != self.length:
            raise SSZError(f"Vector({self.length}): got {len(v)} elements")
        return _encode_sequence(self.elem, v)

    def decode(self, data: bytes) -> list:
        return _decode_sequence(self.elem, data, self.length)


class List:
    def __init__(self, elem, limit: int):
        self.elem = elem
        self.limit = limit

    def __repr__(self):
        return f"List({self.elem!r}, {self.limit})"

    def is_fixed(self) -> bool:
        return False

    def default(self) -> list:
        return []

    def encode(self, v) -> bytes:
        if len(v) > self.limit:
            raise SSZError(f"List limit {self.limit} exceeded: {len(v)}")
        return _encode_sequence(self.elem, v)

    def decode(self, data: bytes) -> list:
        out = _decode_sequence(self.elem, data, None)
        if len(out) > self.limit:
            raise SSZError(f"List limit {self.limit} exceeded: {len(out)}")
        return out


class Union:
    """SSZ union: 1-byte selector + encoded value. ``None`` option must be
    selector 0 with empty body (per spec)."""

    def __init__(self, options):
        self.options = list(options)  # descriptors; options[0] may be None

    def is_fixed(self) -> bool:
        return False

    def default(self):
        return (0, None if self.options[0] is None else self.options[0].default())

    def encode(self, v) -> bytes:
        sel, val = v
        if not 0 <= sel < len(self.options):
            raise SSZError(f"Union selector {sel} out of range")
        opt = self.options[sel]
        if opt is None:
            if val is not None:
                raise SSZError("Union None option carries no value")
            return bytes([sel])
        return bytes([sel]) + opt.encode(val)

    def decode(self, data: bytes):
        if not data:
            raise SSZError("Union: empty encoding")
        sel = data[0]
        if sel >= len(self.options):
            raise SSZError(f"Union selector {sel} out of range")
        opt = self.options[sel]
        if opt is None:
            if len(data) != 1:
                raise SSZError("Union None option carries no value")
            return (0, None)
        return (sel, opt.decode(data[1:]))


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------

def field(name: str, tpe) -> tuple:
    return (name, tpe)


class _ContainerMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        fields = ns.get("fields")
        if fields is None:
            # inherit
            for b in bases:
                if hasattr(b, "fields"):
                    cls.fields = b.fields
                    break
        if getattr(cls, "fields", None):
            cls._field_names = [n for n, _ in cls.fields]
            cls._field_types = dict(cls.fields)
        return cls


class Container(metaclass=_ContainerMeta):
    """Base for SSZ containers; subclasses set ``fields = [(name, type), ...]``.

    The class doubles as its own descriptor: ``cls.encode(instance)``,
    ``cls.decode(bytes)``, ``cls.is_fixed()``...
    """

    fields: list = []

    def __init__(self, **kwargs):
        for n, t in self.fields:
            if n in kwargs:
                setattr(self, n, kwargs.pop(n))
            else:
                setattr(self, n, t.default())
        if kwargs:
            raise SSZError(f"{type(self).__name__}: unknown fields {sorted(kwargs)}")

    def __eq__(self, o):
        if type(o) is not type(self):
            return NotImplemented
        return all(getattr(self, n) == getattr(o, n) for n in self._field_names)

    def __hash__(self):
        return hash(type(self).encode(self))

    def __repr__(self):
        inner = ", ".join(f"{n}={getattr(self, n)!r}" for n in self._field_names[:4])
        more = "..." if len(self._field_names) > 4 else ""
        return f"{type(self).__name__}({inner}{more})"

    def copy(self):
        import copy as _copy

        return _copy.deepcopy(self)

    # -- descriptor protocol (classmethods) ------------------------------

    @classmethod
    def is_fixed(cls) -> bool:
        return all(t.is_fixed() for _, t in cls.fields)

    @classmethod
    def fixed_size(cls) -> int:
        return sum(t.fixed_size() for _, t in cls.fields)

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def encode(cls, v) -> bytes:
        fixed_parts = []
        var_parts = []
        for n, t in cls.fields:
            val = getattr(v, n)
            if t.is_fixed():
                fixed_parts.append(t.encode(val))
            else:
                fixed_parts.append(None)
                var_parts.append(t.encode(val))
        fixed_len = sum(
            len(p) if p is not None else BYTES_PER_LENGTH_OFFSET for p in fixed_parts
        )
        out = bytearray()
        offset = fixed_len
        vi = 0
        for p in fixed_parts:
            if p is not None:
                out += p
            else:
                out += offset.to_bytes(BYTES_PER_LENGTH_OFFSET, "little")
                offset += len(var_parts[vi])
                vi += 1
        for p in var_parts:
            out += p
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes):
        values = {}
        var_fields = []
        offsets = []
        pos = 0
        for n, t in cls.fields:
            if t.is_fixed():
                size = t.fixed_size()
                if pos + size > len(data):
                    raise SSZError(f"{cls.__name__}: truncated at field {n}")
                values[n] = t.decode(data[pos:pos + size])
                pos += size
            else:
                if pos + BYTES_PER_LENGTH_OFFSET > len(data):
                    raise SSZError(f"{cls.__name__}: truncated offset at {n}")
                offsets.append(
                    int.from_bytes(data[pos:pos + BYTES_PER_LENGTH_OFFSET], "little")
                )
                var_fields.append((n, t))
                pos += BYTES_PER_LENGTH_OFFSET
        if var_fields:
            if offsets[0] != pos:
                raise SSZError(f"{cls.__name__}: first offset mismatch")
            offsets.append(len(data))
            for (n, t), start, end in zip(var_fields, offsets, offsets[1:]):
                if end < start or start > len(data):
                    raise SSZError(f"{cls.__name__}: bad offsets for {n}")
                values[n] = t.decode(data[start:end])
        elif pos != len(data):
            raise SSZError(f"{cls.__name__}: {len(data) - pos} trailing bytes")
        return cls(**values)
