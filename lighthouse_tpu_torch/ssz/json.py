"""Generic container <-> JSON in the Beacon-API wire shape (reference:
``consensus/serde_utils`` — quoted ints, 0x-hex bytes — as used by every
``/eth/v1`` route and by the spec test ``value.yaml`` files)."""

from __future__ import annotations

from .core import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    List,
    SSZError,
    Union,
    Vector,
    _Boolean,
    _ContainerMeta,
    _Uint,
    _pack_bits,
)


def to_json(tpe, value):
    if isinstance(tpe, _Uint):
        return str(value)
    if isinstance(tpe, _Boolean):
        return bool(value)
    if isinstance(tpe, (ByteVector, ByteList)):
        return "0x" + bytes(value).hex()
    if isinstance(tpe, (Bitvector, Bitlist)):
        extra = len(value) if isinstance(tpe, Bitlist) else None
        return "0x" + _pack_bits(list(value), extra_bit_at=extra).hex()
    if isinstance(tpe, (Vector, List)):
        return [to_json(tpe.elem, v) for v in value]
    if isinstance(tpe, Union):
        sel, val = value
        opt = tpe.options[sel]
        return {
            "selector": str(sel),
            "value": None if opt is None else to_json(opt, val),
        }
    if isinstance(tpe, _ContainerMeta):
        return {n: to_json(t, getattr(value, n)) for n, t in tpe.fields}
    raise SSZError(f"to_json: unsupported type {tpe!r}")


def _unpack_bits(data: bytes, length: int | None) -> list[bool]:
    bits = []
    for byte in data:
        for i in range(8):
            bits.append(bool((byte >> i) & 1))
    if length is None:
        return bits
    # Bitlist: strip up to the delimiter bit
    while bits and not bits[-1]:
        bits.pop()
    if not bits:
        raise SSZError("bitlist missing delimiter")
    bits.pop()  # the delimiter itself
    return bits


def from_json(tpe, obj):
    if isinstance(tpe, _Uint):
        return int(obj)
    if isinstance(tpe, _Boolean):
        return bool(obj)
    if isinstance(tpe, (ByteVector, ByteList)):
        return bytes.fromhex(obj[2:] if obj.startswith("0x") else obj)
    if isinstance(tpe, Bitvector):
        data = bytes.fromhex(obj[2:])
        return _unpack_bits(data, None)[: tpe.length]
    if isinstance(tpe, Bitlist):
        data = bytes.fromhex(obj[2:])
        return _unpack_bits(data, -1)
    if isinstance(tpe, (Vector, List)):
        return [from_json(tpe.elem, v) for v in obj]
    if isinstance(tpe, Union):
        sel = int(obj["selector"])
        opt = tpe.options[sel]
        return (sel, None if opt is None else from_json(opt, obj["value"]))
    if isinstance(tpe, _ContainerMeta):
        return tpe(**{n: from_json(t, obj[n]) for n, t in tpe.fields})
    raise SSZError(f"from_json: unsupported type {tpe!r}")
