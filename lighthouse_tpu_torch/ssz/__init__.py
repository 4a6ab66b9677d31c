"""SimpleSerialize (SSZ) + Merkleization.

Re-design of the reference's SSZ stack (``consensus/ssz``,
``consensus/ssz_types``, ``consensus/tree_hash`` — Rust trait/derive
macros) as a declarative schema system: every wire type is a *descriptor
object* (``Uint64``, ``Vector(t, n)``, ``List(t, n)``, ``Container``
subclasses, ...) that knows how to encode, decode, and hash-tree-root
values.

The TPU-first angle: SSZ fixed-length types are the one place the
reference is already statically shaped (``FixedVector``/``VariableList``
with typenum bounds — ``consensus/ssz_types/src/lib.rs``); descriptors
here expose ``np.ndarray``-backed columnar views so state fields
(balances, validators, ...) can move to device without re-marshalling
(see ``state/``). Hashing is the batched SHA-256 in ``.sha256`` (numpy
lane-parallel, the host analogue of ``crypto/eth2_hashing``'s SHA-NI
dispatch).
"""

from .core import (
    Bitlist,
    Bitvector,
    Boolean,
    ByteList,
    ByteVector,
    Container,
    List,
    SSZError,
    Uint8,
    Uint16,
    Uint32,
    Uint64,
    Uint128,
    Uint256,
    Union,
    Vector,
    field,
)
from .hash import hash_tree_root
from .core import Bytes4, Bytes20, Bytes32, Bytes48, Bytes96

__all__ = [
    "Bitlist",
    "Bitvector",
    "Boolean",
    "ByteList",
    "ByteVector",
    "Bytes4",
    "Bytes20",
    "Bytes32",
    "Bytes48",
    "Bytes96",
    "Container",
    "List",
    "SSZError",
    "Uint8",
    "Uint16",
    "Uint32",
    "Uint64",
    "Uint128",
    "Uint256",
    "Union",
    "Vector",
    "field",
    "hash_tree_root",
]
