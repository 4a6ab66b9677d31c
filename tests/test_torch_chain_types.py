"""SSZ and the consensus types of the port against the JAX package's.

Nothing crosses between the packages but bytes: a value is encoded by one
package and decoded by the other. Exact equality throughout: the same
bytes back, the same ``hash_tree_root``.

* the JAX package's interop genesis states (minimal preset, 64
  validators, ``phase0`` and ``altair``) and a few of its blocks decode in
  the port and encode to the same bytes, with the same roots, and the
  port's own genesis (keys from the C library) is byte-equal to them;
* seeded basic lists, bitlists, byte vectors and containers have equal
  roots and encodings in both packages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lighthouse_tpu import ssz as jssz
from lighthouse_tpu.crypto import backend as jbackend
from lighthouse_tpu.state_transition.genesis import interop_genesis_state as jgenesis
from lighthouse_tpu.testing.harness import StateHarness as JHarness
from lighthouse_tpu.types import types_for as jtypes_for
from lighthouse_tpu.types.chain_spec import minimal_spec as jminimal_spec
from lighthouse_tpu.types.preset import MINIMAL as JMINIMAL
from lighthouse_tpu_torch import ssz as tssz
from lighthouse_tpu_torch.state_transition.genesis import interop_genesis_state as tgenesis
from lighthouse_tpu_torch.testing.harness import native_pubkey
from lighthouse_tpu_torch.types import types_for as ttypes_for
from lighthouse_tpu_torch.types.chain_spec import minimal_spec as tminimal_spec
from lighthouse_tpu_torch.types.preset import MINIMAL as TMINIMAL

FORKS = ("phase0", "altair")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _spec(mod, fork):
    return mod(altair_fork_epoch=0 if fork == "altair" else None)


@pytest.fixture(scope="module")
def jax_altair():
    """The JAX package's altair harness of 64 interop validators (its
    genesis costs about 13 s: the sync committee's keys are decompressed
    in pure Python) and four fake-signed blocks on it."""
    jprev = (jbackend._active, jbackend._active_name)
    jbackend.set_backend("fake")
    try:
        h = JHarness(JMINIMAL, jminimal_spec(altair_fork_epoch=0), 64,
                     fork_name="altair", fake_sign=True)
        genesis = type(h.state).encode(h.state)
        blocks = h.extend_chain(4, strategy="none")
    finally:
        jbackend._active, jbackend._active_name = jprev
    return genesis, blocks


@pytest.fixture(scope="module")
def jax_genesis(jax_altair):
    """The JAX package's interop genesis of each fork, as bytes."""
    st = jgenesis(JMINIMAL, _spec(jminimal_spec, "phase0"), 64, fork_name="phase0")
    return {"phase0": type(st).encode(st), "altair": jax_altair[0]}


@pytest.mark.parametrize("fork", FORKS)
def test_jax_genesis_round_trips_through_the_port(jax_genesis, fork):
    data = jax_genesis[fork]
    jt, tt = jtypes_for(JMINIMAL), ttypes_for(TMINIMAL)
    port = tt.state[fork].decode(data)
    assert tt.state[fork].encode(port) == data
    assert tssz.hash_tree_root(port) == jssz.hash_tree_root(jt.state[fork].decode(data))
    assert len(port.validators) == 64


@pytest.mark.parametrize("fork", FORKS)
def test_port_genesis_is_byte_equal_to_jax(jax_genesis, fork):
    # the C library's keys: the oracle's bytes (test_torch_host_oracle.py
    # holds them equal on these keys) at a fraction of its 0.2 s a key
    st = tgenesis(TMINIMAL, _spec(tminimal_spec, fork), 64, fork_name=fork,
                  pubkey_fn=native_pubkey)
    assert type(st).encode(st) == jax_genesis[fork]


def test_jax_blocks_round_trip_through_the_port(jax_altair):
    blocks = jax_altair[1]
    tt = ttypes_for(TMINIMAL)
    for sb in blocks:
        data = type(sb).encode(sb)
        port = tt.signed_block["altair"].decode(data)
        assert tt.signed_block["altair"].encode(port) == data
        assert tssz.hash_tree_root(port.message) == jssz.hash_tree_root(sb.message)
        assert len(port.message.body.attestations) == len(sb.message.body.attestations)


def _seeded_values(rng):
    """(name, JAX type, port type, value) over a spread of SSZ shapes."""
    jt, tt = jtypes_for(JMINIMAL), ttypes_for(TMINIMAL)
    u64 = [int(x) for x in rng.integers(0, 2 ** 63, size=37)]
    bits = [bool(b) for b in rng.integers(0, 2, size=203)]
    roots = [bytes(rng.integers(0, 256, size=32, dtype=np.uint8)) for _ in range(9)]
    out = [
        ("list_u64", jssz.List(jssz.Uint64, 1024), tssz.List(tssz.Uint64, 1024), u64),
        ("bitlist", jssz.Bitlist(2048), tssz.Bitlist(2048), bits),
        ("bitvector", jssz.Bitvector(203), tssz.Bitvector(203), bits),
        ("vector_root", jssz.Vector(jssz.Bytes32, 9), tssz.Vector(tssz.Bytes32, 9), roots),
        ("list_root", jssz.List(jssz.Bytes32, 64), tssz.List(tssz.Bytes32, 64), roots[:5]),
        ("empty_list", jssz.List(jssz.Uint64, 16), tssz.List(tssz.Uint64, 16), []),
    ]

    def b(n):
        return bytes(rng.integers(0, 256, size=n, dtype=np.uint8))

    def u():
        return int(rng.integers(0, 2 ** 63))

    cp = [jt.Checkpoint(epoch=u(), root=b(32)) for _ in range(2)]
    vals = {
        "Checkpoint": cp[0],
        "Validator": jt.Validator(
            pubkey=b(48), withdrawal_credentials=b(32), effective_balance=u(),
            slashed=bool(rng.integers(0, 2)), activation_eligibility_epoch=u(),
            activation_epoch=u(), exit_epoch=u(), withdrawable_epoch=u()),
        "AttestationData": jt.AttestationData(
            slot=u(), index=u(), beacon_block_root=b(32), source=cp[0], target=cp[1]),
    }
    for name, val in vals.items():
        out.append((name, getattr(jt, name), getattr(tt, name), val))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_values_have_equal_roots_and_bytes(seed):
    for name, jtype, ttype, val in _seeded_values(np.random.default_rng(seed)):
        data = jtype.encode(val)
        port = ttype.decode(data)
        assert ttype.encode(port) == data, name
        assert tssz.hash_tree_root(ttype, port) == jssz.hash_tree_root(jtype, val), name
