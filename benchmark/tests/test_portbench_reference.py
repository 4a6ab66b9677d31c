"""The plain reference and the input maker agree with each other and with
the port's own host oracle, and a wrongly signed set does not verify."""

import hashlib
import os

import pytest

from benchmark import inputs, reference


@pytest.mark.parametrize("msg", [bytes(32), b"\x01" * 32,
                                 hashlib.sha256(b"message").digest()])
def test_hash_to_g2_matches_the_port_oracle(msg):
    from lighthouse_tpu_torch.crypto.cpu.hash_to_curve import hash_to_g2
    from lighthouse_tpu_torch.crypto.params import DST

    assert reference.compress(reference.hash_to_g2(msg)) == hash_to_g2(msg, DST).compress()


def test_signer_and_reference_agree():
    msg = os.urandom(32)
    members = [3, 17, 4096, 524287]
    a = (sum(members) + len(members)) % reference.R
    good, other = inputs.sign_message(msg, [a, a + 1])
    assert good == reference.expected_signature(members, msg)
    assert reference.set_verifies(good, members, msg)
    assert not reference.set_verifies(other, members, msg)
    assert not reference.set_verifies(good, members[:-1], msg)
    assert not reference.set_verifies(good, members, os.urandom(32))
    # many scalars over one message take the table path of the signer
    many = inputs.sign_message(msg, [a + k for k in range(6)])
    assert many[0] == good and many[1] == other
    assert reference.verdicts([(good, members, msg), (other, members, msg)]) == [True, False]


def test_registry_is_secrets_one_to_n():
    from lighthouse_tpu_torch.crypto.native import native_sk_to_pk_xy

    raw = inputs.registry_xy(70)
    for i in (0, 1, 2, 69):
        x, y = native_sk_to_pk_xy(i + 1)
        assert raw[96 * i:96 * i + 96] == x.to_bytes(48, "big") + y.to_bytes(48, "big")
