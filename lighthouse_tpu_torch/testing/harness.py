"""StateHarness: interop-keyed block/attestation production over the pure
state-transition function — the minimal analogue of the reference's
``BeaconChainHarness`` (``test_utils.rs:68-69``). Signs everything for
real, so it exercises the BLS backends end-to-end (any backend: cuda /
cpu / cpu-native / fake).

By default it signs and derives keys with the pure-Python oracle, as the
JAX package's harness does (the same bytes). At a mainnet registry that
takes hours, so a caller may pass the C library's signer and key
derivation in: ``StateHarness(..., signer=native_signer,
pubkey_fn=native_pubkey)``.
"""

from __future__ import annotations

import copy

from ..crypto import bls
from ..crypto.params import R
from ..ssz import hash_tree_root
from ..state_transition import signature_sets as sigsets
from ..state_transition.block import process_block
from ..state_transition.genesis import interop_genesis_state, interop_secret_key
from ..state_transition.helpers import (
    CommitteeCache,
    compute_epoch_at_slot,
    get_beacon_proposer_index,
    get_block_root_at_slot,
    get_committee_count_per_slot,
)
from ..state_transition.slot import partial_state_advance, per_slot_processing
from ..types import (
    ChainSpec,
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_RANDAO,
    DOMAIN_SYNC_COMMITTEE,
    compute_signing_root,
    get_domain,
    types_for,
)
from ..types.preset import Preset
from .. import ssz


class StateHarness:
    def __init__(
        self,
        preset: Preset,
        spec: ChainSpec,
        validator_count: int = 64,
        fork_name: str = "phase0",
        fake_sign: bool = False,
        signer=None,
        pubkey_fn=None,
    ):
        """``fake_sign=True`` stamps a constant valid G2 point instead of
        signing (pair with signature_strategy="none" — the reference's
        ``fake_crypto`` testing seam, ``crypto/bls/src/lib.rs:13-14``).
        ``signer(secret_keys, root) -> bytes`` gives the aggregate
        signature of ``secret_keys`` over one signing root, and
        ``pubkey_fn(secret_key) -> bytes`` a compressed public key; the
        defaults are the oracle's (``SecretKey.sign`` summed by
        ``AggregateSignature.add_assign``, ``SecretKey.public_key``)."""
        self.preset = preset
        self.spec = spec
        self.fork_name = fork_name
        self.t = types_for(preset)
        self.keys = [interop_secret_key(i) for i in range(validator_count)]
        self.signer = signer
        self.pubkey_fn = pubkey_fn
        self._pk_to_key = None
        self.state = interop_genesis_state(
            preset, spec, validator_count, fork_name=fork_name,
            pubkey_fn=pubkey_fn,
        )
        self.fake_sign = fake_sign
        if fake_sign:
            from ..crypto.cpu.curve import g2_generator

            self._fake_sig = bls.Signature(g2_generator()).serialize()
        else:
            self._fake_sig = None

    # -- signing ---------------------------------------------------------

    def sign_root(self, keys, root: bytes) -> bytes:
        """The aggregate signature of ``keys`` over ``root``, serialized."""
        if self.signer is not None:
            return self.signer(keys, root)
        agg = bls.AggregateSignature.infinity()
        for k in keys:
            agg.add_assign(k.sign(root))
        return agg.serialize()

    def pubkey_to_key(self) -> dict:
        """Compressed public key -> its secret key, derived once."""
        if self._pk_to_key is None:
            self._pk_to_key = {
                (self.pubkey_fn(k) if self.pubkey_fn else k.public_key().serialize()): k
                for k in self.keys
            }
        return self._pk_to_key

    def sign_block(self, block, proposer_index: int):
        if self.fake_sign:
            return self.t.signed_block[self.fork_name](
                message=block, signature=self._fake_sig
            )
        domain = get_domain(
            self.spec,
            self.state,
            DOMAIN_BEACON_PROPOSER,
            block.slot // self.preset.SLOTS_PER_EPOCH,
        )
        root = compute_signing_root(type(block), block, domain)
        signed = self.t.signed_block[self.fork_name](
            message=block, signature=self.sign_root([self.keys[proposer_index]], root)
        )
        return signed

    def randao_reveal(self, state, slot: int, proposer_index: int) -> bytes:
        if self.fake_sign:
            return self._fake_sig
        epoch = slot // self.preset.SLOTS_PER_EPOCH
        domain = get_domain(self.spec, state, DOMAIN_RANDAO, epoch)
        root = compute_signing_root(ssz.Uint64, epoch, domain)
        return self.sign_root([self.keys[proposer_index]], root)

    # -- attestations ----------------------------------------------------

    def _head_block_root(self, state) -> bytes:
        from ..state_transition.helpers import latest_block_header_root

        return latest_block_header_root(state)

    def attestations_for_slot(self, state, slot: int):
        """Fully-participating attestations for every committee at ``slot``
        (state must be at a slot where block_roots[slot] is known)."""
        t = self.t
        epoch = compute_epoch_at_slot(self.preset, slot)
        cache = CommitteeCache(self.preset, state, epoch)
        head_root = (
            get_block_root_at_slot(self.preset, state, slot)
            if slot < state.slot
            else self._head_block_root(state)
        )
        target_root = (
            get_block_root_at_slot(
                self.preset, state, epoch * self.preset.SLOTS_PER_EPOCH
            )
            if epoch * self.preset.SLOTS_PER_EPOCH < state.slot
            else head_root
        )
        source = (
            state.current_justified_checkpoint
            if epoch == compute_epoch_at_slot(self.preset, state.slot)
            else state.previous_justified_checkpoint
        )
        out = []
        for index in range(cache.committees_per_slot):
            committee = cache.committee(slot, index)
            data = t.AttestationData(
                slot=slot,
                index=index,
                beacon_block_root=head_root,
                source=source,
                target=t.Checkpoint(epoch=epoch, root=target_root),
            )
            if self.fake_sign:
                sig_bytes = self._fake_sig
            else:
                domain = get_domain(self.spec, state, DOMAIN_BEACON_ATTESTER, epoch)
                root = compute_signing_root(t.AttestationData, data, domain)
                sig_bytes = self.sign_root([self.keys[int(v)] for v in committee], root)
            out.append(
                t.Attestation(
                    aggregation_bits=[True] * len(committee),
                    data=data,
                    signature=sig_bytes,
                )
            )
        return out


    def sync_aggregate_for(self, state, block_slot: int):
        """Fully-participating sync aggregate signing the previous block
        root (altair+)."""
        t = self.t
        prev_slot = max(block_slot, 1) - 1
        root = (
            get_block_root_at_slot(self.preset, state, prev_slot)
            if prev_slot < state.slot
            else self._head_block_root(state)
        )
        domain = get_domain(
            self.spec, state, DOMAIN_SYNC_COMMITTEE,
            prev_slot // self.preset.SLOTS_PER_EPOCH,
        )
        if self.fake_sign:
            return t.SyncAggregate(
                sync_committee_bits=[True] * self.preset.SYNC_COMMITTEE_SIZE,
                sync_committee_signature=self._fake_sig,
            )
        signing_root = compute_signing_root(None, root, domain)
        pk_to_key = self.pubkey_to_key()
        keys = [pk_to_key[bytes(pk)] for pk in state.current_sync_committee.pubkeys]
        return t.SyncAggregate(
            sync_committee_bits=[True] * self.preset.SYNC_COMMITTEE_SIZE,
            sync_committee_signature=self.sign_root(keys, signing_root),
        )

    # -- block production / import --------------------------------------

    def produce_block(self, slot: int, attestations=(), full_sync: bool = False):
        """Advance a copy of the head state to ``slot`` and build a signed
        block on it (reference: ``produce_block_on_state``,
        ``beacon_chain.rs:3364``)."""
        state = copy.deepcopy(self.state)
        state = partial_state_advance(self.preset, self.spec, state, slot)
        proposer = get_beacon_proposer_index(self.preset, state)
        t = self.t
        body_kwargs = dict(
            randao_reveal=self.randao_reveal(state, slot, proposer),
            eth1_data=state.eth1_data,
            attestations=list(attestations),
        )
        if self.fork_name in ("altair", "bellatrix"):
            if full_sync:
                body_kwargs["sync_aggregate"] = self.sync_aggregate_for(state, slot)
            else:
                body_kwargs["sync_aggregate"] = t.SyncAggregate(
                    sync_committee_signature=bls.INFINITY_SIGNATURE
                )
        body = t.block_body[self.fork_name](**body_kwargs)
        block = t.block[self.fork_name](
            slot=slot,
            proposer_index=proposer,
            parent_root=hash_tree_root(state.latest_block_header),
            state_root=bytes(32),
            body=body,
        )
        # compute the post-state root with signatures skipped
        trial = copy.deepcopy(state)
        signed_unsigned = t.signed_block[self.fork_name](message=block)
        process_block(
            self.preset, self.spec, trial, signed_unsigned, self.fork_name,
            signature_strategy="none",
        )
        block.state_root = hash_tree_root(trial)
        return self.sign_block(block, proposer)

    def process_block(self, signed_block, strategy: str = "individual"):
        """per-slot advance + per-block processing onto the head state."""
        self.state = partial_state_advance(
            self.preset, self.spec, self.state, signed_block.message.slot
        )
        process_block(
            self.preset,
            self.spec,
            self.state,
            signed_block,
            self.fork_name,
            signature_strategy=strategy,
        )
        return self.state

    def advance_slots(self, n: int) -> None:
        for _ in range(n):
            self.state = per_slot_processing(self.preset, self.spec, self.state)

    def extend_chain(self, n_blocks: int, strategy: str = "bulk", attest: bool = True):
        """Produce and import ``n_blocks`` consecutive blocks, attesting to
        the previous slot when possible."""
        blocks = []
        for _ in range(n_blocks):
            slot = self.state.slot + 1
            atts = []
            if attest and slot >= 2:
                atts = self.attestations_for_slot(self.state, slot - 1)[
                    : self.preset.MAX_ATTESTATIONS
                ]
            sb = self.produce_block(slot, attestations=atts)
            self.process_block(sb, strategy=strategy)
            blocks.append(sb)
        return blocks


def native_signer(keys, root: bytes) -> bytes:
    """The C library's signer for ``StateHarness(signer=...)``. Every key
    signs the same root, so the aggregate is the signature under the sum
    of the secret keys: one C signature instead of one per key and a
    pure-Python sum of G2 points (the same bytes)."""
    from ..crypto.native import native_sign

    return native_sign(sum(k.k for k in keys) % R, bytes(root))


def native_pubkey(sk) -> bytes:
    """The C library's key derivation for ``pubkey_fn=``: the compressed
    public key of ``sk``."""
    from ..crypto.cpu.curve import G1Point
    from ..crypto.cpu.fields import Fq
    from ..crypto.native import native_sk_to_pk_xy

    x, y = native_sk_to_pk_xy(sk.k)
    return G1Point(Fq(x), Fq(y)).compress()
