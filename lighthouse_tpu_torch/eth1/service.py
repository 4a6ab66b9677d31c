"""Eth1 service: polls an eth1 endpoint for deposit-contract logs and
blocks, maintains the deposit Merkle tree, serves eth1-data votes and
deposit proofs for block production (reference:
``beacon_node/eth1/src/service.rs`` + ``deposit_cache.rs``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from ..ssz import hash_tree_root
from ..ssz.sha256 import ZERO_HASHES, hash32_concat
from ..types.containers import types_for

DEPOSIT_TREE_DEPTH = 32


@dataclass
class DepositLog:
    index: int
    pubkey: bytes
    withdrawal_credentials: bytes
    amount: int
    signature: bytes
    block_number: int


@dataclass
class Eth1Block:
    number: int
    hash: bytes
    timestamp: int
    deposit_count: int
    deposit_root: bytes


class DepositTree:
    """Incremental Merkle tree of deposit-data roots with cached levels
    (the deposit contract's tree; proofs for spec ``Deposit.proof``).

    ``levels[d][j]`` is the root of the depth-d subtree over leaves
    [j*2^d, (j+1)*2^d), with missing right children treated as zero
    subtrees. A push updates one rightmost node per level (O(depth));
    a proof reads one sibling per level (O(depth)) — the reference's
    incremental deposit tree has the same costs.

    ``proof(index, count)`` proves against the tree truncated to the
    first ``count`` leaves — deposits that arrived after an eth1-data
    vote must not perturb proofs against that vote's root.
    """

    def __init__(self):
        self.leaves: list[bytes] = []
        self.levels: list[list[bytes]] = [[] for _ in range(DEPOSIT_TREE_DEPTH + 1)]

    def push(self, leaf: bytes) -> None:
        self.leaves.append(leaf)
        self.levels[0].append(leaf)
        idx = len(self.leaves) - 1
        for d in range(1, DEPOSIT_TREE_DEPTH + 1):
            idx //= 2
            below = self.levels[d - 1]
            left = below[2 * idx]
            right = (
                below[2 * idx + 1]
                if 2 * idx + 1 < len(below)
                else ZERO_HASHES[d - 1]
            )
            node = hash32_concat(left, right)
            if idx < len(self.levels[d]):
                self.levels[d][idx] = node
            else:
                self.levels[d].append(node)

    def root(self, count: int | None = None) -> bytes:
        n = len(self.leaves) if count is None else count
        return hash32_concat(
            self._node(DEPOSIT_TREE_DEPTH, 0, n), n.to_bytes(32, "little")
        )

    def _node(self, depth: int, idx: int, count: int) -> bytes:
        """Root of the depth-``depth`` subtree at position ``idx`` with
        only the first ``count`` leaves of the whole tree present."""
        lo = idx << depth
        if lo >= count:
            return ZERO_HASHES[depth]
        if (lo + (1 << depth)) <= count:
            return self.levels[depth][idx]  # fully inside: cached
        if depth == 0:
            return self.levels[0][idx]
        return hash32_concat(
            self._node(depth - 1, 2 * idx, count),
            self._node(depth - 1, 2 * idx + 1, count),
        )

    def proof(self, index: int, count: int | None = None) -> list[bytes]:
        """Branch for leaf ``index`` against root(count)."""
        n = len(self.leaves) if count is None else count
        assert index < n <= len(self.leaves)
        path = []
        idx = index
        for d in range(DEPOSIT_TREE_DEPTH):
            sib = idx ^ 1
            path.append(self._node(d, sib, n))
            idx //= 2
        path.append(n.to_bytes(32, "little"))
        return path


class MockEth1Endpoint:
    """In-process stand-in for an eth1 JSON-RPC node (reference
    ``testing/eth1_test_rig``): hosts deposit logs + canonical blocks."""

    def __init__(self):
        self.logs: list[DepositLog] = []
        self.blocks: list[Eth1Block] = []
        self._tree = DepositTree()
        self._preset_types = None

    def add_deposit(self, pubkey: bytes, withdrawal_credentials: bytes,
                    amount: int, signature: bytes, block_number: int) -> None:
        log = DepositLog(
            index=len(self.logs),
            pubkey=pubkey,
            withdrawal_credentials=withdrawal_credentials,
            amount=amount,
            signature=signature,
            block_number=block_number,
        )
        self.logs.append(log)

    def seal_block(self, number: int, timestamp: int) -> Eth1Block:
        from ..types.preset import MAINNET

        t = types_for(MAINNET)
        tree = DepositTree()
        count = 0
        for log in self.logs:
            if log.block_number <= number:
                dd = t.DepositData(
                    pubkey=log.pubkey,
                    withdrawal_credentials=log.withdrawal_credentials,
                    amount=log.amount,
                    signature=log.signature,
                )
                tree.push(hash_tree_root(dd))
                count += 1
        blk = Eth1Block(
            number=number,
            hash=hash32_concat(number.to_bytes(32, "little"), b"eth1".ljust(32, b"\0")),
            timestamp=timestamp,
            deposit_count=count,
            deposit_root=tree.root(),
        )
        self.blocks.append(blk)
        return blk

    def logs_in_range(self, lo: int, hi: int) -> list[DepositLog]:
        return [l for l in self.logs if lo <= l.block_number <= hi]

    def blocks_by_number(self) -> list[Eth1Block]:
        return sorted(self.blocks, key=lambda b: b.number)


class Eth1Service:
    """Caches deposits + blocks from an endpoint; computes the eth1-data
    vote and deposit inclusions for block production."""

    def __init__(self, endpoint: MockEth1Endpoint, preset, spec):
        self.endpoint = endpoint
        self.preset = preset
        self.spec = spec
        self.t = types_for(preset)
        self._lock = threading.Lock()
        self.deposit_tree = DepositTree()
        self.deposits: list = []  # DepositData in index order
        self.blocks: list[Eth1Block] = []

    def update(self) -> None:
        """One poll round (reference ``Service::update``)."""
        with self._lock:
            known = len(self.deposits)
            for log in self.endpoint.logs:
                if log.index < known:
                    continue
                dd = self.t.DepositData(
                    pubkey=log.pubkey,
                    withdrawal_credentials=log.withdrawal_credentials,
                    amount=log.amount,
                    signature=log.signature,
                )
                self.deposits.append(dd)
                self.deposit_tree.push(hash_tree_root(dd))
            self.blocks = self.endpoint.blocks_by_number()

    def eth1_data_vote(self, state):
        """Follow-distance eth1 data (simplified voting: latest block at
        distance; the reference tallies in-period votes too)."""
        with self._lock:
            if not self.blocks:
                return state.eth1_data
            blk = self.blocks[-1]
            return self.t.Eth1Data(
                deposit_root=blk.deposit_root,
                deposit_count=blk.deposit_count,
                block_hash=blk.hash,
            )

    def deposits_for_block(self, state, max_count: int) -> list:
        """Deposits the state still owes (spec: must include min(max,
        eth1_data.count - eth1_deposit_index) in order, with proofs)."""
        with self._lock:
            voted_count = state.eth1_data.deposit_count
            start = state.eth1_deposit_index
            end = min(voted_count, start + max_count)
            out = []
            for i in range(start, min(end, len(self.deposits))):
                out.append(
                    self.t.Deposit(
                        # proofs against the VOTED deposit count: later
                        # deposits must not invalidate them
                        proof=self.deposit_tree.proof(i, voted_count),
                        data=self.deposits[i],
                    )
                )
            return out
