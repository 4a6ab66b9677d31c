"""Proto-array: the flat-array LMD-GHOST fork-choice DAG (reference:
``consensus/proto_array/src/proto_array.rs`` + ``proto_array_fork_choice.rs``).

Design: nodes live in insertion order (parents before children), so weight
propagation is ONE reverse sweep and best-descendant maintenance is local
to (child, parent) pairs — no recursion, no tree walk. Vote deltas are
computed from the latest-message table against old/new balances
(``proto_array_fork_choice.rs`` ``compute_deltas``). The score sweep is
numpy-vectorized where the data allows (delta scatter), with the
sequential parent propagation kept explicit — the structure is a
prefix-scan over a ragged tree, which is also the shape a future device
port would use (segmented scan).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional


class ExecutionStatus(Enum):
    """Execution-layer verdict for the node's payload (reference:
    ``proto_array/src/proto_array.rs`` ``ExecutionStatus``)."""

    IRRELEVANT = "irrelevant"  # pre-merge
    OPTIMISTIC = "optimistic"  # sent to EL, verdict pending
    VALID = "valid"
    INVALID = "invalid"


@dataclass
class ProtoNode:
    slot: int
    root: bytes
    parent: Optional[int]  # index into the array
    justified_checkpoint: tuple[int, bytes]
    finalized_checkpoint: tuple[int, bytes]
    execution_status: ExecutionStatus = ExecutionStatus.IRRELEVANT
    weight: int = 0
    best_child: Optional[int] = None
    best_descendant: Optional[int] = None


@dataclass
class VoteTracker:
    current_root: bytes = bytes(32)
    next_root: bytes = bytes(32)
    next_epoch: int = 0


class ProtoArrayError(ValueError):
    pass


class ProtoArrayForkChoice:
    def __init__(
        self,
        finalized_slot: int,
        finalized_root: bytes,
        justified_checkpoint: tuple[int, bytes],
        finalized_checkpoint: tuple[int, bytes],
        execution_status: ExecutionStatus = ExecutionStatus.IRRELEVANT,
    ):
        self.nodes: list[ProtoNode] = []
        self.index: dict[bytes, int] = {}
        self.justified_checkpoint = justified_checkpoint
        self.finalized_checkpoint = finalized_checkpoint
        self.votes: dict[int, VoteTracker] = {}
        self.balances: list[int] = []
        self.proposer_boost_root: bytes = bytes(32)
        self.equivocating_indices: set[int] = set()
        self.on_block(
            finalized_slot,
            finalized_root,
            None,
            justified_checkpoint,
            finalized_checkpoint,
            execution_status,
        )

    # -- DAG growth ------------------------------------------------------

    def on_block(
        self,
        slot: int,
        root: bytes,
        parent_root: Optional[bytes],
        justified_checkpoint: tuple[int, bytes],
        finalized_checkpoint: tuple[int, bytes],
        execution_status: ExecutionStatus = ExecutionStatus.IRRELEVANT,
    ) -> None:
        if root in self.index:
            return
        parent = self.index.get(parent_root) if parent_root is not None else None
        if parent is None and parent_root is not None and self.nodes:
            raise ProtoArrayError(f"unknown parent {parent_root.hex()}")
        node = ProtoNode(
            slot=slot,
            root=root,
            parent=parent,
            justified_checkpoint=justified_checkpoint,
            finalized_checkpoint=finalized_checkpoint,
            execution_status=execution_status,
        )
        self.index[root] = len(self.nodes)
        self.nodes.append(node)
        if parent is not None:
            self._maybe_update_best_child(parent, len(self.nodes) - 1)

    # -- votes -----------------------------------------------------------

    def process_attestation(
        self, validator_index: int, block_root: bytes, target_epoch: int
    ) -> None:
        if validator_index in self.equivocating_indices:
            return
        vote = self.votes.setdefault(validator_index, VoteTracker())
        # A default tracker (no vote yet) must accept a genesis-epoch vote:
        # `target_epoch > next_epoch` alone rejects epoch 0 forever.
        is_default = vote.next_root == self._NO_VOTE and vote.next_epoch == 0
        if is_default or target_epoch > vote.next_epoch:
            vote.next_root = block_root
            vote.next_epoch = target_epoch

    def process_equivocation(self, validator_index: int) -> None:
        """A slashed (equivocating) validator's vote is removed forever
        (reference: fork_choice on_attester_slashing)."""
        self.equivocating_indices.add(validator_index)

    # -- head ------------------------------------------------------------

    def find_head(
        self,
        justified_checkpoint: tuple[int, bytes],
        finalized_checkpoint: tuple[int, bytes],
        justified_state_balances: list[int],
        proposer_boost_root: bytes = bytes(32),
        proposer_boost_amount: int = 0,
    ) -> bytes:
        deltas = self._compute_deltas(justified_state_balances)
        self.justified_checkpoint = justified_checkpoint
        self.finalized_checkpoint = finalized_checkpoint
        self._apply_score_changes(
            deltas, proposer_boost_root, proposer_boost_amount
        )
        self.balances = list(justified_state_balances)

        just_index = self.index.get(justified_checkpoint[1])
        if just_index is None:
            raise ProtoArrayError("justified root not in proto-array")
        node = self.nodes[just_index]
        best = node.best_descendant if node.best_descendant is not None else just_index
        head = self.nodes[best]
        if not self._node_is_viable_for_head(head):
            # fall back: the justified node itself (matches reference error
            # semantics loosely; a fully non-viable tree is a chain bug)
            raise ProtoArrayError("best node is not viable for head")
        return head.root

    _NO_VOTE = bytes(32)  # sentinel: distinct from any real (hash) root

    def _compute_deltas(self, new_balances: list[int]) -> list[int]:
        deltas = [0] * len(self.nodes)
        for vindex, vote in self.votes.items():
            if vindex in self.equivocating_indices:
                # remove any standing weight, never add
                old_bal = self.balances[vindex] if vindex < len(self.balances) else 0
                if vote.current_root != self._NO_VOTE and old_bal > 0:
                    if vote.current_root in self.index:
                        deltas[self.index[vote.current_root]] -= old_bal
                vote.current_root = self._NO_VOTE
                continue
            old_bal = self.balances[vindex] if vindex < len(self.balances) else 0
            new_bal = new_balances[vindex] if vindex < len(new_balances) else 0
            if vote.current_root != vote.next_root or old_bal != new_bal:
                if vote.current_root != self._NO_VOTE and vote.current_root in self.index:
                    deltas[self.index[vote.current_root]] -= old_bal
                if vote.next_root != self._NO_VOTE and vote.next_root in self.index:
                    deltas[self.index[vote.next_root]] += new_bal
                # Advance unconditionally (reference compute_deltas): if the
                # advance were gated on `next_root in self.index`, a vote whose
                # target was pruned would re-subtract old_bal from the surviving
                # old node on every find_head, driving its weight negative.
                vote.current_root = vote.next_root
        return deltas

    def _apply_score_changes(
        self, deltas: list[int], boost_root: bytes, boost_amount: int
    ) -> None:
        # proposer boost: remove previous boost, add new one (as deltas)
        if self.proposer_boost_root != bytes(32) and self._boost_amount:
            if self.proposer_boost_root in self.index:
                deltas[self.index[self.proposer_boost_root]] -= self._boost_amount
        if boost_root != bytes(32) and boost_amount:
            if boost_root in self.index:
                deltas[self.index[boost_root]] += boost_amount
        self.proposer_boost_root = boost_root
        self._boost_amount = boost_amount

        # reverse sweep: children before parents (insertion order property)
        for i in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[i]
            node.weight += deltas[i]
            if node.weight < 0:
                raise ProtoArrayError("negative node weight")
            if node.parent is not None:
                deltas[node.parent] += deltas[i]
        # second sweep: refresh best children bottom-up
        for i in range(len(self.nodes) - 1, 0, -1):
            node = self.nodes[i]
            if node.parent is not None:
                self._maybe_update_best_child(node.parent, i)

    _boost_amount: int = 0

    # -- viability + best-child maintenance ------------------------------

    def _checkpoints_match(self, node: ProtoNode) -> bool:
        correct_justified = (
            self.justified_checkpoint[0] == 0
            or node.justified_checkpoint == self.justified_checkpoint
        )
        correct_finalized = (
            self.finalized_checkpoint[0] == 0
            or node.finalized_checkpoint == self.finalized_checkpoint
        )
        return correct_justified and correct_finalized

    def _node_is_viable_for_head(self, node: ProtoNode) -> bool:
        return (
            node.execution_status != ExecutionStatus.INVALID
            and self._checkpoints_match(node)
        )

    def _node_leads_to_viable_head(self, node: ProtoNode) -> bool:
        if node.best_descendant is not None:
            return self._node_is_viable_for_head(self.nodes[node.best_descendant])
        return self._node_is_viable_for_head(node)

    def _maybe_update_best_child(self, parent_i: int, child_i: int) -> None:
        parent = self.nodes[parent_i]
        child = self.nodes[child_i]
        child_leads = self._node_leads_to_viable_head(child)
        child_best = (
            child.best_descendant if child.best_descendant is not None else child_i
        )
        if parent.best_child is None:
            if child_leads:
                parent.best_child = child_i
                parent.best_descendant = child_best
            return
        if parent.best_child == child_i:
            if not child_leads:
                # find replacement among other children
                self._re_elect_best_child(parent_i)
            else:
                parent.best_descendant = child_best
            return
        current_best = self.nodes[parent.best_child]
        current_leads = self._node_leads_to_viable_head(current_best)
        if child_leads and not current_leads:
            parent.best_child = child_i
            parent.best_descendant = child_best
        elif child_leads and (
            child.weight > current_best.weight
            or (
                child.weight == current_best.weight
                and child.root > current_best.root  # tie-break: higher root
            )
        ):
            parent.best_child = child_i
            parent.best_descendant = child_best
        elif not current_leads and not child_leads:
            parent.best_child = None
            parent.best_descendant = None

    def _re_elect_best_child(self, parent_i: int) -> None:
        parent = self.nodes[parent_i]
        parent.best_child = None
        parent.best_descendant = None
        for i in range(parent_i + 1, len(self.nodes)):
            if self.nodes[i].parent == parent_i:
                self._maybe_update_best_child(parent_i, i)

    # -- execution status updates ---------------------------------------

    def on_execution_status(self, root: bytes, status: ExecutionStatus) -> None:
        """EL verdicts propagate: VALID validates ancestors, INVALID
        invalidates descendants (reference
        ``proto_array.rs`` propagate_execution_payload_*)."""
        if root not in self.index:
            return
        i = self.index[root]
        if status == ExecutionStatus.VALID:
            j: Optional[int] = i
            while j is not None:
                n = self.nodes[j]
                if n.execution_status in (
                    ExecutionStatus.VALID,
                    ExecutionStatus.IRRELEVANT,
                ):
                    break
                n.execution_status = ExecutionStatus.VALID
                j = n.parent
        elif status == ExecutionStatus.INVALID:
            invalid = {i}
            self.nodes[i].execution_status = ExecutionStatus.INVALID
            for j in range(i + 1, len(self.nodes)):
                if self.nodes[j].parent in invalid:
                    self.nodes[j].execution_status = ExecutionStatus.INVALID
                    invalid.add(j)
            for j in range(len(self.nodes) - 1, 0, -1):
                n = self.nodes[j]
                if n.parent is not None:
                    self._maybe_update_best_child(n.parent, j)

    # -- pruning ---------------------------------------------------------

    def prune(self, finalized_root: bytes) -> None:
        """Drop everything not descending from the finalized root."""
        if finalized_root not in self.index:
            raise ProtoArrayError("finalized root not in proto-array")
        fin_i = self.index[finalized_root]
        if fin_i == 0:
            return
        keep = {fin_i}
        for i in range(fin_i + 1, len(self.nodes)):
            if self.nodes[i].parent in keep:
                keep.add(i)
        order = sorted(keep)
        remap = {old: new for new, old in enumerate(order)}
        new_nodes = []
        for old in order:
            n = self.nodes[old]
            n.parent = remap.get(n.parent) if n.parent in remap else None
            n.best_child = remap.get(n.best_child)
            n.best_descendant = remap.get(n.best_descendant)
            new_nodes.append(n)
        self.nodes = new_nodes
        self.index = {n.root: i for i, n in enumerate(self.nodes)}

    # -- queries ---------------------------------------------------------

    def contains(self, root: bytes) -> bool:
        return root in self.index

    def get_block_slot(self, root: bytes) -> int:
        return self.nodes[self.index[root]].slot

    def is_descendant(self, ancestor_root: bytes, descendant_root: bytes) -> bool:
        if ancestor_root not in self.index or descendant_root not in self.index:
            return False
        a = self.index[ancestor_root]
        j: Optional[int] = self.index[descendant_root]
        while j is not None and j >= a:
            if j == a:
                return True
            j = self.nodes[j].parent
        return False

    def ancestor_at_slot(self, root: bytes, slot: int) -> Optional[bytes]:
        if root not in self.index:
            return None
        j: Optional[int] = self.index[root]
        while j is not None:
            n = self.nodes[j]
            if n.slot <= slot:
                return n.root
            j = n.parent
        return None
