"""Fork choice: proto-array LMD-GHOST + the spec wrapper (reference:
``consensus/proto_array`` + ``consensus/fork_choice``, SURVEY.md §2.3)."""

from .proto_array import ProtoArrayForkChoice, ProtoNode, ExecutionStatus
from .fork_choice import ForkChoice, ForkChoiceError, ForkChoiceStore

__all__ = [
    "ExecutionStatus",
    "ForkChoice",
    "ForkChoiceError",
    "ForkChoiceStore",
    "ProtoArrayForkChoice",
    "ProtoNode",
]
