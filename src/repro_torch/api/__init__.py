"""The runtime/handle surface over recoverable structures, copied from
the reference package and trimmed to what the serving slice runs (see
``runtime.py``)."""

from .adapters import OpSpec, StructureAdapter
from .board import AnnounceBoard, Announcement
from .handle import (Bound, BoundCkpt, BoundCounter, BoundHeap, BoundLog,
                     BoundQueue, BoundStack, Handle)
from .runtime import CombiningRuntime, RecoverableObject

__all__ = [
    "AnnounceBoard", "Announcement",
    "Bound", "BoundCkpt", "BoundCounter", "BoundHeap", "BoundLog",
    "BoundQueue", "BoundStack",
    "CombiningRuntime", "Handle", "OpSpec",
    "RecoverableObject", "StructureAdapter",
]
