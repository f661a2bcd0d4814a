"""KV-cache slot allocator — the paper's recycling-stack memory manager.

Serving keeps a fixed pool of per-sequence KV slots (TPU memory is
pre-allocated; slots are indices into the batched cache arrays).  Freed
slots go onto a LIFO *recycling stack* — the PBStack GC scheme — so slot
reuse is as contiguous as the original reservation order (persistence
principle P3 transplanted to HBM locality: recently-touched cache lines
get reused first).
"""

from __future__ import annotations

import threading
from typing import List, Optional


class SlotAllocator:
    def __init__(self, n_slots: int) -> None:
        self.n_slots = n_slots
        self._bump = 0
        self._recycled: List[int] = []        # the recycling stack
        self._lock = threading.Lock()
        self.stats = {"alloc": 0, "free": 0, "recycled_hits": 0}

    def alloc(self) -> Optional[int]:
        with self._lock:
            self.stats["alloc"] += 1
            if self._recycled:
                self.stats["recycled_hits"] += 1
                return self._recycled.pop()
            if self._bump < self.n_slots:
                s = self._bump
                self._bump += 1
                return s
            self.stats["alloc"] -= 1
            return None                       # pool exhausted

    def free(self, slot: int) -> None:
        with self._lock:
            self.stats["free"] += 1
            self._recycled.append(slot)

    def available(self) -> int:
        with self._lock:
            return (self.n_slots - self._bump) + len(self._recycled)
