"""Priority scheduler — PBHeap applied to request admission.

Requests carry a deadline/priority; the combiner admits the most urgent
first when the batch or KV pool is contended.  The heap is the paper's
PBHeap shape: a bounded sequential min-heap mutated only by the combiner
(so no internal locking is needed beyond the combiner's own mutual
exclusion), and its state can ride inside the engine's persisted
StateRec if admission order must survive crashes.

``PriorityAdmission`` is the fleet wiring (DESIGN.md §9): each fleet
worker pulls a small window of requests off its shard's ingress queue
per tick, offers them here, and serves them earliest-deadline-first —
the KV-cache serving engine's admission policy applied at the
open-loop harness's dequeue point.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Any, Iterator, List, Optional, Tuple


class RequestHeap:
    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = capacity
        self._heap: List[Tuple[float, int, Any]] = []
        self._tie = itertools.count()

    def insert(self, priority: float, item: Any) -> bool:
        if len(self._heap) >= self.capacity:
            return False
        heapq.heappush(self._heap, (priority, next(self._tie), item))
        return True

    def delete_min(self) -> Optional[Any]:
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[2]

    def get_min(self) -> Optional[Any]:
        return self._heap[0][2] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)


class PriorityAdmission:
    """Deadline-priority admission window over a shard ingress queue.

    Fleet requests are ``(client, seq, t_intended, priority)`` tuples
    whose priority is an absolute deadline (intended arrival + latency
    budget, seconds from the window epoch).  ``offer`` stages a
    dequeued request; ``admit`` yields everything staged, most urgent
    (smallest deadline) first — so when a worker pulls several pending
    requests out of a backed-up ingress, interactive-class requests
    overtake batch-class ones at the serve point."""

    def __init__(self, window: int = 4, capacity: int = 4096) -> None:
        self.window = window
        self._heap = RequestHeap(capacity)

    def offer(self, request: Tuple) -> bool:
        return self._heap.insert(float(request[3]), request)

    def admit(self) -> Iterator[Tuple]:
        while True:
            r = self._heap.delete_min()
            if r is None:
                return
            yield r

    def __len__(self) -> int:
        return len(self._heap)
