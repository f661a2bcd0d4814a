"""AnnounceBoard — the paper's ``Request[0..n-1]`` announcement array as
a reusable component.

Every combining-style component in this repo used to re-implement the
same plumbing: a per-slot announcement record carrying (payload, seq,
activate, valid), a done event the announcer waits on, and parity
bookkeeping against some persisted deactivate array.  The board owns
exactly that volatile state and nothing else — *where* the deactivate
bits and responses persist stays with the component (a StateRec in NVMM
for the protocols, a slot file for the checkpointer), which is what
makes the board reusable by ``PBCombCheckpointer`` and
``CombiningEngine`` alike.

A crash wipes the board (it is volatile by design, persistence principle
P1): ``reset()`` models that, and ``CombiningRuntime.recover`` calls it
for every board it handed out.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple


class Announcement:
    """One announcement slot: the paper's RequestRec plus a done event
    the announcing thread can block on."""

    def __init__(self, payload: Any = None, seq: int = 0, activate: int = 0,
                 valid: int = 0, response: Any = None) -> None:
        self.payload = payload
        self.seq = seq
        self.activate = activate
        self.valid = valid
        self.response = response
        self.done = threading.Event()

    # Backwards-compatible alias (the checkpointer's AnnounceRec exposed
    # the event as ``done_event``).
    @property
    def done_event(self) -> threading.Event:
        return self.done


class AnnounceBoard:
    """Volatile announcement array shared by combiner-style components."""

    def __init__(self, n_slots: int,
                 on_announce: Optional[Callable[[], None]] = None) -> None:
        self.n = n_slots
        self.slots: List[Optional[Announcement]] = [None] * n_slots
        self._on_announce = on_announce

    # ------------------ announcer side -------------------------------- #
    def announce(self, p: int, payload: Any, *, seq: Optional[int] = None,
                 response: Any = None) -> Announcement:
        """Publish an announcement in slot ``p``.

        With an explicit ``seq`` the activate bit is its parity (the
        paper's detectability convention — recovery re-announces the same
        seq and the parities line up).  Without one, the activate bit
        simply flips relative to the previous announcement in the slot.
        """
        prev = self.slots[p]
        if seq is None:
            seq = (prev.seq + 1) if prev else 1
            activate = 1 - (prev.activate if prev else 0)
        else:
            activate = seq % 2
        rec = Announcement(payload, seq, activate, 1, response)
        self.slots[p] = rec
        if self._on_announce is not None:
            self._on_announce()
        return rec

    # ------------------ combiner side --------------------------------- #
    def pending(self) -> List[Tuple[int, Announcement]]:
        """Valid announcements nobody has served yet (done-event view —
        used by combiners whose served-detection is the event itself)."""
        out = []
        for p in range(self.n):
            rec = self.slots[p]
            if rec is not None and rec.valid == 1 and not rec.done.is_set():
                out.append((p, rec))
        return out

    def active_vs(self, deactivate: Sequence[int]) \
            -> List[Tuple[int, Announcement]]:
        """Valid announcements whose activate parity differs from the
        caller's (persisted) deactivate bits — the paper's line 17."""
        out = []
        for p in range(self.n):
            rec = self.slots[p]
            if rec is not None and rec.valid == 1 \
                    and rec.activate != deactivate[p]:
                out.append((p, rec))
        return out

    def serve(self, rec: Announcement, response: Any) -> None:
        rec.response = response
        rec.done.set()

    # ------------------ crash ----------------------------------------- #
    def reset(self) -> None:
        """A crash wiped DRAM: all announcements are gone (P1)."""
        self.slots = [None] * self.n
