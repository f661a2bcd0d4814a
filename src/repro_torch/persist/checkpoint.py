"""PBComb checkpointer — the paper's protocol as the training-state
persistence engine.

Mapping (DESIGN.md §2):

  threads announcing requests  ->  announcers: trainer loop(s), data
                                   pipeline, eval hooks — anything that
                                   says "persist my state at step N"
  Request[p] (volatile)        ->  in-memory announce slots with the
                                   paper's activate/valid bits
  MemState[0..1] + MIndex      ->  slot-0 / slot-1 StateRec files +
                                   a tiny index file, flipped last
  combiner                     ->  one background thread: serves ALL
                                   active announcements with ONE slot
                                   write + pwb + pfence + index flip +
                                   psync (per combining round, not per
                                   request — persistence principle P1)
  Deactivate / ReturnVal       ->  inside the slot buffer (P3): on
                                   recovery every announcer learns
                                   whether its step-N request was
                                   captured, and its response
  PWFComb takeover             ->  lease: if the combiner stalls past
                                   its lease, any announcer performs the
                                   versioned take-over and combines

Torn checkpoints are impossible by construction: recovery always reads
the slot named by the durable index, and the index only flips after the
slot's psync (the paper's pfence-before-MIndex argument, Section 3).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..api.adapters import OpSpec, StructureAdapter
from ..api.board import AnnounceBoard, Announcement
from . import staterec
from .store import Store

INDEX_FILE = "mindex"
SLOT_FILES = ("staterec.0", "staterec.1")

# The paper's RequestRec for this component is exactly an announcement
# slot; the dedicated dataclass became the shared AnnounceBoard record.
AnnounceRec = Announcement


class PBCombCheckpointer:
    """Detectably-recoverable, double-buffered, combining checkpointer."""

    @classmethod
    def over_nvm(cls, nvm, n_announcers: int, payload_template: Any, *,
                 segment: int = 0, lease_s: float = 5.0
                 ) -> "PBCombCheckpointer":
        """Checkpointer whose slot files live in simulated NVM words
        (``NVMStore``) instead of a file-like store — pass a runtime's
        ``ShmNVM`` to put the durable checkpoint state in the shared
        segment, with its psyncs accounted on ``segment``'s device
        (DESIGN.md §8)."""
        raise NotImplementedError(
            "NVMStore is not ported yet (ROADMAP.md, queue 1: "
            "persist/reclaim, NVMStore and sharded)")

    def __init__(self, store: Store, n_announcers: int,
                 payload_template: Any, *, lease_s: float = 5.0) -> None:
        self.store = store
        self.n = n_announcers
        self.template = payload_template
        self.lease_s = lease_s
        # volatile protocol state (rebuilt on recovery): the shared
        # announcement plumbing of the api package instead of a private list
        self._kick = threading.Event()
        self.board = AnnounceBoard(n_announcers,
                                   on_announce=self._kick.set)
        self._lock = threading.Lock()         # the PBComb integer lock
        self._combine_count = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_combine = time.monotonic()
        # mirror of the durable deactivate/returnval (refreshed on combine)
        self._deactivate: List[int] = [0] * n_announcers
        self._returnval: List[Any] = [None] * n_announcers
        self._mindex = 0

    # ----------------- bootstrap / recovery --------------------------- #
    def initialize(self, payload: Any) -> None:
        """Write an initial durable state (both slots + index)."""
        buf = staterec.pack(payload, [None] * self.n, [0] * self.n)
        self.store.pwb(SLOT_FILES[0], buf)
        self.store.pwb(SLOT_FILES[1], buf)
        self.store.pfence()
        self.store.pwb(INDEX_FILE, b"0")
        self.store.psync()
        self._mindex = 0

    def recover(self) -> Any:
        """Reload the durable state; refresh the volatile mirrors.
        Returns the payload (callers then use ``was_applied`` /
        ``response`` per announcer for detectability)."""
        idx_raw = self.store.read(INDEX_FILE)
        self._mindex = int(idx_raw or b"0")
        data = self.store.read(SLOT_FILES[self._mindex])
        payload, retval, deact = staterec.unpack(data, self.template)
        self._returnval = list(retval)
        self._deactivate = list(deact)
        self.board.reset()                    # announcements are volatile
        return payload

    def was_applied(self, p: int, seq: int) -> bool:
        """Detectability: did announcer p's request with this seq take
        effect before the crash?  (paper Recover, line 4)"""
        return self._deactivate[p] == seq % 2

    def response(self, p: int) -> Any:
        return self._returnval[p]

    # ----------------- announce path ---------------------------------- #
    def announce(self, p: int, payload: Any, seq: int,
                 wait: bool = False, timeout: Optional[float] = None,
                 response: Any = None):
        """Announce "persist payload" for announcer p.

        ``seq`` must be p's CONSECUTIVE announcement number (the paper's
        system-support assumption, Section 2): activate is its parity, so
        detectability self-heals across crashes — the paper's Recover
        sets Request[p] := <func, args, seq mod 2, 1> with the same
        convention."""
        rec = self.board.announce(p, payload, seq=seq, response=response)
        if wait:
            if not rec.done_event.wait(timeout):
                # combiner stalled past its lease -> wait-free takeover
                if self.lease_expired():
                    self.takeover(p)
                rec.done_event.wait(timeout)
        return rec

    # ----------------- combiner ---------------------------------------- #
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()
        if self._thread:
            self._thread.join()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._kick.wait(timeout=0.05)
            self._kick.clear()
            self.combine_once()

    def lease_expired(self) -> bool:
        return time.monotonic() - self._last_combine > self.lease_s

    def takeover(self, p: int) -> None:
        """PWFComb-style helping: announcer p becomes the combiner for
        one round (the lock arbitrates, like the SC on S)."""
        self.combine_once()

    def combine_once(self) -> int:
        """One combining round (paper Algorithm 2 lines 14-28).  Returns
        the number of requests served."""
        with self._lock:
            active = self.board.active_vs(self._deactivate)
            if not active:
                self._last_combine = time.monotonic()
                return 0
            # The object semantics of "persist(payload, seq)": the newest
            # announced payload wins; every served announcer's response is
            # the step/seq the round captured.
            newest = max(active, key=lambda pr: pr[1].seq)
            payload = newest[1].payload
            retval = list(self._returnval)
            deact = list(self._deactivate)
            for p, rec in active:
                retval[p] = rec.response if rec.response is not None \
                    else rec.seq
                deact[p] = rec.activate
            ind = 1 - self._mindex
            buf = staterec.pack(payload, retval, deact)  # one contiguous rec
            self.store.pwb(SLOT_FILES[ind], buf)         # line 22
            self.store.pfence()                          # line 23
            self.store.pwb(INDEX_FILE, str(ind).encode())  # lines 25-26
            self.store.psync()                           # line 27
            self._mindex = ind
            self._returnval = retval
            self._deactivate = deact
            self._combine_count += 1
            self._last_combine = time.monotonic()
            for _, rec in active:
                rec.done_event.set()
            return len(active)

    @property
    def stats(self) -> Dict[str, Any]:
        return {"combines": self._combine_count,
                **dict(self.store.counters)}


class CheckpointAdapter(StructureAdapter):
    """Registers a ``PBCombCheckpointer`` as a runtime structure.

    One op, ``record(slot, seq, response)``: announce "slot's request
    ``seq`` completed with ``response``" into the durable response log.
    The batched path (``Handle.invoke_many``) announces every record of
    a round first and runs ONE combining round — one contiguous slot
    write, one psync, for any number of completions.  This is what the
    serving engine's completion path rides on.
    """

    kind, protocol = "log", "pbcomb"
    detectable = True
    OPS = {"record": OpSpec("RECORD", "main")}

    def create(self, nvm, n_threads, counters=None, **kw):
        raise NotImplementedError(
            "build a PBCombCheckpointer explicitly and runtime.register it")

    @staticmethod
    def _announce(core: PBCombCheckpointer, args: Tuple[int, int, Any]):
        slot, seq, response = args
        core.announce(slot, {}, seq, response=response)

    def invoke(self, core, p, op, args, seq):
        self._spec(op)
        self._announce(core, args)
        core.combine_once()
        return args[2]

    def invoke_batch(self, core, p, calls):
        for _op, args, _hseq in calls:
            self._announce(core, args)
        core.combine_once()                   # one round, one psync
        return [args[2] for _op, args, _hseq in calls]

    def recover(self, core, p, op, args, seq):
        """Exactly-once replay: the announce parity (slot seq mod 2) is
        filtered against the durable deactivate bits, so an already-
        applied record is not re-persisted."""
        self._announce(core, args)
        core.combine_once()
        return core.response(args[0])

    def reset_volatile(self, core):
        core.recover()

    def snapshot(self, core):
        return list(core._returnval)
