"""CombiningRuntime — one owner for NVM, structures, announcement
boards, and crash/recovery.

The runtime is the "machine": it owns the simulated NVMM, every
recoverable structure living in it (registered via ``make`` /
``register``), every announcement board handed to combiner-style
components, and the per-thread handles.  Crashing the machine and
recovering it is then ONE call each, for *all* registered structures at
once:

    rt = CombiningRuntime(n_threads=4)
    q = rt.make("queue", "pbcomb")
    s = rt.make("stack", "pwfcomb")
    h = rt.attach(0)
    h.bind(q).enqueue(1); h.bind(s).push(2)
    rt.crash()            # adversarial write-back drain, volatile wiped
    rt.recover()          # every structure reset + in-flight replayed

``recover`` performs, in order: (1) disarm any pending crash countdown,
(2) wipe every announcement board (volatile, P1), (3) rebuild each
structure's volatile protocol state (locks, request arrays, S refs,
pending-link redo...), (4) replay every in-flight operation recorded by
the handles — the paper's system-support contract — returning the
responses keyed by (object name, thread id).

This copy is trimmed to what the serving slice runs: boards,
``register``-ed structures (the engine's ``PBCombCheckpointer``
response log), handles, crash and recover.  ``make``,
``spawn_workers``, ``quiesce``, ``occupancy``, ``segment_stats`` and
``arm_crash`` need the NVM simulator and the registry, and raise
``NotImplementedError`` until that slice lands.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ..core.atomics import Counters
from .board import AnnounceBoard
from .handle import BATCH, Handle, bind

_NOT_YET = ("is not ported yet: it needs the NVM simulator and the "
            "structure registry (ROADMAP.md, queue 1)")


class RecoverableObject:
    """A registered structure: core implementation + its adapter."""

    def __init__(self, name: str, core: Any, adapter: Any,
                 runtime: "CombiningRuntime") -> None:
        self.name = name
        self.core = core
        self.adapter = adapter
        self.runtime = runtime

    @property
    def kind(self) -> str:
        return self.adapter.kind

    @property
    def protocol(self) -> str:
        return self.adapter.protocol

    @property
    def detectable(self) -> bool:
        return self.adapter.detectable

    def snapshot(self) -> Any:
        """Comparable view of the logical state (drain order for linked
        structures, sorted keys for heaps, the value for counters)."""
        return self.adapter.snapshot(self.core)

    def bind(self, handle: Handle):
        return bind(handle, self)

    def __repr__(self) -> str:
        return f"<RecoverableObject {self.name}>"


class CombiningRuntime:
    def __init__(self, nvm: Optional[Any] = None, n_threads: int = 8,
                 counters: Optional[Counters] = None,
                 nvm_words: Optional[int] = None,
                 profile: Optional[Any] = None,
                 backend: str = "threads",
                 segments: int = 1) -> None:
        """``profile`` (a cost-profile name or ``CostProfile``) is kept
        for the NVM slice; the serving slice never creates an NVM.
        Only the ``"threads"`` backend exists in this copy."""
        if backend == "shm":
            raise NotImplementedError(f"the shm backend {_NOT_YET}")
        if backend != "threads":
            raise ValueError(f"unknown backend {backend!r}; "
                             "expected 'threads' or 'shm'")
        if segments != 1:
            raise ValueError("multi-segment NVM is a property of the shm "
                             "backend (the thread NVM models one DIMM)")
        self.nvm = nvm
        self.n_threads = n_threads
        self.counters = counters
        self._nvm_words = nvm_words
        self._profile = profile
        self._backend_kind = backend
        self._segments = segments
        self._next_segment = 0         # round-robin placement cursor
        self._placement: Dict[str, int] = {}
        self._owns_nvm = nvm is None   # close() releases only what we made
        self._closed = False
        self._pools: list = []
        self.objects: Dict[str, RecoverableObject] = {}
        self.boards: Dict[str, AnnounceBoard] = {}
        self._handles: Dict[int, Handle] = {}
        # (object name, tid) -> (op, args, seq) | (BATCH, calls, 0)
        self._inflight: Dict[Tuple[str, int], Tuple[str, Any, int]] = {}

    # ------------------ construction ----------------------------------- #
    def make(self, kind: str, protocol: str = "pbcomb",
             name: Optional[str] = None, segment: Optional[int] = None,
             **kw) -> RecoverableObject:
        """Create + register a recoverable structure from the registry."""
        raise NotImplementedError(f"CombiningRuntime.make {_NOT_YET}")

    def register(self, name: str, core: Any,
                 adapter: Any) -> RecoverableObject:
        """Register an externally built core under this runtime's crash/
        recovery umbrella (the registry path uses this too)."""
        if name in self.objects:
            raise ValueError(f"object name {name!r} already registered")
        obj = RecoverableObject(name, core, adapter, self)
        self.objects[name] = obj
        return obj

    def board(self, name: str, n_slots: int,
              on_announce=None) -> AnnounceBoard:
        """A shared announcement board, reset by ``recover`` like every
        other piece of volatile state."""
        if name in self.boards:
            raise ValueError(f"board name {name!r} already registered")
        b = AnnounceBoard(n_slots, on_announce)
        self.boards[name] = b
        return b

    def attach(self, thread_id: int) -> Handle:
        """Per-thread handle; re-attaching returns the same handle (its
        seq counters must survive crashes — they are the paper's
        system-maintained consecutive sequence numbers)."""
        if thread_id not in self._handles:
            self._handles[thread_id] = Handle(self, thread_id)
        return self._handles[thread_id]

    def spawn_workers(self, n_workers: int, tids=None):
        """Fork worker processes over a shared-memory NVM."""
        raise NotImplementedError(f"CombiningRuntime.spawn_workers {_NOT_YET}")

    def degree_stats(self) -> Dict[str, Any]:
        """Measured combining-degree counters per registered object
        (None for protocols that do not combine)."""
        return {name: obj.adapter.degree_stats(obj.core)
                for name, obj in self.objects.items()}

    def quiesce(self, gc_blobs: bool = True) -> Dict[str, Any]:
        """Advance durable reclamation boundaries at a quiescent point."""
        raise NotImplementedError(f"CombiningRuntime.quiesce {_NOT_YET}")

    def occupancy(self) -> Dict[str, Any]:
        """Backend memory accounting."""
        raise NotImplementedError(f"CombiningRuntime.occupancy {_NOT_YET}")

    def segment_stats(self) -> Dict[str, Any]:
        """Per-segment device accounting."""
        raise NotImplementedError(
            f"CombiningRuntime.segment_stats {_NOT_YET}")

    def close(self) -> None:
        """Stop any worker pools and release backend resources (the shm
        segment, if this runtime created it — an ``nvm=`` passed into
        the constructor belongs to the caller and is left open).
        Idempotent; the runtime rejects further use afterwards."""
        if self._closed:
            return
        self._closed = True
        for pool in self._pools:
            pool.close()
        self._pools.clear()
        if self._owns_nvm:
            nvm_close = getattr(self.nvm, "close", None)
            if nvm_close is not None:
                nvm_close()
        self.nvm = None

    def __enter__(self) -> "CombiningRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------ crash simulation ------------------------------- #
    def arm_crash(self, after_persist_ops: int, rng=None,
                  **policy) -> None:
        """Arm a SimulatedCrash inside protocol code."""
        raise NotImplementedError(f"CombiningRuntime.arm_crash {_NOT_YET}")

    def crash(self, rng=None) -> None:
        """Full-machine crash: adversarial write-back drain, volatile
        image reset to the durable one."""
        if self.nvm is not None:
            self.nvm.crash(rng)

    def recover(self, inflight=None) -> Dict[Tuple[str, int], Any]:
        """One-call recovery for everything the runtime owns.  Returns
        the replayed in-flight responses keyed (object name, tid).

        ``inflight``: extra in-flight records from OTHER processes —
        ``[(obj_name, tid, op, args, seq), ...]`` as reported by a
        crashed worker pool (``PoolResult.inflight``).  The runtime's
        own records and the reported ones are replayed together; on the
        shm backend ``disarm_crash`` also clears the machine-off flag,
        so recovery is what powers the machine back on for every
        surviving worker."""
        if self.nvm is not None:
            self.nvm.disarm_crash()
        for b in self.boards.values():
            b.reset()
        for obj in self.objects.values():
            obj.adapter.reset_volatile(obj.core)
        # snapshot + clear IN PLACE: handle invokers captured this dict
        # at bind time, so reassigning it would orphan every bound proxy
        # created before the recover (their in-flight records would land
        # in a dead dict and never replay)
        inflight_map = dict(self._inflight)
        self._inflight.clear()
        for name, tid, op, args, seq in inflight or ():
            inflight_map[(name, tid)] = (op, args, seq)
        responses: Dict[Tuple[str, int], Any] = {}
        for (name, tid), (op, a, seq) in inflight_map.items():
            obj = self.objects.get(name)
            if obj is None:
                continue
            if op == BATCH:
                responses[(name, tid)] = obj.adapter.recover_batch(
                    obj.core, tid, a)
            else:
                responses[(name, tid)] = obj.adapter.recover(
                    obj.core, tid, op, a, seq)
        return responses

