"""Structure adapters: one calling convention over every recoverable
structure and baseline.

The paper's claim is a *universal* recipe — any sequential data
structure becomes a recoverable concurrent one — but the seed exposed
each implementation through an ad-hoc convention (``PBComb.op(p, func,
args, seq)``, ``PBQueue.enqueue(p, value, seq)``, per-class recovery
dances).  An adapter normalizes exactly four things per structure:

  * **ops** — sugar-name -> (protocol func tag, seq group, default arg),
    e.g. ``enqueue -> ("ENQ", "enq", None)``.  The *seq group* matters
    for the split-instance queues: detectability parity is per combining
    instance, so the runtime keeps one seq counter per (object, group).
  * **invoke / recover** — the normal path and the paper's Recover path
    with identical signatures.
  * **reset_volatile / snapshot** — post-crash volatile rebuild and a
    comparable view of the logical state (for crash/recovery checks).
  * **announce / perform** — optional (detectable combining protocols
    only): split an op into its announcement and the combining phase so
    crash-point tests can enumerate crashes *inside* a round that is
    serving many announced requests.

Adapters are stateless; all state lives in the wrapped core object.

Only the adapter base and the op tables are copied here: the concrete
adapters wrap the NVM-backed structures, which come with a later slice
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple


class OpSpec(NamedTuple):
    func: str               # protocol func tag ("ENQ", "PUSH", "FAA", ...)
    group: str              # seq-counter group (parity is per instance)
    default: Any = None     # args value for zero-arg sugar ("read" -> 0)


QUEUE_OPS = {"enqueue": OpSpec("ENQ", "enq"),
             "dequeue": OpSpec("DEQ", "deq")}
STACK_OPS = {"push": OpSpec("PUSH", "main"),
             "pop": OpSpec("POP", "main")}
HEAP_OPS = {"insert": OpSpec("HINSERT", "main"),
            "delete_min": OpSpec("HDELETEMIN", "main"),
            "get_min": OpSpec("HGETMIN", "main")}
COUNTER_OPS = {"fetch_add": OpSpec("FAA", "main", 1),
               "read": OpSpec("FAA", "main", 0)}
LOG_OPS = {"record": OpSpec("RECORD", "main"),
           "lookup": OpSpec("LOOKUP", "main")}
CKPT_OPS = {"persist": OpSpec("CKPT", "main"),
            "latest": OpSpec("CKPTGET", "main")}


class StructureAdapter:
    """Base adapter: subclasses set ``kind``/``protocol``/``OPS`` and
    implement the structure-specific pieces."""

    kind: str = ""
    protocol: str = ""
    detectable: bool = False     # exactly-once recovery of in-flight ops
    can_announce: bool = False   # announce/perform split available
    OPS: Dict[str, OpSpec] = {}

    # ---------------- construction ------------------------------------ #
    def create(self, nvm: Any, n_threads: int,
               counters: Optional[Any] = None, **kw) -> Any:
        raise NotImplementedError

    # ---------------- normal + recovery paths ------------------------- #
    def _spec(self, op: str) -> OpSpec:
        try:
            return self.OPS[op]
        except KeyError:
            raise ValueError(
                f"{self.kind}/{self.protocol} has no op {op!r}; "
                f"supported: {sorted(self.OPS)}") from None

    def _args(self, op: str, args: Any) -> Any:
        return self._spec(op).default if args is None else args

    def invoke(self, core: Any, p: int, op: str, args: Any,
               seq: int) -> Any:
        raise NotImplementedError

    def bind_op(self, core: Any, op: str):
        """Pre-resolved ``fn(p, args, seq)`` for one (core, op) pair —
        handles cache these so the hot invoke path stops re-resolving op
        strings and OpSpecs per call.  The default wraps ``invoke``;
        adapters whose cores expose a direct entry override it to bind
        the core method itself."""
        self._spec(op)                  # validate (raises ValueError)
        invoke = self.invoke

        def fn(p: int, args: Any, seq: int) -> Any:
            return invoke(core, p, op, args, seq)
        return fn

    def bind_parts(self, core: Any, op: str):
        """Optional deeper binding: ``(entry, func, default)`` such that
        ``entry(p, func, args-or-default, seq)`` IS the operation — lets
        the handle skip one wrapper frame per call.  None means "use
        bind_op"."""
        return None

    def recover(self, core: Any, p: int, op: str, args: Any,
                seq: int) -> Any:
        spec = self._spec(op)
        return core.recover(p, spec.func, self._args(op, args), seq)

    def recover_batch(self, core: Any, p: int,
                      calls: List[Tuple[str, Any, int]]) -> List[Any]:
        return [self.recover(core, p, op, args, seq)
                for op, args, seq in calls]

    # ---------------- optional paths ----------------------------------- #
    invoke_batch = None   # type: Optional[Any]  # set by batching adapters

    def announce(self, core: Any, p: int, op: str, args: Any,
                 seq: int) -> None:
        raise NotImplementedError(f"{self.protocol} cannot pre-announce")

    def perform(self, core: Any, p: int, op: str) -> Any:
        raise NotImplementedError(f"{self.protocol} cannot pre-announce")

    # ---------------- crash plumbing ----------------------------------- #
    def reset_volatile(self, core: Any) -> None:
        core.reset_volatile()

    # ---------------- reclamation -------------------------------------- #
    def quiesce(self, core: Any) -> Optional[dict]:
        """Advance the structure's durable reclamation boundaries at a
        quiescent point (no requests in flight).  Structures without a
        reclaimer return None."""
        return None

    def snapshot(self, core: Any) -> Any:
        raise NotImplementedError

    # ---------------- measured-degree accounting ------------------------ #
    def degree_stats(self, core: Any) -> Optional[dict]:
        """Measured combining-degree counters (rounds / ops_combined /
        degree_mean / degree_max) accumulated by the core since creation
        (or the last ``reset_degree_stats``), or None for protocols that
        do not combine (the per-op-persist baselines)."""
        return None

    def reset_degree_stats(self, core: Any) -> None:
        """Zero the degree counters (benchmarks call this after their
        warmup so degree_max reflects only the measured window)."""
