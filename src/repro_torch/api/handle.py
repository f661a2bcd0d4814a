"""Per-thread handles: the paper's "system support" made explicit.

Section 2 of the paper assumes the system hands every operation a
per-thread *consecutive* sequence number and re-supplies the in-flight
(func, args, seq) to the recovery function after a crash.  A ``Handle``
is that system: it owns the seq counters (one per (object, seq-group) —
parity is per combining instance, so the split queues get independent
enqueue/dequeue counters), records every in-flight call with the runtime
so ``CombiningRuntime.recover`` can replay it, and exposes the typed
sugar (``q.enqueue(x)``, ``stack.pop()``, ``heap.insert(k)``) so callers
stop hand-threading thread ids and seq numbers.

Hot path (DESIGN.md §5): the first ``invoke`` of an (object, op) pair
resolves the op spec once — seq-group key, in-flight key, and a
pre-bound adapter callable from ``adapter.bind_op`` — and caches the
triple on the handle.  Every later call is two dict operations, the seq
bump, and the direct call: no string re-resolution, no per-call
OpSpec lookups, no intermediate adapter frame.  The typed ``Bound``
sugar goes one step further and stores the per-op invoker as an
instance attribute at bind time.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core.nvm import SimulatedCrash

BATCH = "__batch__"   # runtime in-flight marker for invoke_many records


class Handle:
    """One logical thread attached to a CombiningRuntime."""

    __slots__ = ("runtime", "tid", "_seq", "_resolved")

    def __init__(self, runtime: Any, tid: int) -> None:
        self.runtime = runtime
        self.tid = tid
        self._seq: Dict[Tuple[str, str], int] = {}
        # (object name, op) -> (seq_key, inflight_key, bound fn)
        self._resolved: Dict[Tuple[str, str], Tuple] = {}

    # ------------------ op resolution / seq management ----------------- #
    def _resolve(self, obj: Any, op: str) -> Tuple:
        key = (obj.name, op)
        ent = self._resolved.get(key)
        if ent is None:
            spec = obj.adapter._spec(op)       # raises ValueError: no op
            parts = obj.adapter.bind_parts(obj.core, op)
            ent = ((obj.name, spec.group), (obj.name, self.tid),
                   obj.adapter.bind_op(obj.core, op), parts)
            self._resolved[key] = ent
        return ent

    def _next_seq(self, obj: Any, op: str) -> int:
        seq_key = self._resolve(obj, op)[0]
        seq = self._seq.get(seq_key, 0) + 1
        self._seq[seq_key] = seq
        return seq

    @staticmethod
    def _norm(args: tuple) -> Any:
        if not args:
            return None
        if len(args) == 1:
            return args[0]
        return tuple(args)

    def _clock(self):
        """The runtime NVM's virtual clock, if a profile is engaged.
        Handles bind their tid as the clock's logical thread for the
        duration of each call, so modeled costs are charged per logical
        thread even when one OS thread drives many handles (the
        deterministic modeled bench pass does exactly that)."""
        nvm = self.runtime.nvm
        return nvm.clock if nvm is not None else None

    # ------------------ invocation ------------------------------------ #
    def invoke(self, obj: Any, op: str, *args: Any) -> Any:
        """Run one operation; the runtime replays it on recovery if a
        crash lands mid-call."""
        seq_key, key, fn, _parts = self._resolve(obj, op)
        a = args[0] if len(args) == 1 else (None if not args
                                            else tuple(args))
        seqs = self._seq
        seq = seqs.get(seq_key, 0) + 1
        seqs[seq_key] = seq
        inflight = self.runtime._inflight
        inflight[key] = (op, a, seq)
        clock = self._clock()
        try:
            if clock is None:
                ret = fn(self.tid, a, seq)
            else:
                with clock.bind(self.tid):
                    ret = fn(self.tid, a, seq)
        except SimulatedCrash:
            raise                       # stays in-flight -> replayed
        except BaseException:
            inflight.pop(key, None)
            raise
        inflight.pop(key, None)
        return ret

    def invoker(self, obj: Any, op: str, arity: Optional[int] = None):
        """A zero-lookup callable for one (object, op): everything the
        invoke path needs is captured at bind time.  Used by the typed
        sugar; semantically identical to ``invoke(obj, op, *args)``.
        ``arity`` 0/1 selects a specialized closure without per-call
        varargs packing (the typed sugar knows each op's shape)."""
        seq_key, key, fn, parts = self._resolve(obj, op)
        seqs = self._seq
        inflight = self.runtime._inflight
        tid = self.tid

        if parts is not None:
            entry, func, default = parts

            def run(a: Any) -> Any:
                seq = seqs.get(seq_key, 0) + 1
                seqs[seq_key] = seq
                inflight[key] = (op, a, seq)
                try:
                    ret = entry(tid, func, default if a is None else a, seq)
                except SimulatedCrash:
                    raise
                except BaseException:
                    inflight.pop(key, None)
                    raise
                inflight.pop(key, None)
                return ret
        else:
            def run(a: Any) -> Any:
                seq = seqs.get(seq_key, 0) + 1
                seqs[seq_key] = seq
                inflight[key] = (op, a, seq)
                try:
                    ret = fn(tid, a, seq)
                except SimulatedCrash:
                    raise
                except BaseException:
                    inflight.pop(key, None)
                    raise
                inflight.pop(key, None)
                return ret

        clock = self._clock()   # bind-time decision: no per-call check
        if clock is not None:
            inner = run

            def run(a: Any) -> Any:
                # binding may enclose the bookkeeping: it only affects
                # which logical clock the call's costs are charged to
                with clock.bind(tid):
                    return inner(a)

        if arity == 0:
            return lambda: run(None)
        if arity == 1:
            return run

        def call(*args: Any) -> Any:
            return run(args[0] if len(args) == 1
                       else (None if not args else tuple(args)))
        return call

    def invoke_many(self, calls: Sequence[Sequence[Any]]) -> List[Any]:
        """Batched invocation: ``calls`` is ``[(obj, op, *args), ...]``.

        When every call targets the same object and its adapter supports
        a batch path (``invoke_batch``), all calls are announced together
        and served by ONE combining round (one contiguous persist, one
        psync) — this is the path the serving engine's completion log
        rides on.  Otherwise the calls run sequentially; batching then
        comes from cross-thread combining, as in the paper.
        """
        calls = [tuple(c) for c in calls]
        if not calls:
            return []
        first = calls[0][0]
        same = all(c[0] is first for c in calls)
        if same and first.adapter.invoke_batch is not None:
            batch = [(c[1], self._norm(c[2:]), self._next_seq(first, c[1]))
                     for c in calls]
            key = (first.name, self.tid)
            self.runtime._inflight[key] = (BATCH, batch, 0)
            try:
                rets = first.adapter.invoke_batch(first.core, self.tid,
                                                  batch)
            except SimulatedCrash:
                raise
            except BaseException:
                self.runtime._inflight.pop(key, None)
                raise
            self.runtime._inflight.pop(key, None)
            return rets
        return [self.invoke(c[0], c[1], *c[2:]) for c in calls]

    # ------------------ announce / perform ---------------------------- #
    def announce(self, obj: Any, op: str, *args: Any) -> int:
        """Publish the request without serving it (detectable combining
        protocols only).  Used by crash tests to stage a round serving
        many announced requests; returns the seq the runtime will replay
        with."""
        a = self._norm(args)
        seq = self._next_seq(obj, op)
        clock = self._clock()
        if clock is None:
            obj.adapter.announce(obj.core, self.tid, op, a, seq)
        else:
            with clock.bind(self.tid):
                obj.adapter.announce(obj.core, self.tid, op, a, seq)
        self.runtime._inflight[(obj.name, self.tid)] = (op, a, seq)
        return seq

    def perform(self, obj: Any) -> Any:
        """Serve this handle's announced request (possibly combining
        every other announced request along the way)."""
        key = (obj.name, self.tid)
        if key not in self.runtime._inflight:
            raise RuntimeError(f"nothing announced on {obj.name} "
                               f"by thread {self.tid}")
        op, _a, _seq = self.runtime._inflight[key]
        clock = self._clock()
        try:
            if clock is None:
                ret = obj.adapter.perform(obj.core, self.tid, op)
            else:
                with clock.bind(self.tid):
                    ret = obj.adapter.perform(obj.core, self.tid, op)
        except SimulatedCrash:
            raise                       # stays in-flight -> replayed
        except BaseException:
            self.runtime._inflight.pop(key, None)
            raise
        self.runtime._inflight.pop(key, None)
        return ret

    # ------------------ typed sugar ----------------------------------- #
    def bind(self, obj: Any) -> "Bound":
        return bind(self, obj)


class Bound:
    """Base typed proxy: an object + the handle operating on it.

    Subclasses pre-bind their per-op invokers as instance attributes —
    ``bound.enqueue(x)`` goes straight into the cached fast path with no
    per-call attribute or string resolution."""

    def __init__(self, handle: Handle, obj: Any) -> None:
        self._h = handle
        self._obj = obj

    def snapshot(self) -> Any:
        return self._obj.snapshot()


class BoundQueue(Bound):
    def __init__(self, handle: Handle, obj: Any) -> None:
        super().__init__(handle, obj)
        self.enqueue = handle.invoker(obj, "enqueue", arity=1)
        self.dequeue = handle.invoker(obj, "dequeue", arity=0)

    def drain(self) -> List[Any]:
        return self._obj.snapshot()


class BoundStack(Bound):
    def __init__(self, handle: Handle, obj: Any) -> None:
        super().__init__(handle, obj)
        self.push = handle.invoker(obj, "push", arity=1)
        self.pop = handle.invoker(obj, "pop", arity=0)

    def drain(self) -> List[Any]:
        return self._obj.snapshot()


class BoundHeap(Bound):
    def __init__(self, handle: Handle, obj: Any) -> None:
        super().__init__(handle, obj)
        self.insert = handle.invoker(obj, "insert", arity=1)
        self.delete_min = handle.invoker(obj, "delete_min", arity=0)
        self.get_min = handle.invoker(obj, "get_min", arity=0)


class BoundCounter(Bound):
    def __init__(self, handle: Handle, obj: Any) -> None:
        super().__init__(handle, obj)
        # fetch_add stays varargs: ``fetch_add()`` means FAA(1) (the
        # OpSpec default fills in when no argument is given)
        self.fetch_add = handle.invoker(obj, "fetch_add")
        self.read = handle.invoker(obj, "read", arity=0)


class BoundLog(Bound):
    def __init__(self, handle: Handle, obj: Any) -> None:
        super().__init__(handle, obj)
        # record takes ONE (client, seq, response) triple
        self.record = handle.invoker(obj, "record", arity=1)
        self.lookup = handle.invoker(obj, "lookup", arity=1)


class BoundCkpt(Bound):
    def __init__(self, handle: Handle, obj: Any) -> None:
        super().__init__(handle, obj)
        # persist takes ONE (step, payload) pair
        self.persist = handle.invoker(obj, "persist", arity=1)
        self.latest = handle.invoker(obj, "latest", arity=0)


_BOUND_BY_KIND = {"queue": BoundQueue, "stack": BoundStack,
                  "heap": BoundHeap, "counter": BoundCounter,
                  "log": BoundLog, "ckpt": BoundCkpt}


def bind(handle: Handle, obj: Any) -> Bound:
    return _BOUND_BY_KIND.get(obj.kind, Bound)(handle, obj)
