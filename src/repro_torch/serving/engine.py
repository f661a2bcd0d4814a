"""Combining batch-serving engine.

Continuous batching IS software combining (DESIGN.md §2): clients
announce generate/cancel requests onto a shared ``AnnounceBoard`` (the
runtime's announcement plumbing — the same component every combining
protocol in this repo announces through) and wait; two combiner
instances — mirroring PBQueue's enqueue/dequeue split — do all the
work:

  * the PREFILL combiner batches every active prefill announcement, runs
    one batched prefill, allocates KV slots, and appends the sequences to
    the shared sequence table;
  * the DECODE combiner batches every *committed* live sequence and runs
    one decode step for all of them per round.

The ``oldTail`` rule: the decode combiner only adopts sequences whose
prefill round has been committed (response-log StateRec persisted) —
PBQueue's "never dequeue past the durable tail", here "never generate
from (or complete) state that a crash would un-happen".

Detectability: client requests carry (client_id, seq).  Completed
responses are recorded in the engine's response log — a
``PBCombCheckpointer`` registered with the shared ``CombiningRuntime``
and written through the batched ``Handle.invoke_many`` path: all
completions of a round are announced together and persisted by ONE
combining round (one contiguous StateRec write + one psync).  After a
crash, a client re-announcing (client_id, seq) receives its cached
response instead of recomputing — exactly the paper's Recover path.

Elimination: a CANCEL announcement is paired with its target GENERATE
announcement inside the combiner *before* touching engine state — both
complete in one pass (the paper's push/pop elimination).

The model is pluggable: ``prefill_batch_fn(prompts) -> (first_tok, kv)``
and ``decode_batch_fn(kv_list, last_toks) -> next_toks`` — the model
adapter lives in launch/serve.py (``build_server``); tests use a toy LM.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..api import AnnounceBoard, Announcement, CombiningRuntime
from ..core.atomics import AtomicInt
from ..persist.checkpoint import CheckpointAdapter, PBCombCheckpointer
from ..persist.store import MemStore, Store
from .kv_cache import SlotAllocator
from .scheduler import RequestHeap


def _live_key(client: int, seq: int) -> int:
    """Sequence-table key for a (client, request-seq) pair."""
    return (client << 32) | (seq & 0xffffffff)


@dataclass
class GenRequest:
    """Announcement payload — pure request data; the announcement record
    (activate/valid bits, done event, response) lives on the board."""
    client: int
    seq: int
    prompt: Tuple[int, ...]
    max_tokens: int
    priority: float = 0.0
    cancel_target: Optional[Tuple[int, int]] = None  # (client, seq) to cancel


@dataclass
class LiveSeq:
    client: int
    seq: int
    slot: int
    tokens: List[int]
    max_tokens: int
    committed: bool = False   # oldTail rule: decode may not touch until True


class CombiningEngine:
    def __init__(self, n_clients: int, *,
                 prefill_batch_fn: Callable,
                 decode_batch_fn: Callable,
                 n_kv_slots: int = 64,
                 max_batch: int = 32,
                 store: Optional[Store] = None,
                 eos_token: int = 0,
                 runtime: Optional[CombiningRuntime] = None,
                 response_log: str = "auto") -> None:
        """``response_log`` selects where completions persist:

          * ``"store"`` — the file-like ``Store`` path (default for
            thread runtimes): a ``PBCombCheckpointer`` whose StateRec
            slot files live in ``store``.
          * ``"nvm"`` — a registry ``log/pbcomb`` structure living in
            the runtime's NVM words: on a shared-memory runtime the
            durable response log (rich token payloads included — blob
            heap, DESIGN.md §8) is then shared with forked worker
            processes, and its psyncs account on its segment's device.
          * ``"auto"`` — ``"nvm"`` iff the runtime's NVM is shm-backed.
        """
        self.n = n_clients
        self.prefill_batch_fn = prefill_batch_fn
        self.decode_batch_fn = decode_batch_fn
        self.max_batch = max_batch
        self.eos = eos_token
        # shared runtime: announce board (volatile — dies with the
        # process) + the durable response log, both under one
        # crash/recovery umbrella.
        self.runtime = runtime or CombiningRuntime(n_threads=n_clients)
        self.board: AnnounceBoard = self.runtime.board("engine", n_clients)
        if response_log == "auto":
            response_log = "nvm" if self.runtime._backend_kind == "shm" \
                or getattr(getattr(self.runtime.nvm, "backend", None),
                           "kind", None) == "shm" else "store"
        if response_log == "nvm":
            raise NotImplementedError(
                "the NVM response log is not ported yet: it needs the "
                "NVM simulator and the structure registry (ROADMAP.md, "
                "queue 1)")
        if response_log == "store":
            self.store = store or MemStore()
            # The engine's durable state is exactly the response log,
            # which lives in the StateRec's ReturnVal/Deactivate fields
            # — the payload pytree is empty.
            self.ckpt = PBCombCheckpointer(self.store, n_clients,
                                           payload_template={})
            self.ckpt.initialize({})
            self.log = self.runtime.register("engine/response-log",
                                             self.ckpt,
                                             CheckpointAdapter())
        else:
            raise ValueError(f"unknown response_log {response_log!r}; "
                             "expected 'auto', 'store' or 'nvm'")
        self._log_handle = self.runtime.attach(0)
        # sequence table (the shared linked structure)
        self.live: Dict[int, LiveSeq] = {}
        self.kv: Dict[int, Any] = {}
        self.slots = SlotAllocator(n_kv_slots)
        self.heap = RequestHeap()
        self.prefill_lock = AtomicInt(0)
        self.decode_lock = AtomicInt(0)
        self._table_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.stats = {"prefill_rounds": 0, "decode_rounds": 0,
                      "prefill_batched": 0, "decode_batched": 0,
                      "eliminated": 0, "persists": 0}

    # ------------------ client API ------------------------------------ #
    def submit(self, client: int, prompt: Sequence[int], max_tokens: int,
               seq: int, priority: float = 0.0,
               timeout: float = 30.0) -> Any:
        req = GenRequest(client, seq, tuple(prompt), max_tokens, priority)
        rec = self.board.announce(client, req)
        if not rec.done.wait(timeout):
            raise TimeoutError(f"client {client} seq {seq}")
        return rec.response

    def cancel(self, client: int, target: Tuple[int, int], seq: int,
               timeout: float = 30.0) -> Any:
        """Cancel the pending request ``target = (client, seq)``."""
        req = GenRequest(client, seq, (), 0, cancel_target=tuple(target))
        rec = self.board.announce(client, req)
        if not rec.done.wait(timeout):
            raise TimeoutError(f"cancel {client}/{seq}")
        return rec.response

    def cached_response(self, client: int, seq: int) -> Tuple[bool, Any]:
        """(was_applied, response) for (client, seq) from the durable
        response log, whichever backing it has."""
        if self.ckpt is not None:
            if self.ckpt.was_applied(client, seq):
                return True, self.ckpt.response(client)
            return False, None
        logged_seq, resp = self.log.adapter.last_record(self.log.core,
                                                        client)
        return logged_seq == seq, resp

    def recover_request(self, client: int, prompt: Sequence[int],
                        max_tokens: int, seq: int,
                        timeout: float = 30.0) -> Any:
        """The paper's Recover: if (client, seq) completed before the
        crash, return the logged response; else re-execute."""
        applied, resp = self.cached_response(client, seq)
        if applied:
            return resp
        return self.submit(client, prompt, max_tokens, seq,
                           timeout=timeout)

    # ------------------ lifecycle -------------------------------------- #
    def start(self) -> None:
        for fn in (self._prefill_loop, self._decode_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)

    def restart_after_crash(self) -> None:
        """Simulated process restart: volatile state (announce board,
        sequence table, KV) is lost; the durable response log survives.
        One runtime call resets every volatile component it owns."""
        with self._table_lock:
            for s in self.live.values():
                self.slots.free(s.slot)
            self.live.clear()
            self.kv.clear()
        self.runtime.recover()

    # ------------------ combiner loops --------------------------------- #
    def _prefill_loop(self) -> None:
        while not self._stop.is_set():
            if not self._combine_prefill():
                time.sleep(0.001)

    def _decode_loop(self) -> None:
        while not self._stop.is_set():
            if not self._combine_decode():
                time.sleep(0.001)

    def _active(self, want_cancel: bool) -> List[Announcement]:
        return [rec for _c, rec in self.board.pending()
                if (rec.payload.cancel_target is not None) == want_cancel]

    def _combine_prefill(self) -> int:
        lval = self.prefill_lock.load()
        if lval % 2 == 1 or not self.prefill_lock.cas(lval, lval + 1):
            return 0
        try:
            served = 0
            gens = self._active(False)
            cancels = self._active(True)
            # --- elimination: pair cancels with waiting generates ------ #
            by_seq = {(r.payload.client, r.payload.seq): r for r in gens}
            for c in cancels:
                tgt = by_seq.get(c.payload.cancel_target)
                if tgt is not None and not tgt.done.is_set():
                    self.board.serve(tgt, {"cancelled": True, "tokens": []})
                    self.board.serve(c, {"cancelled_ok": True})
                    self.stats["eliminated"] += 1
                    served += 2
                else:
                    self.board.serve(c, {"cancelled_ok": False})
                    served += 1
            # --- admission by priority (PBHeap) ------------------------ #
            # skip requests already admitted (their LiveSeq is decoding):
            # re-admitting would re-run prefill and orphan the earlier
            # KV slot when the duplicate LiveSeq overwrites the table key
            with self._table_lock:
                admitted = set(self.live.keys())
            gens = [g for g in gens if not g.done.is_set()
                    and _live_key(g.payload.client,
                                  g.payload.seq) not in admitted]
            for g in gens:
                self.heap.insert(g.payload.priority, g)
            batch: List[Announcement] = []
            slot_of: Dict[int, int] = {}          # round-local: id -> slot
            while len(batch) < self.max_batch and len(self.heap):
                if self.slots.available() == 0:
                    break
                g = self.heap.delete_min()
                if g.done.is_set():
                    continue
                key = _live_key(g.payload.client, g.payload.seq)
                if key in admitted:      # stale duplicate heap entry
                    continue
                slot = self.slots.alloc()
                if slot is None:
                    break
                admitted.add(key)
                slot_of[id(g)] = slot
                batch.append(g)
            if not batch:
                return served
            # --- one batched prefill for the whole round --------------- #
            toks, kvs = self.prefill_batch_fn(
                [g.payload.prompt for g in batch])
            round_seqs: List[LiveSeq] = []
            with self._table_lock:
                for g, t0, kv in zip(batch, toks, kvs):
                    req = g.payload
                    ls = LiveSeq(req.client, req.seq, slot_of[id(g)], [t0],
                                 req.max_tokens)
                    self.live[_live_key(req.client, req.seq)] = ls
                    self.kv[ls.slot] = kv
                    round_seqs.append(ls)
            # commit marker (oldTail): decode may now adopt these
            with self._table_lock:
                for ls in round_seqs:
                    ls.committed = True
            self.stats["prefill_rounds"] += 1
            self.stats["prefill_batched"] += len(batch)
            return served + len(batch)
        finally:
            self.prefill_lock.store(self.prefill_lock.load() + 1)

    def _combine_decode(self) -> int:
        lval = self.decode_lock.load()
        if lval % 2 == 1 or not self.decode_lock.cas(lval, lval + 1):
            return 0
        try:
            with self._table_lock:
                batch = [s for s in self.live.values() if s.committed]
            if not batch:
                return 0
            kvs = [self.kv[s.slot] for s in batch]
            last = [s.tokens[-1] for s in batch]
            nxt = self.decode_batch_fn(kvs, last)
            finished: List[LiveSeq] = []
            for s, t in zip(batch, nxt):
                s.tokens.append(int(t))
                if int(t) == self.eos or len(s.tokens) >= s.max_tokens:
                    finished.append(s)
            if finished:
                self._complete(finished)
            self.stats["decode_rounds"] += 1
            self.stats["decode_batched"] += len(batch)
            return len(batch)
        finally:
            self.decode_lock.store(self.decode_lock.load() + 1)

    def _complete(self, finished: List[LiveSeq]) -> None:
        """Persist ALL completions of the round through the runtime's
        batched ``invoke_many`` path — one combining round, one
        contiguous StateRec write, one psync — then release waiters and
        recycle slots (the paper's 'respond only after psync' rule)."""
        responses = {s.slot: {"tokens": list(s.tokens), "seq": s.seq}
                     for s in finished}
        self._log_handle.invoke_many(
            [(self.log, "record", s.client, s.seq, responses[s.slot])
             for s in finished])
        self.stats["persists"] += 1
        # serve before the table forgets the sequences: a prefill
        # combiner running in between would find an announcement neither
        # done nor live and admit it a second time (the reference engine
        # drops them from the table first)
        for s in finished:
            rec = self.board.slots[s.client]
            if rec is not None and rec.payload.seq == s.seq:
                self.board.serve(rec, responses[s.slot])
        with self._table_lock:
            for s in finished:
                self.live.pop(_live_key(s.client, s.seq), None)
                self.kv.pop(s.slot, None)
                self.slots.free(s.slot)            # recycling stack
