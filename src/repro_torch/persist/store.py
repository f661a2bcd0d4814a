"""Persistent store with explicit epoch-persistency semantics.

Maps the paper's persistence instructions onto storage:

    pwb(name, data)  -> buffered write (staged, NOT durable)
    pfence()         -> ordering barrier: everything pwb'd before the
                        fence becomes durable before anything after it
    psync()          -> block until all prior pwbs are durable

``DirStore`` realizes this on a real directory (pwb = write to a staging
file, pfence/psync = fsync + atomic rename).  ``MemStore`` is an
in-memory twin with *adversarial crash resolution* — exactly like
core.nvm — used by the crash tests to enumerate every reachable
post-crash state of the checkpointer.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Dict, List, Optional, Tuple


class Store:
    def pwb(self, name: str, data: bytes) -> None:
        raise NotImplementedError

    def pfence(self) -> None:
        raise NotImplementedError

    def psync(self) -> None:
        raise NotImplementedError

    def read(self, name: str) -> Optional[bytes]:
        raise NotImplementedError

    counters: Dict[str, int]


class MemStore(Store):
    """In-memory store with the paper's crash semantics (epoch queue).

    ``persist_latency``: seconds a psync blocks (models storage fsync
    cost for the checkpoint benchmarks); 0 keeps tests instant."""

    def __init__(self, persist_latency: float = 0.0) -> None:
        self._dur: Dict[str, bytes] = {}
        self._epochs: List[List[Tuple[str, bytes]]] = [[]]
        self._lock = threading.Lock()
        self.persist_latency = persist_latency
        self.counters = {"pwb": 0, "pfence": 0, "psync": 0, "crashes": 0}

    def pwb(self, name: str, data: bytes) -> None:
        with self._lock:
            self.counters["pwb"] += 1
            self._epochs[-1].append((name, bytes(data)))

    def pfence(self) -> None:
        with self._lock:
            self.counters["pfence"] += 1
            if self._epochs[-1]:
                self._epochs.append([])

    def psync(self) -> None:
        had = False
        with self._lock:
            self.counters["psync"] += 1
            had = any(self._epochs)
            for epoch in self._epochs:
                for name, data in epoch:
                    self._dur[name] = data
            self._epochs = [[]]
        if had and self.persist_latency:
            import time
            time.sleep(self.persist_latency)

    def read(self, name: str) -> Optional[bytes]:
        with self._lock:
            return self._dur.get(name)

    def crash(self, rng: Optional[random.Random] = None) -> None:
        """Adversarially resolve the write-back queue, then drop it."""
        with self._lock:
            self.counters["crashes"] += 1
            if rng is not None and self._epochs:
                cut = rng.randint(0, len(self._epochs) - 1)
                for epoch in self._epochs[:cut]:
                    for name, data in epoch:
                        self._dur[name] = data
                for name, data in self._epochs[cut]:
                    if rng.random() < 0.5:
                        self._dur[name] = data
            self._epochs = [[]]


class DirStore(Store):
    """Directory-backed store.

    pwb writes ``name.staged-k``; psync fsyncs every staged file and
    atomically renames it over ``name`` (rename-after-fsync gives the
    pfence ordering for free on POSIX).  A crash between pwb and psync
    leaves the old contents — the same guarantee the paper's pwb queue
    provides.
    """

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._staged: List[List[Tuple[str, str]]] = [[]]
        self._lock = threading.Lock()
        self._k = 0
        self.counters = {"pwb": 0, "pfence": 0, "psync": 0, "crashes": 0}

    def _path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def pwb(self, name: str, data: bytes) -> None:
        with self._lock:
            self.counters["pwb"] += 1
            self._k += 1
            staged = self._path(f"{name}.staged-{self._k}")
            with open(staged, "wb") as f:
                f.write(data)
            self._staged[-1].append((name, staged))

    def pfence(self) -> None:
        with self._lock:
            self.counters["pfence"] += 1
            if self._staged[-1]:
                self._staged.append([])

    def psync(self) -> None:
        with self._lock:
            self.counters["psync"] += 1
            for epoch in self._staged:
                for name, staged in epoch:
                    with open(staged, "rb") as f:
                        os.fsync(f.fileno())
                    os.replace(staged, self._path(name))
            # fsync the directory so the renames are durable
            fd = os.open(self.root, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            self._staged = [[]]

    def read(self, name: str) -> Optional[bytes]:
        try:
            with open(self._path(name), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None
