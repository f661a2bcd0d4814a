"""Host-side combining primitives copied from the reference package.

Only what the serving slice runs is here: the volatile atomics and the
crash signal.  The NVM simulator and the PBComb/PWFComb protocols come
with later slices (ROADMAP.md, queue 1)."""

from .atomics import AtomicInt, AtomicRef, Counters
from .nvm import SimulatedCrash

__all__ = ["AtomicInt", "AtomicRef", "Counters", "SimulatedCrash"]
