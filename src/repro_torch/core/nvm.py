"""Simulated NVMM — for now only the crash signal.

The reference's ``repro.core.nvm`` models the paper's memory (epoch
persistency, adversarial write-back drain, virtual clock).  The serving
slice needs none of that: its durable response log lives in a ``Store``.
What the copied handle layer does need is the exception an armed crash
countdown raises inside protocol code, so that is all this module holds
until the NVM slice (ROADMAP.md, queue 1) ports the simulator.
"""

from __future__ import annotations


class SimulatedCrash(Exception):
    """Raised when an armed crash countdown fires inside protocol code."""
