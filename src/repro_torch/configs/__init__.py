"""Architecture registry: ``get(name)``.

The port carries the dense configurations and one SSM configuration:
qwen3-1.7b and mamba2-2.7b are the serving slices' models; gemma2-9b
(sliding window, softcaps) and command-r-35b (wide GQA) cover the dense
family's features in the CPU tests."""

from typing import Dict

from .base import ArchConfig
from .command_r_35b import CONFIG as command_r_35b
from .gemma2_9b import CONFIG as gemma2_9b
from .mamba2_2p7b import CONFIG as mamba2_2p7b
from .qwen3_1p7b import CONFIG as qwen3_1p7b

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in [qwen3_1p7b, gemma2_9b, command_r_35b, mamba2_2p7b]
}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchConfig", "ARCHS", "get"]
