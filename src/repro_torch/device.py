"""Device resolution for the port's entry points.

Entry points take ``device="cuda"`` by default and run on the card.  The
CPU is used only when the caller asks for it (``device="cpu"``, as the
tests do): with no CUDA device and no explicit ``"cpu"`` an entry point
raises instead of carrying on quietly on the CPU."""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
