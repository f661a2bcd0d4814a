"""Parameters from the reference package, leaf for leaf.

``params_from_reference`` takes the reference's parameter pytree with
numpy leaves (``jax.tree.map(np.asarray, params)``) and returns the
port's parameters in the same stacked layout.  bf16 leaves travel as
their raw 16-bit words, so the conversion is exact.  This is how every
test that holds the port against the reference gives both packages the
same weights."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve


def _leaf(x, device: torch.device, dtype: Optional[torch.dtype]):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                             .view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_reference(tree: Dict[str, Any], device="cuda",
                          dtype: Optional[torch.dtype] = None):
    """Reference pytree (dicts of numpy arrays) -> dict of tensors on
    ``device``; floating leaves are cast to ``dtype`` when given."""
    dev = resolve(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _leaf(t, dev, dtype)
    return conv(tree)
