"""Shared model layers: RMSNorm, rotary embeddings, SwiGLU MLP, softcap,
embeddings.  Plain functions on tensors; parameters are dicts of tensors.

Each function rounds where ``repro.models.layers`` rounds, so that the
two packages agree to summation order in f32 and to bf16 resolution in
bf16."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 accumulation for the variance only.

    The input stays in its storage dtype: only the variance is taken in
    f32, its rsqrt is cast back to ``x.dtype``, and the scale is
    ``(1 + w)`` rounded to ``x.dtype``, as the reference does."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    w = (1.0 + weight.float()).to(x.dtype)
    return x * inv * w


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma2-style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq].

    Half-split layout: the first and second halves of the head are the
    two coordinates of each rotated pair."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    angles = positions[..., :, None].float() * freqs        # [..., S, hd/2]
    angles = angles[..., :, None, :]                        # [..., S, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor,
           b_gate=None, b_up=None, b_down=None) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    if b_gate is not None:
        g = g + b_gate
        u = u + b_up
    h = F.silu(g) * u
    out = h @ w_down
    if b_down is not None:
        out = out + b_down
    return out


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor,
            cap: Optional[float] = None,
            valid: Optional[int] = None) -> torch.Tensor:
    """x: [..., D]; table: [Vp, D] (tied) -> logits [..., Vp].

    ``valid``: real vocabulary size — embedding tables are padded to a
    multiple of 256; padded logit columns are masked to -2**30."""
    logits = x @ table.T
    logits = softcap(logits, cap)
    Vp = logits.shape[-1]
    if valid is not None and Vp > valid:
        ids = torch.arange(Vp, device=logits.device)
        logits = logits.masked_fill(ids >= valid, -2.0 ** 30)
    return logits


# --------------------------------------------------------------------- #
# Parameter initialization helpers
# --------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, shape: Sequence[int], in_axis: int = 0,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Normal draw scaled by fan_in ** -0.5, taken in f32 and then cast,
    on the generator's device."""
    std = shape[in_axis] ** -0.5
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * std).to(dtype)


def zeros_init(shape: Sequence[int], dtype=torch.bfloat16,
               device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)
