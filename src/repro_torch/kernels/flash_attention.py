"""Flash attention forward: the hand-written CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention`` (the
Pallas TPU kernel).  At the serving slice's shapes it must move ~50 MB of
q/k/v/o against ~8.6 GFLOP, so it is bound by the bytes.  bf16 inputs run
on the tensor cores: one CTA of one warpgroup per (b*h, 64-row q tile), Q
and a two-stage cp.async ring of K/V tiles in bf16 in shared memory,
``wgmma`` for Q K^T and P V with S and P kept in registers (P rounded to
bf16 before P V), the online softmax on the fragments.  f32 inputs keep
an FMA body in full f32.  Both bound the kv loop per q tile
by the causal diagonal and the window and mask ragged tails; the source
describes the design.

q: [B, H, Sq, d]; k, v: [B, Hkv, Sk, d] -> [B, H, Sq, d], q positions
right-aligned by Sk - Sq.  A CPU tensor goes to ``flash_attention_plain``;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

NEG_INF = -2.0 ** 30
HEAD_DIMS = (128, 256)     # the dense configs' head dims
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_layout(name: str, *tensors: torch.Tensor) -> None:
    """The kernels index their inputs as dense arrays and move 16 bytes at
    a time, so each input must be contiguous and start on a 16-byte
    boundary (a misaligned vector access would fault the CUDA context
    instead of raising)."""
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: inputs must start on a 16-byte boundary")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Materialized-logits attention with the kernel's masks (the
    counterpart of ``repro.kernels.ref.attention_ref``)."""
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(B, Hkv, G, Sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos < kpos + window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, H, Sq, d).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, H, Sq, d]; k, v: [B, Hkv, Sk, d] -> [B, H, Sq, d]."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must all lie on one "
                         "CUDA device (or all on the CPU)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: expected q [B,H,Sq,d] and "
                         "k, v [B,Hkv,Sk,d]")
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != d or H % Hkv:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)} vs "
                         f"{tuple(k.shape)} do not form GQA")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype, "
                        f"float32 or bfloat16 (got {q.dtype}, {k.dtype}, "
                        f"{v.dtype})")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    check_layout("flash_attention", q, k, v)
    if window is not None and window < 1:
        raise ValueError("flash_attention: window must be >= 1")
    if softcap is not None and softcap <= 0:
        raise ValueError("flash_attention: softcap must be > 0")
    if Sq == 0 or Sk == 0:
        raise ValueError("flash_attention: empty sequence")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    rc = _build.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, Hkv, Sq, Sk, d, DTYPE_CODES[q.dtype], int(causal),
        -1 if window is None else int(window),
        0.0 if softcap is None else float(softcap), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
