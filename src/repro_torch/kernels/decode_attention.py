"""Flash-decode: the hand-written CUDA kernel (``csrc/decode_attention.cu``)
and its plain PyTorch version.

Replaces ``src/repro/kernels/decode_attention.py::decode_attention`` (the
Pallas TPU kernel), and also takes the model decode path's optional
``window`` and ``softcap``.  It is bound by reading the cache: each byte
of keys ``[kv_len - window, kv_len)`` is read once, in its storage dtype,
by the CTA that serves all G = H / Hkv query heads of its kv group; the
key range is split across CTAs and the splits are merged by a second
kernel in the same launch call (flash-decoding).

q: [B, H, hd]; k, v: [B, Hkv, S, hd] (heads-major cache); ``kv_len`` a
host int with 1 <= kv_len <= S -> out [B, H, hd].  The query sits at
position kv_len - 1.  A CPU tensor goes to ``decode_attention_plain``; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .flash_attention import DTYPE_CODES, HEAD_DIMS, NEG_INF, check_layout

GROUPS = (1, 2, 8)     # query heads per kv head: MHA and the dense configs
MIN_KEYS_PER_SPLIT = 64


def decode_attention_plain(q, k, v, kv_len: int, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Materialized-logits decode attention over the whole cache with the
    kernel's masks (keys at or past ``kv_len``, and keys outside the
    window of the query at ``kv_len - 1``, take -2**30)."""
    B, H, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(S, device=q.device)
    mask = kpos < kv_len
    if window is not None:
        mask &= (kv_len - 1) < kpos + window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


_SM_COUNT = {}


def _n_split(device, blocks: int, n_keys: int) -> int:
    """Splits of the key range: about two CTAs per SM in all, and at least
    MIN_KEYS_PER_SPLIT keys in each split."""
    if device not in _SM_COUNT:
        _SM_COUNT[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    want = max(1, math.ceil(2 * _SM_COUNT[device] / blocks))
    return max(1, min(want, math.ceil(n_keys / MIN_KEYS_PER_SPLIT)))


def decode_attention(q, k, v, kv_len: int, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, H, hd]; k, v: [B, Hkv, S, hd]; kv_len: host int -> [B, H, hd]."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return decode_attention_plain(q, k, v, kv_len, window=window,
                                      softcap=softcap, scale=scale)
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("decode_attention: q, k, v must all lie on one "
                         "CUDA device (or all on the CPU)")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("decode_attention: expected q [B,H,hd] and "
                         "k, v [B,Hkv,S,hd]")
    B, H, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % Hkv:
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)} vs "
                         f"{tuple(k.shape)} do not form GQA")
    if H // Hkv not in GROUPS:
        raise ValueError(f"decode_attention: group size {H // Hkv} not in "
                         f"{GROUPS}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention: q, k, v must share one dtype, "
                        f"float32 or bfloat16 (got {q.dtype}, {k.dtype}, "
                        f"{v.dtype})")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    check_layout("decode_attention", q, k, v)
    kv_len = int(kv_len)
    if not 1 <= kv_len <= S:
        raise ValueError(f"decode_attention: kv_len {kv_len} outside "
                         f"[1, {S}]")
    if window is not None and window < 1:
        raise ValueError("decode_attention: window must be >= 1")
    if softcap is not None and softcap <= 0:
        raise ValueError("decode_attention: softcap must be > 0")
    scale = scale if scale is not None else hd ** -0.5
    kv_begin = 0 if window is None else max(0, kv_len - int(window))
    n_keys = kv_len - kv_begin
    n_split = _n_split(q.device, B * Hkv, n_keys)
    chunk = math.ceil(n_keys / n_split)
    n_split = math.ceil(n_keys / chunk)
    out = torch.empty_like(q)
    part_acc = torch.empty((B * H, n_split, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B * H, n_split, 2), dtype=torch.float32,
                          device=q.device)
    rc = _build.library().repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(),
        B, H, Hkv, S, hd, DTYPE_CODES[q.dtype], kv_begin, kv_len, chunk,
        n_split, 0.0 if softcap is None else float(softcap), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
