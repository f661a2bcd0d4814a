"""Mamba2 SSD chunked scan: the hand-written CUDA kernel
(``csrc/ssd_scan.cu``) and its plain PyTorch version.

Replaces ``src/repro/kernels/ssd_scan.py::ssd_scan`` (the Pallas TPU
kernel).  At the serving slice's prefill shape it must move ~150 MB
against ~27 GFLOP, so it is bound by the bytes.  bf16 inputs run on the
tensor cores (``mma.sync.m16n8k16``, f32 accumulators): a first kernel
computes C B^T once per (sequence, chunk) into an f32 scratch that this
wrapper allocates, shared by all heads; then one CTA per (b, h) loops
over its chunks with the f32 state in registers, and each of its other
products keeps the exact bf16 tensor on one side and splits the f32 side
(dt and the decays folded in) into bf16 high and low parts, ~16 bits of
mantissa.  f32 inputs keep an FMA body in full f32.  Both compute the
decay only on and below the diagonal and read steps past L as dt = 0;
the source describes the design.

x: [B, L, H, P]; dt: [B, L, H] f32 (softplus'ed); A: [H] f32 (negative);
Bm, Cm: [B, L, N] in x's dtype -> (y [B, L, H, P] in ``out_dtype``,
final state [B, H, P, N] f32).  Unlike the TPU kernel it returns the
final state (``ssd_chunked_ref`` and ``ref.ssd_ref`` return it too, and
prefill hands it to decode), writes y in ``out_dtype`` (default
``x.dtype``, as the TPU kernel does), and takes any L: steps past the
last chunk boundary are padded with dt = 0.  A CPU tensor goes to
``ssd_scan_plain``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .flash_attention import DTYPE_CODES, check_layout

SHAPES = ((64, 128),)   # (P, N) instantiated in the kernel: mamba2-2.7b
SUB_TILE = 64           # the kernel walks a chunk in sub-tiles of this many steps
MAX_CHUNK = 1024        # keeps the kernel's cumsum array in shared memory


def ssd_scan_plain(x, dt, A, Bm, Cm, *, chunk: int = 128,
                   out_dtype: Optional[torch.dtype] = None):
    """The chunked SSD algorithm of ``repro.models.ssm.ssd_chunked_ref`` in
    f32, with L padded up to a whole number of chunks by steps of dt = 0
    (they neither decay nor add to the state) instead of falling back to
    one chunk."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    out_dtype = out_dtype or x.dtype
    nc = -(-L // chunk)
    pad = nc * chunk - L
    f32 = torch.float32
    xc = x.to(f32) * dt.to(f32)[..., None]                   # [B,L,H,P]
    dA = dt.to(f32) * A.to(f32)                              # [B,L,H]
    Bc, Cc = Bm.to(f32), Cm.to(f32)
    if pad:
        xc = F.pad(xc, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
    xc = xc.reshape(Bsz, nc, chunk, H, P)
    dA = dA.reshape(Bsz, nc, chunk, H)
    Bc = Bc.reshape(Bsz, nc, chunk, N)
    Cc = Cc.reshape(Bsz, nc, chunk, N)
    dA_cs = torch.cumsum(dA, dim=2)                          # [B,nc,cl,H]
    # intra-chunk: exp of the segment sums, -inf above the diagonal
    # before the exp (a 0/1 mask after it would meet inf there)
    cs_h = dA_cs.transpose(2, 3)                             # [B,nc,H,cl]
    seg = cs_h[..., :, None] - cs_h[..., None, :]            # [B,nc,H,cl,cl]
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    Lmat = torch.exp(seg.masked_fill(~causal, float("-inf")))
    att = torch.einsum("bzin,bzjn->bzij", Cc, Bc)            # [B,nc,cl,cl]
    y = torch.einsum("bzhij,bzjhp->bzihp", att[:, :, None] * Lmat, xc)
    # chunk summaries and the inter-chunk recurrence
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)    # [B,nc,cl,H]
    S_chunk = torch.einsum("bzjn,bzjhp->bzhpn", Bc,
                           xc * decay_to_end[..., None])     # [B,nc,H,P,N]
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])              # [B,nc,H]
    s = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
    s_prevs = []
    for z in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, z, :, None, None] + S_chunk[:, z]
    y_inter = torch.einsum("bzin,bzhpn->bzihp", Cc, torch.stack(s_prevs, 1))
    y = y + y_inter * torch.exp(dA_cs)[..., None]
    y = y.reshape(Bsz, nc * chunk, H, P)[:, :L]
    return y.to(out_dtype), s


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128,
             out_dtype: Optional[torch.dtype] = None):
    """x: [B, L, H, P]; dt: [B, L, H] f32; A: [H] f32; Bm, Cm: [B, L, N]
    -> (y [B, L, H, P] in ``out_dtype``, state [B, H, P, N] f32)."""
    tensors = (x, dt, A, Bm, Cm)
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk,
                              out_dtype=out_dtype)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("ssd_scan: x, dt, A, Bm, Cm must all lie on one "
                         "CUDA device (or all on the CPU)")
    if x.dim() != 4:
        raise ValueError("ssd_scan: expected x [B,L,H,P]")
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (Bsz, L, H) or tuple(A.shape) != (H,)
            or Bm.dim() != 3 or tuple(Bm.shape[:2]) != (Bsz, L)
            or Cm.shape != Bm.shape):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} do not "
                         "agree")
    out_dtype = out_dtype or x.dtype
    if (x.dtype not in DTYPE_CODES or Bm.dtype != x.dtype
            or Cm.dtype != x.dtype or dt.dtype != torch.float32
            or A.dtype != torch.float32 or out_dtype not in DTYPE_CODES):
        raise TypeError("ssd_scan: x, Bm, Cm must share one dtype, float32 "
                        "or bfloat16, dt and A must be float32, and "
                        f"out_dtype float32 or bfloat16 (got {x.dtype}, "
                        f"{Bm.dtype}, {Cm.dtype}, {dt.dtype}, {A.dtype}, "
                        f"{out_dtype})")
    if (P, N) not in SHAPES:
        raise ValueError(f"ssd_scan: (head_dim, state) {(P, N)} not in "
                         f"{SHAPES}")
    if chunk < SUB_TILE or chunk % SUB_TILE or chunk > MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} must be a multiple of "
                         f"{SUB_TILE} no larger than {MAX_CHUNK}")
    if Bsz == 0 or L == 0 or H == 0:
        raise ValueError("ssd_scan: empty input")
    check_layout("ssd_scan", *tensors)
    y = torch.empty((Bsz, L, H, P), dtype=out_dtype, device=x.device)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    # bf16: C B^T of every (sequence, chunk), shared by the heads
    cb = (torch.empty((Bsz, -(-L // chunk), chunk, chunk),
                      dtype=torch.float32, device=x.device)
          if x.dtype == torch.bfloat16 else None)
    rc = _build.library().repro_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
        None if cb is None else cb.data_ptr(), Bsz, L, H, P, N,
        int(chunk), DTYPE_CODES[x.dtype], DTYPE_CODES[out_dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
