"""Mamba2 mixer: the SSD (state-space duality) chunked scan for training
and prefill, the per-token recurrence for decode (arXiv:2405.21060).

Train and prefill call ``kernels.ssd_scan`` with ``out_dtype=float32``
and ``chunk=128``: on the card that launches the CUDA kernel, on the CPU
it runs the kernel's plain version.  Decode is the O(1) per-token
recurrence in PyTorch ops, as in the reference, which has no kernel for
it.  Each function rounds where ``repro.models.ssm`` rounds.

Projections are separate (z, x, B, C, dt), as in the reference.  Layout
(ngroups = 1):
  x_ssm: [B, L, H, P]   (H ssm heads, P = ssm_head_dim)
  B_ssm, C_ssm: [B, L, N]  (N = ssm_state)
  dt: [B, L, H]  (softplus-activated step size, f32)
  A: [H]  (negative reals: A = -exp(A_log), f32)
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ssd_scan
from .layers import dense_init, rms_norm, zeros_init

CHUNK = 128


class SSMState(NamedTuple):
    """Decode state of one layer, or of every layer on a leading axis."""
    conv_x: torch.Tensor  # [B, W-1, d_inner] rolling conv windows (raw)
    conv_b: torch.Tensor  # [B, W-1, N]
    conv_c: torch.Tensor  # [B, W-1, N]
    ssm: torch.Tensor     # [B, H, P, N] recurrent state, f32


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads


def init_ssm_params(gen: torch.Generator, cfg, n_layers: int,
                    dtype=torch.bfloat16) -> Dict[str, Any]:
    """Every layer's mixer weights, stacked on a leading layer axis, with
    the reference's shapes and distributions: projections and conv
    kernels N(0, 1/fan_in), conv biases and the norm zero, and the f32
    leaves ``A_log`` = 0, ``D`` = 1, ``dt_bias`` = 0."""
    L, D = n_layers, cfg.d_model
    d_inner, H = _dims(cfg)
    N, W = cfg.ssm_state, cfg.ssm_conv_width
    dev = gen.device

    def w(*shape):
        return dense_init(gen, (L, *shape), in_axis=1, dtype=dtype)
    f32 = torch.float32
    return {
        "wz": w(D, d_inner),
        "wx": w(D, d_inner),
        "wB": w(D, N),
        "wC": w(D, N),
        "wdt": w(D, H),
        "conv_x": w(W, d_inner),
        "conv_x_b": zeros_init((L, d_inner), dtype, dev),
        "conv_B": w(W, N),
        "conv_B_b": zeros_init((L, N), dtype, dev),
        "conv_C": w(W, N),
        "conv_C_b": zeros_init((L, N), dtype, dev),
        "A_log": zeros_init((L, H), f32, dev),
        "D": torch.ones((L, H), dtype=f32, device=dev),
        "dt_bias": zeros_init((L, H), f32, dev),
        "norm": zeros_init((L, d_inner), dtype, dev),
        "out_proj": w(d_inner, D),
    }


def _conv_train(xs, w, b):
    """Causal depthwise conv over time; xs: [B, L, C], w: [W, C]."""
    W = w.shape[0]
    pad = F.pad(xs, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + xs.shape[1], :] * w[i] for i in range(W))
    return F.silu(out + b)


def _project(params, x):
    """x: [B, L, D] -> z, xs_raw, B_raw, C_raw, dt_raw (pre-conv)."""
    return (x @ params["wz"], x @ params["wx"], x @ params["wB"],
            x @ params["wC"], x @ params["wdt"])


def _ssd_inputs(params, xs_c, dt_raw, cfg, Bsz, L):
    d_inner, H = _dims(cfg)
    xs = xs_c.reshape(Bsz, L, H, cfg.ssm_head_dim)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    return xs, dt, A


def _mix_out(params, y, xs, z, cfg, Bsz, L):
    d_inner, _ = _dims(cfg)
    y = y + params["D"][None, None, :, None] * xs.float()
    y = y.reshape(Bsz, L, d_inner).to(z.dtype)
    y = rms_norm(y, params["norm"], cfg.norm_eps) * F.silu(z)
    return y @ params["out_proj"]


def _mixer(params, x, cfg):
    """The chunked scan over a sequence: (out, raw projections, final
    ssm state)."""
    Bsz, L, _ = x.shape
    z, xs_raw, B_raw, C_raw, dt_raw = _project(params, x)
    xs_c = _conv_train(xs_raw, params["conv_x"], params["conv_x_b"])
    Bm = _conv_train(B_raw, params["conv_B"], params["conv_B_b"])
    Cm = _conv_train(C_raw, params["conv_C"], params["conv_C_b"])
    xs, dt, A = _ssd_inputs(params, xs_c, dt_raw, cfg, Bsz, L)
    y, s_final = ssd_scan(xs, dt, A, Bm, Cm, chunk=CHUNK,
                          out_dtype=torch.float32)
    return _mix_out(params, y, xs, z, cfg, Bsz, L), (xs_raw, B_raw, C_raw), \
        s_final


def ssm_block_train(params, x, cfg):
    """Full Mamba2 mixer over a sequence.  x: [B, L, D] -> [B, L, D]."""
    out, _, _ = _mixer(params, x, cfg)
    return out


def _window(raw, W: int):
    """The last W - 1 raw rows of a sequence.  A prompt shorter than
    W - 1 is front-filled with zeros, the values ``_conv_train``'s own
    padding gives those positions (the reference slices with a negative
    start there and its decode then raises)."""
    return F.pad(raw, (0, 0, W - 1, 0))[:, -(W - 1):, :]


def ssm_block_prefill(params, x, cfg):
    """Like train but also returns the decode ``SSMState``."""
    W = cfg.ssm_conv_width
    out, (xs_raw, B_raw, C_raw), s_final = _mixer(params, x, cfg)
    return out, SSMState(conv_x=_window(xs_raw, W), conv_b=_window(B_raw, W),
                         conv_c=_window(C_raw, W), ssm=s_final)


def init_ssm_state(cfg, batch: int, dtype=torch.bfloat16,
                   device=None) -> SSMState:
    """Every layer's zero state, stacked on a leading layer axis."""
    d_inner, H = _dims(cfg)
    L, W, N = cfg.n_layers, cfg.ssm_conv_width, cfg.ssm_state
    return SSMState(
        conv_x=torch.zeros((L, batch, W - 1, d_inner), dtype=dtype,
                           device=device),
        conv_b=torch.zeros((L, batch, W - 1, N), dtype=dtype, device=device),
        conv_c=torch.zeros((L, batch, W - 1, N), dtype=dtype, device=device),
        ssm=torch.zeros((L, batch, H, cfg.ssm_head_dim, N),
                        dtype=torch.float32, device=device),
    )


def _conv_step(window, w, b):
    """window: [B, W, C] (raw inputs incl. current) -> [B, C] f32."""
    out = torch.einsum("bwc,wc->bc", window.float(), w.float())
    return F.silu(out + b.float())


def ssm_block_decode(params, x, cfg, state: SSMState):
    """One-token recurrence.  x: [B, 1, D] -> ([B, 1, D], state).

    The state is updated in place, like the dense KV cache: the returned
    state is ``state`` itself, holding the new windows and ssm state."""
    d_inner, H = _dims(cfg)
    Bsz = x.shape[0]
    z, xs_raw, B_raw, C_raw, dt_raw = _project(params, x)
    win_x = torch.cat([state.conv_x, xs_raw], dim=1)
    win_b = torch.cat([state.conv_b, B_raw], dim=1)
    win_c = torch.cat([state.conv_c, C_raw], dim=1)
    xs = _conv_step(win_x, params["conv_x"], params["conv_x_b"])
    Bm = _conv_step(win_b, params["conv_B"], params["conv_B_b"])
    Cm = _conv_step(win_c, params["conv_C"], params["conv_C_b"])
    xs = xs.reshape(Bsz, H, cfg.ssm_head_dim)
    dt1 = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt1 * A)                                   # [B,H]
    dx = xs * dt1[..., None]
    s = state.ssm
    s.mul_(a[..., None, None]).add_(Bm[:, None, None, :] * dx[..., None])
    y = torch.einsum("bn,bhpn->bhp", Cm, s)
    y = y + params["D"][None, :, None] * xs
    y = y.reshape(Bsz, 1, d_inner).to(x.dtype)
    y = rms_norm(y, params["norm"], cfg.norm_eps) * F.silu(z)
    state.conv_x.copy_(win_x[:, 1:])
    state.conv_b.copy_(win_b[:, 1:])
    state.conv_c.copy_(win_c[:, 1:])
    return y @ params["out_proj"], state
