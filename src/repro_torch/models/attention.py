"""GQA self-attention for prefill and decode, with sliding window and
attention-logit softcap (gemma2) and per-head qk-norm (qwen3).

Prefill calls ``kernels.flash_attention`` and decode calls
``kernels.decode_attention``.  On the card those launch the CUDA
kernels; on the CPU the same calls reach the kernels' plain versions, so
the CPU tests exercise the plumbing the card runs.  ``cross_attention``
comes with the VLM and audio slice.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ..kernels import decode_attention, flash_attention
from .layers import apply_rope, dense_init, rms_norm, zeros_init

NEG_INF = -2.0 ** 30  # large-negative instead of -inf (avoids NaN in padded rows)
GLOBAL_WINDOW = 1 << 30  # the window of a global layer in a local/global model


class KVCache(NamedTuple):
    """Decode KV cache in [B, n_kv, S_max, hd] layout (heads-major: the
    decode kernel streams it without a transpose).  ``length`` is a host
    int: the tokens currently valid."""
    k: torch.Tensor      # [B, n_kv, S_max, hd]
    v: torch.Tensor      # [B, n_kv, S_max, hd]
    length: int


def _qkv(params: Dict[str, Any], x: torch.Tensor, cfg, positions,
         rope: bool = True):
    """Project x -> (q [B,S,H,hd], k,v [B,S,Hkv,hd]) with optional bias,
    qk-norm and rope."""
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    k = (x @ params["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = (x @ params["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    if cfg.use_bias:
        q = q + params["bq"].reshape(cfg.n_heads, cfg.hd)
        k = k + params["bk"].reshape(cfg.n_kv_heads, cfg.hd)
        v = v + params["bv"].reshape(cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def layer_window(cfg, layer_idx: int) -> Optional[int]:
    """Effective sliding window of a layer: None without one, the window
    for local layers, ``GLOBAL_WINDOW`` for the global layers of a
    local/global alternation (as the reference's jnp.where gives)."""
    if cfg.sliding_window is None:
        return None
    if not cfg.local_global_pattern:
        return cfg.sliding_window
    return cfg.sliding_window if layer_idx % 2 == 0 else GLOBAL_WINDOW


def self_attention(params, x, cfg, *, window: Optional[int] = None,
                   cache: Optional[KVCache] = None,
                   cache_out: Optional[KVCache] = None):
    """Causal self-attention.

    * prefill: ``cache`` is None; x is [B, S, D].  With ``cache_out``
      (a preallocated [B, Hkv, S_max, hd] pair), the sequence's k and v
      are written into its first S positions.
    * decode: ``cache`` given, x is [B, 1, D]; the new token's k and v
      are written into the cache IN PLACE at ``cache.length`` (the
      reference builds a new array with dynamic_update_slice,
      ``repro/models/attention.py:193-196``), and the returned cache is
      the same storage with ``length + 1``.
    """
    B, S, _ = x.shape
    scale = cfg.hd ** -0.5
    if cache is None:
        positions = torch.arange(S, device=x.device)[None, :]
        q, k, v = _qkv(params, x, cfg, positions)
        k_hm = k.transpose(1, 2).contiguous()
        v_hm = v.transpose(1, 2).contiguous()
        out = flash_attention(q.transpose(1, 2).contiguous(), k_hm, v_hm,
                              causal=True, window=window,
                              softcap=cfg.attn_softcap, scale=scale)
        out = out.transpose(1, 2)                       # [B, S, H, hd]
        if cache_out is not None:
            cache_out.k[:, :, :S] = k_hm
            cache_out.v[:, :, :S] = v_hm
        new_cache = None
    else:
        if S != 1:
            raise ValueError("decode takes one token per sequence")
        pos = cache.length
        positions = torch.full((B, 1), pos, dtype=torch.long,
                               device=x.device)
        q, k, v = _qkv(params, x, cfg, positions)
        cache.k[:, :, pos] = k[:, 0]
        cache.v[:, :, pos] = v[:, 0]
        out = decode_attention(q[:, 0].contiguous(), cache.k, cache.v,
                               pos + 1, window=window,
                               softcap=cfg.attn_softcap, scale=scale)
        new_cache = KVCache(cache.k, cache.v, pos + 1)
    out = out.reshape(B, S, cfg.n_heads * cfg.hd) @ params["wo"]
    if cfg.use_bias:
        out = out + params["bo"]
    return out, new_cache


# --------------------------------------------------------------------- #
# Parameter init
# --------------------------------------------------------------------- #
def init_attn_params(gen: torch.Generator, cfg, n_layers: int,
                     dtype=torch.bfloat16) -> Dict[str, Any]:
    """Stacked [n_layers, ...] attention parameters."""
    L, D, H, Hkv, hd = n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = gen.device
    p = {
        "wq": dense_init(gen, (L, D, H * hd), in_axis=1, dtype=dtype),
        "wk": dense_init(gen, (L, D, Hkv * hd), in_axis=1, dtype=dtype),
        "wv": dense_init(gen, (L, D, Hkv * hd), in_axis=1, dtype=dtype),
        "wo": dense_init(gen, (L, H * hd, D), in_axis=1, dtype=dtype),
    }
    if cfg.use_bias:
        p.update(bq=zeros_init((L, H * hd), dtype, dev),
                 bk=zeros_init((L, Hkv * hd), dtype, dev),
                 bv=zeros_init((L, Hkv * hd), dtype, dev),
                 bo=zeros_init((L, D), dtype, dev))
    if cfg.qk_norm:
        p.update(q_norm=zeros_init((L, hd), dtype, dev),
                 k_norm=zeros_init((L, hd), dtype, dev))
    return p
