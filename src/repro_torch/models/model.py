"""Model assembly, dense and ssm families.

Parameters keep the reference's stacked layout: ``params["blocks"]``
holds every layer's weights on a leading layer axis, so a reference
pytree converts leaf for leaf (``convert.params_from_reference``).  The
layers run as a Python loop over that axis.

Entry points (each takes ``device="cuda"`` unless the caller passes
``device="cpu"``; with no CUDA device and no explicit CPU they raise):
  init_params(cfg, seed, device)                 -> params
  forward(params, cfg, tokens, device)           -> logits [B, S, Vp]
  init_decode_state(cfg, batch, max_len, device) -> DecodeState
  prefill(params, cfg, tokens, device, max_len)  -> (last logits, state)
  decode_step(params, cfg, state, tokens, device)-> (logits, state)

The large matrix products (projections, MLP, unembed) are
``torch.matmul``, as the reference leaves them to XLA; attention and the
SSD scan go through the port's kernels.  Families other than ``dense``
and ``ssm`` raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ..configs.base import ArchConfig
from ..device import resolve
from .attention import KVCache, init_attn_params, layer_window, self_attention
from .layers import dense_init, embed, rms_norm, swiglu, unembed, zeros_init
from .ssm import (SSMState, init_ssm_params, init_ssm_state, ssm_block_decode,
                  ssm_block_prefill, ssm_block_train)

PORTED = ("dense", "ssm")
_LATER = {
    "moe": "ROADMAP.md queue 1, item 9 (MoE, VLM and audio families)",
    "vlm": "ROADMAP.md queue 1, item 9 (MoE, VLM and audio families)",
    "audio": "ROADMAP.md queue 1, item 9 (MoE, VLM and audio families)",
    "hybrid": "ROADMAP.md queue 1, item 8 (hybrid family)",
}


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: "
            f"{_LATER.get(cfg.family, 'unknown family')}")


def _tokens(tokens, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(tokens, dtype=torch.long, device=device)


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unembed_table(params, cfg):
    return params["embed"] if cfg.tie_embeddings else params["unembed"].T


# ===================================================================== #
# Parameter initialization                                              #
# ===================================================================== #
def _init_mlp(gen, cfg, L, dtype):
    D, F = cfg.d_model, cfg.d_ff
    p = {"w_gate": dense_init(gen, (L, D, F), in_axis=1, dtype=dtype),
         "w_up": dense_init(gen, (L, D, F), in_axis=1, dtype=dtype),
         "w_down": dense_init(gen, (L, F, D), in_axis=1, dtype=dtype)}
    if cfg.use_bias:
        dev = gen.device
        p.update(b_gate=zeros_init((L, F), dtype, dev),
                 b_up=zeros_init((L, F), dtype, dev),
                 b_down=zeros_init((L, D), dtype, dev))
    return p


def _init_ssm_block(gen, cfg, L, dtype):
    return {"ln1": zeros_init((L, cfg.d_model), dtype, gen.device),
            "ssm": init_ssm_params(gen, cfg, L, dtype)}


def init_params(cfg: ArchConfig, seed: int, device="cuda",
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """The reference's shapes, stacked [L, ...] layout and distributions
    (embed N(0, 0.01); projections N(0, 1/fan_in); norms and biases
    zero), drawn in f32 from a ``torch.Generator`` seeded with ``seed``
    on ``device`` and cast to ``dtype``.  A torch generator gives other
    numbers than ``jax.random``: parameters held against the reference
    come from ``convert.params_from_reference`` instead."""
    _check_ported(cfg)
    dev = resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    L, D = cfg.n_layers, cfg.d_model
    embed_t = torch.randn((cfg.padded_vocab, D), generator=gen,
                          dtype=torch.float32, device=dev) * 0.01
    params: Dict[str, Any] = {
        "embed": embed_t.to(dtype),
        "final_norm": zeros_init((D,), dtype, dev),
    }
    del embed_t
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (D, cfg.padded_vocab), dtype=dtype)
    if cfg.family == "ssm":
        params["blocks"] = _init_ssm_block(gen, cfg, L, dtype)
        return params
    params["blocks"] = {"ln1": zeros_init((L, D), dtype, dev),
                        "attn": init_attn_params(gen, cfg, L, dtype),
                        "ln2": zeros_init((L, D), dtype, dev),
                        "mlp": _init_mlp(gen, cfg, L, dtype)}
    return params


def param_count(params) -> int:
    def count(t):
        return sum(count(v) for v in t.values()) if isinstance(t, dict) \
            else t.numel()
    return count(params)


# ===================================================================== #
# Blocks                                                                #
# ===================================================================== #
def _mlp_apply(p, x, cfg):
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"],
                  p.get("b_gate"), p.get("b_up"), p.get("b_down"))


def _attn_block(p, x, cfg, i, cache=None, cache_out=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    out, new_cache = self_attention(p["attn"], h, cfg,
                                    window=layer_window(cfg, i),
                                    cache=cache, cache_out=cache_out)
    x = x + out
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _mlp_apply(p["mlp"], h, cfg), new_cache


def _ssm_block(p, x, cfg):
    return x + ssm_block_train(p["ssm"], rms_norm(x, p["ln1"], cfg.norm_eps),
                               cfg)


# ===================================================================== #
# Forward                                                               #
# ===================================================================== #
@torch.no_grad()
def forward(params, cfg: ArchConfig, tokens, device="cuda") -> torch.Tensor:
    """tokens: [B, S] int -> logits [B, S, Vp]."""
    _check_ported(cfg)
    x = embed(_tokens(tokens, resolve(device)), params["embed"])
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        if cfg.family == "ssm":
            x = _ssm_block(p, x, cfg)
        else:
            x, _ = _attn_block(p, x, cfg, i)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, _unembed_table(params, cfg), cfg.logit_softcap,
                   cfg.vocab_size)


# ===================================================================== #
# Prefill / decode                                                      #
# ===================================================================== #
class DecodeState(NamedTuple):
    """Decode state: the dense family's stacked KV cache or the ssm
    family's stacked ``SSMState``, and the shared position, a host int
    (so no step syncs with the card to read it).

    ``decode_step`` updates ``kv`` and ``ssm`` in place: a state passed to
    it shares its storage with the state it returns."""
    kv: Optional[KVCache]    # k, v: [L, B, Hkv, S_max, hd]; length == pos
    pos: int
    ssm: Optional[SSMState] = None   # each field [L, ...]


def _empty_kv(cfg, n: int, batch: int, max_len: int, dtype, device):
    # heads-major cache layout [L, B, Hkv, S, hd] (see attention.KVCache)
    shape = (n, batch, cfg.n_kv_heads, max_len, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device="cuda", dtype=torch.bfloat16) -> DecodeState:
    """A zero state at pos 0 (``max_len`` sizes the dense family's cache;
    the ssm family's state does not grow with the sequence)."""
    _check_ported(cfg)
    dev = resolve(device)
    if cfg.family == "ssm":
        return DecodeState(kv=None, pos=0,
                           ssm=init_ssm_state(cfg, batch, dtype, dev))
    return DecodeState(kv=_empty_kv(cfg, cfg.n_layers, batch, max_len, dtype,
                                    dev), pos=0)


@torch.no_grad()
def prefill(params, cfg: ArchConfig, tokens, device="cuda",
            max_len: Optional[int] = None):
    """Process a full prompt; return (last-position logits [B, Vp], state).

    The dense family's KV cache is allocated at ``max_len`` (default: the
    prompt length) and filled layer by layer, in place of the reference's
    pad-after (``_pad_kv``); the ssm family fills a stacked ``SSMState``
    layer by layer."""
    _check_ported(cfg)
    dev = resolve(device)
    tokens = _tokens(tokens, dev)
    B, S = tokens.shape
    max_len = max_len or S
    if max_len < S:
        raise ValueError(f"max_len {max_len} < prompt length {S}")
    x = embed(tokens, params["embed"])
    if cfg.family == "ssm":
        kv, st = None, init_ssm_state(cfg, B, x.dtype, dev)
        for i in range(cfg.n_layers):
            p = _layer(params["blocks"], i)
            out, s = ssm_block_prefill(
                p["ssm"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg)
            x = x + out
            for stacked, layer in zip(st, s):
                stacked[i].copy_(layer)
    else:
        st, kv = None, _empty_kv(cfg, cfg.n_layers, B, max_len, x.dtype, dev)
        for i in range(cfg.n_layers):
            x, _ = _attn_block(_layer(params["blocks"], i), x, cfg, i,
                               cache_out=KVCache(kv.k[i], kv.v[i], 0))
        kv = KVCache(kv.k, kv.v, S)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(x[:, -1, :], _unembed_table(params, cfg),
                     cfg.logit_softcap, cfg.vocab_size)
    return logits, DecodeState(kv=kv, pos=S, ssm=st)


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, state: DecodeState, tokens,
                device="cuda"):
    """tokens: [B] int -> (logits [B, Vp], new state).  The dense cache is
    written in place at ``state.pos``; the ssm state is updated in
    place."""
    _check_ported(cfg)
    dev = resolve(device)
    ssm = cfg.family == "ssm"
    if not ssm and state.pos >= state.kv.k.shape[3]:
        raise ValueError(f"decode position {state.pos} past the cache "
                         f"({state.kv.k.shape[3]} slots)")
    x = embed(_tokens(tokens, dev)[:, None], params["embed"])
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        if ssm:
            out, _ = ssm_block_decode(
                p["ssm"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                SSMState(*(t[i] for t in state.ssm)))
            x = x + out
        else:
            x, _ = _attn_block(p, x, cfg, i, cache=KVCache(
                state.kv.k[i], state.kv.v[i], state.pos))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(x[:, 0, :], _unembed_table(params, cfg),
                     cfg.logit_softcap, cfg.vocab_size)
    pos = state.pos + 1
    kv = None if ssm else KVCache(state.kv.k, state.kv.v, pos)
    return logits, DecodeState(kv=kv, pos=pos, ssm=state.ssm)
