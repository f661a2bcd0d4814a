"""Architecture configuration.

One frozen dataclass covers every assigned family (dense / moe / ssm /
hybrid / vlm / audio).  Each ``configs/<arch>.py`` instantiates the exact
published numbers; ``smoke()`` derives a tiny same-family config for CPU
tests.  The port runs the dense and ssm families; the other families'
fields are kept so the configs stay field-for-field the reference's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default: d_model // n_heads
    # attention features
    qk_norm: bool = False
    logit_softcap: Optional[float] = None     # final logits (gemma2: 30)
    attn_softcap: Optional[float] = None      # attention logits (gemma2: 50)
    sliding_window: Optional[int] = None      # window for local layers
    local_global_pattern: bool = False        # alternate local/global layers
    rope_theta: float = 1e4
    use_bias: bool = False
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    attn_every: int = 0              # hybrid: shared attn block cadence
    # VLM
    cross_attn_every: int = 0        # cross-attention layer cadence
    n_image_tokens: int = 0          # stub patch-embedding count
    # enc-dec (audio)
    n_enc_layers: int = 0
    n_audio_frames: int = 0          # stub frame-embedding count
    # numerics / training
    norm_eps: float = 1e-6
    optimizer: str = "adamw"         # adamw | adafactor
    remat: str = "full"              # none | dots | full
    # ---- perf-variant knobs (§Perf hillclimb; default = baseline) ----
    attn_explicit_shard: bool = False   # pin q on heads, replicate kv
    moe_ep_shard_map: bool = False      # expert-parallel local dispatch
    attn_bf16_math: bool = False        # bf16 attn matmuls, f32 accumulate
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding tables are padded to a multiple of 256 so the vocab
        axis shards evenly over a 16-way model axis (padded logit columns
        are masked; padded rows are never looked up)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_ssm_layer(self):
        """Per-layer mixer kind: 'ssm' or 'attn'."""
        def kind(layer: int) -> str:
            if self.family == "ssm":
                return "ssm"
            if self.family == "hybrid":
                return "attn" if (self.attn_every and
                                  (layer + 1) % self.attn_every == 0) else "ssm"
            return "attn"
        return kind

    def layer_is_local(self, layer: int) -> bool:
        """Gemma2-style alternation: even layers local (sliding window)."""
        if not self.local_global_pattern:
            return self.sliding_window is not None
        return layer % 2 == 0

    def layer_has_cross_attn(self, layer: int) -> bool:
        return bool(self.cross_attn_every) and \
            (layer + 1) % self.cross_attn_every == 0

    def layer_is_moe(self, layer: int) -> bool:
        return self.n_experts > 0

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        changes: Dict[str, Any] = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
        )
        if self.n_experts:
            changes.update(n_experts=4, top_k=min(self.top_k, 2))
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_head_dim=16)
        if self.attn_every:
            changes.update(attn_every=2)
        if self.cross_attn_every:
            changes.update(cross_attn_every=2, n_image_tokens=8)
        if self.n_enc_layers:
            changes.update(n_enc_layers=2, n_audio_frames=16)
        if self.sliding_window:
            changes.update(sliding_window=16)
        return dataclasses.replace(self, **changes)
