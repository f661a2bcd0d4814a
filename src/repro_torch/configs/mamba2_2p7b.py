"""mamba2-2.7b — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]  64L d_model=2560 d_ff=0 vocab=50280
ssm_state=128.  Decode carries a recurrent state (no KV cache), so the
long_500k cell is O(1) in context length per step."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,            # attention-free
    n_kv_heads=0,
    d_ff=0,               # no MLP — the Mamba2 mixer is the whole block
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,      # d_inner = 5120 -> 80 ssm heads
    ssm_conv_width=4,
    notes="SSD chunked scan; pure-SSM backbone",
)
