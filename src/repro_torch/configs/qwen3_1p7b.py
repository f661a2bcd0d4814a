"""qwen3-1.7b — small dense, GQA kv=8, qk_norm.  [hf:Qwen/Qwen3-8B; hf]
28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, head_dim=128."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    notes="small dense: TP-16 is past its scaling knee (worst-roofline candidate)",
)
