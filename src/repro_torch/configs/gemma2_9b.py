"""gemma2-9b — dense with local/global alternating attention + softcaps.
[arXiv:2408.00118; hf]  42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000, head_dim=256, window=4096, attn softcap 50, logit softcap 30."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    logit_softcap=30.0,
    attn_softcap=50.0,
    sliding_window=4096,
    local_global_pattern=True,
    tie_embeddings=True,
    notes="even layers sliding-window(4096), odd layers global; "
          "sub-quadratic enough to run long_500k (global KV shards on data)",
)
