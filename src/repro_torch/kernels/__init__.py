"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version:

  flash_attention  — fused causal/windowed/softcap GQA attention forward
                     (csrc/flash_attention.cu)
  decode_attention — flash-decode of one token against a heads-major KV
                     cache, with window and softcap
                     (csrc/decode_attention.cu)

The CUDA sources are built by ``_build.library()`` at first launch.
"""

from .decode_attention import decode_attention, decode_attention_plain
from .flash_attention import flash_attention, flash_attention_plain

__all__ = ["decode_attention", "decode_attention_plain", "flash_attention",
           "flash_attention_plain"]
