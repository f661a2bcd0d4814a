"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version:

  flash_attention  — fused causal/windowed/softcap GQA attention forward
                     (csrc/flash_attention.cu)
  decode_attention — flash-decode of one token against a heads-major KV
                     cache, with window and softcap
                     (csrc/decode_attention.cu)
  ssd_scan         — the Mamba2 SSD chunked scan, returning the final
                     state beside y (csrc/ssd_scan.cu)

The CUDA sources are built by ``_build.library()`` at first launch.
"""

from .decode_attention import decode_attention, decode_attention_plain
from .flash_attention import flash_attention, flash_attention_plain
from .ssd_scan import ssd_scan, ssd_scan_plain

__all__ = ["decode_attention", "decode_attention_plain", "flash_attention",
           "flash_attention_plain", "ssd_scan", "ssd_scan_plain"]
