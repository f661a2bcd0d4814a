"""The dense model substrate of the port."""

from .attention import KVCache, layer_window
from .convert import params_from_reference
from .model import (DecodeState, decode_step, forward, init_decode_state,
                    init_params, param_count, prefill)

__all__ = [
    "KVCache", "layer_window", "DecodeState", "decode_step", "forward",
    "init_decode_state", "init_params", "param_count", "params_from_reference",
    "prefill",
]
