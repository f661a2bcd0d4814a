"""The model substrate of the port: the dense and ssm families."""

from .attention import KVCache, layer_window
from .convert import params_from_reference
from .model import (DecodeState, decode_step, forward, init_decode_state,
                    init_params, param_count, prefill)
from .ssm import SSMState

__all__ = [
    "KVCache", "layer_window", "DecodeState", "decode_step", "forward",
    "init_decode_state", "init_params", "param_count", "params_from_reference",
    "prefill", "SSMState",
]
