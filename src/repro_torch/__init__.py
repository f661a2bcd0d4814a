"""repro_torch — the PyTorch/CUDA port of the combining serving stack.

A second package beside ``repro`` (the JAX reference).  It imports torch
and numpy and nothing of JAX or ``repro``: the host-side combining layer
it needs is copied here, module for module, under the reference's module
names.  The model's attention runs through hand-written Hopper kernels
(``kernels/``, sources in ``csrc/``), built with ``nvcc`` at first use.
"""
