"""PyTorch/CUDA port of the HAD serving stack (``repro`` is the JAX
reference it is tested against).

Imports torch and numpy only -- never jax or anything under ``repro``.
Entry points run on the CUDA device unless the caller asks for the CPU;
CUDA tensors go through the hand-written kernels in ``kernels/``, CPU
tensors through their plain PyTorch versions.
"""
