"""Binary score matrix from packed bits: the CUDA kernel's wrapper.

Port of ``repro.kernels.hamming_score.hamming_score`` (see
``csrc/hamming_score.cu`` for the kernel's design), batched and with keys
row-major ([Bt, N, W], the layout ``ops.hamming_scores`` receives), so no
bit-plane copy is made. Its plain version is
``repro_torch.kernels.ref.hamming_score_ref``; the ops layer picks between
the two by tensor device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

NAME = "hamming_score"
# launches of the CUDA kernel (plain integer; reset it to 0 before a run)
launches = 0
METHODS = ("xor", "int8")

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _fn():
    fn = build.load(NAME).had_hamming_score
    fn.argtypes = [_P] * 3 + [_I] * 6 + [_P]
    fn.restype = _I
    return fn


def hamming_score(q_bits: torch.Tensor, k_bits: torch.Tensor, d: int, *,
                  method: str = "xor") -> torch.Tensor:
    """Launch the score-matrix kernel.

    q_bits [Bt, M, W] int32; k_bits [Bt, N, W] int32 (row-major); method
    "xor" (XOR + popcount) or "int8" (+-1 int8 dot products). Returns
    [Bt, M, N] int32 scores d - 2 * ham in {-d, ..., d}.
    """
    global launches
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    bt, m, w = q_bits.shape
    bt2, n, w2 = k_bits.shape
    if not (bt == bt2 and w == w2):
        raise ValueError(f"shape mismatch: q {tuple(q_bits.shape)} k "
                         f"{tuple(k_bits.shape)}")
    build.require(q_bits.device, (torch.int32,), q_bits=q_bits,
                  k_bits=k_bits)
    out = torch.empty((bt, m, n), dtype=torch.int32, device=q_bits.device)
    stream = torch.cuda.current_stream(q_bits.device).cuda_stream
    err = _fn()(q_bits.data_ptr(), k_bits.data_ptr(), out.data_ptr(), bt, m,
                n, w, d, int(method == "int8"), stream)
    build.check(err, NAME)
    launches += 1
    return out
