"""HAD decode attention over a contiguous (dense) KV cache: the CUDA
kernel's wrapper.

Port of ``repro.kernels.binary_decode_attention.decode_attention`` (see
``csrc/binary_decode_attention.cu`` for the kernel's design; it runs the
paged decode kernel's split launches, and takes their plan,
``binary_paged_decode_attention.split_plan``, with T positions a row).
Keys arrive as bit-planes [BHk, W, T], the dense cache's own layout. Its
plain version is ``repro_torch.kernels.ref.decode_attention_ref``; the ops
layer picks between the two by tensor device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import binary_paged_decode_attention as pdec
from repro_torch.kernels import build

NAME = "binary_decode_attention"
# launches of the CUDA kernel (plain integer; reset it to 0 before a run),
# and of those the ones a caller tagged `cross` (cross-attention layers)
launches = 0
cross_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _fn():
    fn = build.load(NAME).had_decode_attention
    fn.argtypes = [_P] * 6 + [_I] * 7 + [_F, _I, _I, _P]
    fn.restype = _I
    return fn


def decode_attention(q_bits: torch.Tensor, k_bits: torch.Tensor,
                     v: torch.Tensor, lengths: torch.Tensor, *, d: int,
                     nsel: int, scale: float,
                     cross: bool = False) -> torch.Tensor:
    """Launch the contiguous-cache decode kernel.

    q_bits [R, G, W] int32 (R = B*Hk rows); k_bits [R, W, T] int32
    bit-planes; v [R, T, Dv] float32 or bfloat16; lengths [R] int32 valid
    keys per row (positions at or past it are ignored). The key axis is cut
    into runs of the paged kernel's SPLIT_TILES. `cross` only tags the
    launch for `cross_launches`. Returns [R, G, Dv] float32.
    """
    global launches, cross_launches
    r, g, w = q_bits.shape
    r2, w2, t = k_bits.shape
    dv = v.shape[-1]
    if not (r2 == r and w2 == w and v.shape[:2] == (r, t)
            and lengths.shape == (r,)):
        raise ValueError(f"shape mismatch: q {tuple(q_bits.shape)} k "
                         f"{tuple(k_bits.shape)} v {tuple(v.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    build.require(q_bits.device, (torch.int32,), q_bits=q_bits,
                  k_bits=k_bits, lengths=lengths)
    build.require(q_bits.device, (torch.float32, torch.bfloat16), v=v)
    plan = pdec.split_plan(q_bits.shape, t, dv, d, pdec.SPLIT_TILES)
    out = torch.empty((r, g, dv), dtype=torch.float32, device=q_bits.device)
    scratch = torch.empty(plan.scratch_words, dtype=torch.int32,
                          device=q_bits.device)
    stream = torch.cuda.current_stream(q_bits.device).cuda_stream
    err = _fn()(q_bits.data_ptr(), k_bits.data_ptr(), v.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(), r, g,
                w, t, dv, d, int(nsel), float(scale), pdec.SPLIT_TILES,
                int(v.dtype == torch.bfloat16), stream)
    build.check(err, NAME)
    launches += 1
    cross_launches += cross
    return out
