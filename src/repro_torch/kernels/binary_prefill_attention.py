"""Causal HAD prefill attention: the CUDA kernel's wrapper.

Port of ``repro.kernels.binary_prefill_attention.prefill_attention`` (see
``csrc/binary_prefill_attention.cu`` for the kernel's design). Keys arrive
row-major ([BHk, T, W], the layout the serving path gathers its pages
into) rather than as bit-planes. Its plain version is
``repro_torch.kernels.ref.prefill_attention_ref``; the ops layer picks
between the two by tensor device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

NAME = "binary_prefill_attention"
# launches of the CUDA kernel (plain integer; reset it to 0 before a run)
launches = 0
HEAD_DIMS = (16, 32, 64, 128)   # V widths the kernel is instantiated for

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _fn():
    fn = build.load(NAME).had_prefill_attention
    fn.argtypes = [_P] * 7 + [_I] * 9 + [_F, _I, _I, _P]
    fn.restype = _I
    return fn


def prefill_attention(q_bits: torch.Tensor, k_bits: torch.Tensor,
                      v: torch.Tensor, *, d: int, nsel: int, scale: float,
                      kv_length: torch.Tensor, q_offset: torch.Tensor,
                      q_length: torch.Tensor, group_size: int,
                      n_kv_heads: int, causal: bool = True) -> torch.Tensor:
    """Launch the prefill kernel.

    q_bits [BH, S, W] int32, rows in [B, Hk, G] order (query row
    b*Hk*G + hk*G + g reads kv row b*Hk + hk); k_bits [BHk, T, W] int32
    row-major; v [BHk, T, Dv] float32 or bfloat16; kv_length / q_offset /
    q_length [BH] int32. Query rows at or past q_length are zeros.
    Returns [BH, S, Dv] float32.
    """
    global launches
    bh, s, w = q_bits.shape
    bhk, t, w2 = k_bits.shape
    dv = v.shape[-1]
    if not (w == w2 and v.shape[:2] == (bhk, t)
            and bh == bhk * group_size and bhk % n_kv_heads == 0):
        raise ValueError(f"shape mismatch: q {tuple(q_bits.shape)} k "
                         f"{tuple(k_bits.shape)} v {tuple(v.shape)} "
                         f"group {group_size} kv heads {n_kv_heads}")
    if dv not in HEAD_DIMS:
        raise ValueError(f"V width {dv} not in {HEAD_DIMS}")
    build.require(q_bits.device, (torch.int32,), q_bits=q_bits,
                  k_bits=k_bits, kv_length=kv_length, q_offset=q_offset,
                  q_length=q_length)
    for x in (kv_length, q_offset, q_length):
        if x.shape != (bh,):
            raise ValueError(f"per-row vectors must be [{bh}], got "
                             f"{tuple(x.shape)}")
    build.require(q_bits.device, (torch.float32, torch.bfloat16), v=v)
    out = torch.empty((bh, s, dv), dtype=torch.float32, device=q_bits.device)
    stream = torch.cuda.current_stream(q_bits.device).cuda_stream
    err = _fn()(q_bits.data_ptr(), k_bits.data_ptr(), v.data_ptr(),
                kv_length.data_ptr(), q_offset.data_ptr(), q_length.data_ptr(),
                out.data_ptr(), bh, s, w, t, dv, d, group_size, n_kv_heads,
                int(nsel), float(scale), int(causal),
                int(v.dtype == torch.bfloat16), stream)
    build.check(err, NAME)
    launches += 1
    return out
