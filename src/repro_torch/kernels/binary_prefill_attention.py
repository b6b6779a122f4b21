"""Causal HAD prefill attention: the CUDA kernel's wrapper.

Port of ``repro.kernels.binary_prefill_attention.prefill_attention`` (see
``csrc/binary_prefill_attention.cu`` for the kernel's design). Keys arrive
row-major ([BHk, T, W], the layout the serving path gathers its pages
into) rather than as bit-planes. Its plain version is
``repro_torch.kernels.ref.prefill_attention_ref``; the ops layer picks
between the two by tensor device.

The kernel splits the key axis into fixed runs of ``SPLIT_TILES`` 64-key
tiles and each query row's chunk into 64-query tiles; ``split_plan`` gives
the grid and the scratch size from tensor shapes alone, so a call never
reads a length back from the device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import TILE_KEYS

NAME = "binary_prefill_attention"
# launches of the CUDA kernel (plain integer; reset it to 0 before a run),
# and of those the non-causal ones (cross-attention layers' chunks)
launches = 0
noncausal_launches = 0
HEAD_DIMS = (16, 32, 64, 128)   # V widths the kernel is instantiated for
QUERY_TILE = 64                 # queries per CTA
# Tiles of TILE_KEYS keys per split of the key axis: one CTA per (query-head
# row, query tile, split). 4 beat 8 on the H100 at the serving shapes
# (chip_smoke.py phase 2 times both). Read at each launch.
SPLIT_TILES = 4

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class SplitPlan(NamedTuple):
    n_qtiles: int         # 64-query tiles per query row
    n_splits: int         # key splits: CTAs per (row, query tile)
    scratch_words: int    # int32 words of the kernel's scratch buffer


def split_plan(q_shape, t: int, dv: int, d: int,
               split_tiles: int = SPLIT_TILES) -> SplitPlan:
    """Grid and scratch of the split prefill for q [BH, S, W] over `t` key
    positions with V width `dv`: shapes only, never lengths or offsets.
    Per (row, query tile, split) block the scratch holds the split's
    histograms [64, d+1] as uint16 counts, then (after all blocks'
    histograms) its sums [64*Dv + 64] in float32."""
    bh, s, _ = q_shape
    n_q = -(-s // QUERY_TILE)
    n_s = -(-t // (split_tiles * TILE_KEYS))
    blocks = bh * n_q * n_s
    words = blocks * (QUERY_TILE * (d + 1) // 2 + QUERY_TILE * (dv + 1))
    return SplitPlan(n_q, n_s, words)


@functools.cache
def _fn():
    fn = build.load(NAME).had_prefill_attention
    fn.argtypes = [_P] * 8 + [_I] * 9 + [_F, _I, _I, _I, _P]
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
    global launches, noncausal_launches
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
    if v.data_ptr() % 16:
        raise ValueError("v must start on a 16-byte boundary (the kernel "
                         "loads V rows 16 bytes at a time)")
    plan = split_plan(q_bits.shape, t, dv, d, SPLIT_TILES)
    out = torch.empty((bh, s, dv), dtype=torch.float32, device=q_bits.device)
    scratch = torch.empty(plan.scratch_words, dtype=torch.int32,
                          device=q_bits.device)
    stream = torch.cuda.current_stream(q_bits.device).cuda_stream
    err = _fn()(q_bits.data_ptr(), k_bits.data_ptr(), v.data_ptr(),
                kv_length.data_ptr(), q_offset.data_ptr(), q_length.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), bh, s, w, t, dv, d,
                group_size, n_kv_heads, int(nsel), float(scale), int(causal),
                SPLIT_TILES, int(v.dtype == torch.bfloat16), stream)
    build.check(err, NAME)
    launches += 1
    noncausal_launches += not causal
    return out
