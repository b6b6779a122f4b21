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

The scratch grows as rows x query tiles x key splits (~1.5 bytes a
(query, key) pair at d = 64), so a long prefill cannot take it in one
launch: 439 GiB at S = T = 32768 over 288 rows. ``split_plan`` caps it at
``SCRATCH_WORDS`` and cuts the call into waves over blocks of rows (whole
GQA groups) and, if one group's tiles are still too many, windows of
query tiles; the waves run one after another on one scratch buffer.
Queries are independent, so a wave gives the bits one launch would. Every
serving shape is one wave, the launch it always was. The waves depend on
shapes only, so a CUDA graph captures them. Each wave counts one launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import TILE_KEYS

NAME = "binary_prefill_attention"
# launches of the CUDA kernel, one a wave (plain integer; reset it to 0
# before a run), and of those the non-causal ones (cross-attention layers'
# chunks)
launches = 0
noncausal_launches = 0
HEAD_DIMS = (16, 32, 64, 80, 128)   # V widths the kernel is built for
QUERY_TILE = 64                 # queries per CTA
# Tiles of TILE_KEYS keys per split of the key axis: one CTA per (query-head
# row, query tile, split). 4 beat 8 on the H100 at the serving shapes
# (chip_smoke.py phase 2 times both). Read at each launch.
SPLIT_TILES = 4
# Most int32 words of scratch one call allocates (2 GiB): the largest
# serving shape, dbrx-132b's 512-query chunk over a 4096-position table
# (192 rows, d 128), takes 1.22 GB in one wave.
SCRATCH_WORDS = 1 << 29

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class SplitPlan(NamedTuple):
    n_qtiles: int         # 64-query tiles per query row
    n_splits: int         # key splits: CTAs per (row, query tile)
    scratch_words: int    # int32 words of the scratch buffer (one wave's)
    wave_rows: int        # query rows a wave: whole GQA groups
    wave_qtiles: int      # query tiles a wave (a window of the chunk)


def split_plan(q_shape, t: int, dv: int, d: int,
               split_tiles: int = SPLIT_TILES,
               group_size: int = 1) -> SplitPlan:
    """Grid, waves and scratch of the split prefill for q [BH, S, W] over
    `t` key positions with V width `dv`: shapes only, never lengths or
    offsets. Per (row, query tile, split) block the scratch holds the
    split's histograms [64, d+1] as uint16 counts, then (after all
    blocks' histograms) its sums [64*Dv + 64] in float32. A call whose
    blocks need more than SCRATCH_WORDS (read at each call) runs in
    waves of `wave_rows` rows (a multiple of `group_size`) by
    `wave_qtiles` query tiles, as even as the budget allows."""
    budget = SCRATCH_WORDS
    bh, s, _ = q_shape
    n_q = -(-s // QUERY_TILE)
    n_s = -(-t // (split_tiles * TILE_KEYS))
    pair_words = n_s * (QUERY_TILE * (d + 1) // 2 + QUERY_TILE * (dv + 1))
    rows, tiles = bh, n_q
    if bh * n_q * pair_words > budget:
        pairs = budget // max(pair_words, 1)
        groups = bh // group_size
        if pairs >= group_size * n_q:
            per_wave = pairs // (group_size * n_q)
            rows = -(-groups // -(-groups // per_wave)) * group_size
        else:
            rows, most = group_size, pairs // group_size
            if most < 1:
                raise ValueError(
                    f"one query tile of a {group_size}-row group over {t} "
                    f"keys needs {group_size * pair_words} scratch words, "
                    f"over the budget of {budget}")
            tiles = -(-n_q // -(-n_q // most))
    return SplitPlan(n_q, n_s, rows * tiles * pair_words, rows, tiles)


def waves(plan: SplitPlan, bh: int, s: int):
    """(r0, r1, s0, s1) of each wave of `plan`, in launch order: query rows
    [r0, r1) by queries [s0, s1)."""
    window = plan.wave_qtiles * QUERY_TILE
    for r0 in range(0, bh, plan.wave_rows):
        for s0 in range(0, s, window):
            yield r0, min(bh, r0 + plan.wave_rows), s0, min(s, s0 + window)


def wave_inputs(q_bits, k_bits, v, kv_length, q_offset, q_length,
                group_size: int, r0: int, r1: int, s0: int, s1: int):
    """The inputs of the wave of rows [r0, r1) and queries [s0, s1), a
    prefill call of its own: q_bits [r1-r0, s1-s0, W], the kv rows
    [r0/G, r1/G) of k_bits and v (read with one kv head, row r reads kv
    row r / G as in the whole call), kv_length, and the window's query
    offset q_offset + s0 and live queries clamp(q_length - s0, 0,
    s1 - s0)."""
    k0, k1 = r0 // group_size, r1 // group_size
    q = q_bits[r0:r1]
    q_off, q_len = q_offset[r0:r1], q_length[r0:r1]
    if s1 - s0 != q_bits.shape[1]:
        q = q[:, s0:s1].contiguous()
        q_off = q_off + s0
        q_len = (q_len - s0).clamp(0, s1 - s0)
    return q, k_bits[k0:k1], v[k0:k1], kv_length[r0:r1], q_off, q_len


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
    Returns [BH, S, Dv] float32. Each wave `split_plan` cuts the call into
    counts one launch.
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
    plan = split_plan(q_bits.shape, t, dv, d, SPLIT_TILES, group_size)
    out = torch.empty((bh, s, dv), dtype=torch.float32, device=q_bits.device)
    scratch = torch.empty(plan.scratch_words, dtype=torch.int32,
                          device=q_bits.device)
    stream = torch.cuda.current_stream(q_bits.device).cuda_stream
    v_bf16 = int(v.dtype == torch.bfloat16)
    one = plan.wave_rows == bh and plan.wave_qtiles == plan.n_qtiles
    for r0, r1, s0, s1 in waves(plan, bh, s):
        q, k, vw, kvl, q_off, q_len = wave_inputs(
            q_bits, k_bits, v, kv_length, q_offset, q_length, group_size,
            r0, r1, s0, s1)
        o = out[r0:r1] if s1 - s0 == s else torch.empty(
            (r1 - r0, s1 - s0, dv), dtype=out.dtype, device=out.device)
        err = _fn()(q.data_ptr(), k.data_ptr(), vw.data_ptr(),
                    kvl.data_ptr(), q_off.data_ptr(), q_len.data_ptr(),
                    o.data_ptr(), scratch.data_ptr(), r1 - r0, s1 - s0, w,
                    t, dv, d, group_size, n_kv_heads if one else 1,
                    int(nsel), float(scale), int(causal), SPLIT_TILES,
                    v_bf16, stream)
        build.check(err, NAME)
        launches += 1
        noncausal_launches += not causal
        if s1 - s0 != s:
            out[r0:r1, s0:s1] = o
    return out
