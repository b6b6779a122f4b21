"""HAD decode attention over the paged KV cache: the CUDA kernel's wrapper.

Port of ``repro.kernels.binary_paged_decode_attention.paged_decode_attention``
(see ``csrc/binary_paged_decode_attention.cu`` for the kernel's design).
The signature mirrors the Pallas call: per-(slot, kv-head) ROW block tables
and per-block valid counts, so a compacted table (page-sparse decode) can
reuse the kernel unchanged. Its plain version,
``repro_torch.kernels.ref.paged_decode_attention_rows_ref``, takes the
same tables and counts; the ops layer picks between the two by tensor
device.

The kernel splits each row's key axis into fixed runs of ``SPLIT_TILES``
64-position tiles; ``split_plan`` gives the grid and the scratch size from
tensor shapes alone, so a call never reads a length back from the device.
The contiguous-cache decode kernel (``binary_decode_attention``) runs the
same split launches and takes its plan from here.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import TILE_KEYS

NAME = "binary_paged_decode_attention"
# launches of the CUDA kernel (plain integer; reset it to 0 before a run)
launches = 0

# Tiles of TILE_KEYS positions per split of the key axis: one CTA per (row,
# split). 4 beat 8 on the H100 at the serving shapes (chip_smoke.py phase 2
# times both). Read at each launch, by this kernel and the contiguous-cache
# decode kernel; any value gives the same bits.
SPLIT_TILES = 4

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class SplitPlan(NamedTuple):
    n_splits: int         # S: CTAs per row in launches 1 and 2
    n_tiles: int          # 64-position tiles per row
    scratch_words: int    # int32 words of the kernel's scratch buffer


def split_plan(q_shape, n_pos: int, dv: int, d: int,
               split_tiles: int = SPLIT_TILES) -> SplitPlan:
    """Grid and scratch of the split decode for q [R, G, W] over `n_pos`
    logical positions a row (nb * page for a paged row, T for a dense
    cache row) with V width `dv`: shapes only, never lengths or counts. The
    scratch holds, per row, S histograms [G, d+1], the tile maxima
    [n_tiles] and the least threshold (int32), then the tile sums
    [n_tiles, G*Dv + G] (float32)."""
    r, g, _ = q_shape
    n_tiles = -(-n_pos // TILE_KEYS)
    n_splits = -(-n_tiles // split_tiles)
    words = r * (n_splits * g * (d + 1) + n_tiles + 1
                 + n_tiles * (g * dv + g))
    return SplitPlan(n_splits, n_tiles, words)


@functools.cache
def _fn():
    fn = build.load(NAME).had_paged_decode_attention
    fn.argtypes = [_P] * 7 + [_I] * 10 + [_F, _I, _I, _P]
    fn.restype = _I
    return fn


def paged_decode_attention(q_bits: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           counts: torch.Tensor, *, d: int, nsel: int,
                           scale: float) -> torch.Tensor:
    """Launch the paged decode kernel.

    q_bits [R, G, W] int32 (R = B*Hk rows); k_pool [n_pages, Hk, W, page]
    int32 bit-planes; v_pool [n_pages, Hk, page, Dv] float32 or bfloat16;
    block_tables / counts [R, nb] int32 (row tables, valid tokens per listed
    block). Table entries outside [0, n_pages) are treated as count 0.
    Returns [R, G, Dv] float32.
    """
    global launches
    r, g, w = q_bits.shape
    n_pages, hk, w2, page = k_pool.shape
    _, hk2, page2, dv = v_pool.shape
    nb = block_tables.shape[1]
    if not (w == w2 and hk == hk2 and page == page2
            and v_pool.shape[0] == n_pages and r % hk == 0
            and block_tables.shape == counts.shape == (r, nb)):
        raise ValueError(f"shape mismatch: q {tuple(q_bits.shape)} k_pool "
                         f"{tuple(k_pool.shape)} v_pool {tuple(v_pool.shape)} "
                         f"tables {tuple(block_tables.shape)} counts "
                         f"{tuple(counts.shape)}")
    build.require(q_bits.device, (torch.int32,), q_bits=q_bits,
                  k_pool=k_pool, block_tables=block_tables, counts=counts)
    build.require(q_bits.device, (torch.float32, torch.bfloat16),
                  v_pool=v_pool)
    plan = split_plan(q_bits.shape, nb * page, dv, d, SPLIT_TILES)
    out = torch.empty((r, g, dv), dtype=torch.float32, device=q_bits.device)
    scratch = torch.empty(plan.scratch_words, dtype=torch.int32,
                          device=q_bits.device)
    stream = torch.cuda.current_stream(q_bits.device).cuda_stream
    err = _fn()(q_bits.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_tables.data_ptr(), counts.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), r, g, w, page, dv, nb, hk, n_pages, d,
                int(nsel), float(scale), SPLIT_TILES,
                int(v_pool.dtype == torch.bfloat16), stream)
    build.check(err, NAME)
    launches += 1
    return out
