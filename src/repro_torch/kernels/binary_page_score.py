"""Phase 1 of page-sparse decode: the CUDA kernels' wrappers.

Port of ``repro.kernels.binary_page_score.paged_page_scores`` (see
``csrc/binary_page_score.cu`` for the kernels' design). Both entry points
take what the paged decode kernel takes: per-(slot, kv-head) ROW tables
and per-block valid counts.

``paged_select_pages`` is the serving path's: one launch computes each
page's bound, selects the row's pages and writes the compacted tables that
``repro_torch.kernels.ops.select_pages`` would make of the bounds. Its
plain version is ``repro_torch.kernels.ref.paged_select_pages_ref``.
``paged_page_scores`` computes the bounds alone (plain version
``ref.paged_page_scores_ref``); the serving path no longer calls it. The
ops layer picks between kernel and plain version by tensor device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

NAME = "binary_page_score"
# launches of either CUDA kernel (plain integer; reset it to 0 before a run)
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _scores_fn():
    fn = build.load(NAME).had_page_scores
    fn.argtypes = [_P] * 5 + [_I] * 8 + [_P]
    fn.restype = _I
    return fn


@functools.cache
def _select_fn():
    fn = build.load(NAME).had_page_select
    fn.argtypes = [_P] * 9 + [_I] * 9 + [_P]
    fn.restype = _I
    return fn


def _check_shapes(q_bits, k_pool, tables, counts):
    r, _, w = q_bits.shape
    _, hk, w2, _ = k_pool.shape
    nb = tables.shape[1]
    if not (w == w2 and r % hk == 0 and tables.shape == counts.shape
            == (r, nb)):
        raise ValueError(f"shape mismatch: q {tuple(q_bits.shape)} k_pool "
                         f"{tuple(k_pool.shape)} tables "
                         f"{tuple(tables.shape)} counts "
                         f"{tuple(counts.shape)}")


def paged_page_scores(q_bits: torch.Tensor, k_pool: torch.Tensor,
                      block_tables: torch.Tensor, counts: torch.Tensor, *,
                      d: int) -> torch.Tensor:
    """Launch the bounds-only kernel.

    q_bits [R, G, W] int32 (R = B*Hk rows); k_pool [n_pages, Hk, W, page]
    int32 bit-planes; block_tables / counts [R, nb] int32. Table entries
    outside [0, n_pages) count as 0. Returns [R, nb] int32 upper bounds in
    {-d, ..., d} (-d for a count-0 block).
    """
    global launches
    _check_shapes(q_bits, k_pool, block_tables, counts)
    r, g, w = q_bits.shape
    n_pages, hk, _, page = k_pool.shape
    nb = block_tables.shape[1]
    build.require(q_bits.device, (torch.int32,), q_bits=q_bits,
                  k_pool=k_pool, block_tables=block_tables, counts=counts)
    out = torch.empty((r, nb), dtype=torch.int32, device=q_bits.device)
    stream = torch.cuda.current_stream(q_bits.device).cuda_stream
    err = _scores_fn()(q_bits.data_ptr(), k_pool.data_ptr(),
                       block_tables.data_ptr(), counts.data_ptr(),
                       out.data_ptr(), r, g, w, page, nb, hk, n_pages, d,
                       stream)
    build.check(err, NAME)
    launches += 1
    return out


def paged_select_pages(q_bits: torch.Tensor, k_pool: torch.Tensor,
                       row_tables: torch.Tensor, counts: torch.Tensor,
                       lengths_rows: torch.Tensor, *, d: int, page: int,
                       n_sel: int, scores_out: torch.Tensor | None = None):
    """Launch the fused bounds + selection + compaction kernel.

    q_bits [R, G, W] int32; k_pool [n_pages, Hk, W, page] int32
    bit-planes; row_tables / counts [R, nb] int32 (entries outside
    [0, n_pages) count as 0); lengths_rows [R] int32 valid lengths. n_sel
    (>= 1) is clamped to nb. Returns (tables, counts, logical), each
    [R, n_sel] int32, equal to ``ops.select_pages`` of the bounds: the
    frontier block always, then the best bounds (ties to the lowest
    block), in ascending logical order. scores_out, a [R, nb] int32 tensor,
    receives the bounds when given.
    """
    global launches
    _check_shapes(q_bits, k_pool, row_tables, counts)
    r, g, w = q_bits.shape
    n_pages, hk, _, page2 = k_pool.shape
    nb = row_tables.shape[1]
    if page != page2 or lengths_rows.shape != (r,) or n_sel < 1:
        raise ValueError(f"page {page} (pool {page2}), lengths "
                         f"{tuple(lengths_rows.shape)} for {r} rows, n_sel "
                         f"{n_sel}: need the pool's page size, one length a "
                         f"row and n_sel >= 1")
    n_sel = min(n_sel, nb)
    tensors = dict(q_bits=q_bits, k_pool=k_pool, row_tables=row_tables,
                   counts=counts, lengths_rows=lengths_rows)
    if scores_out is not None:
        if scores_out.shape != (r, nb):
            raise ValueError(f"scores_out must be {(r, nb)}, got "
                             f"{tuple(scores_out.shape)}")
        tensors["scores_out"] = scores_out
    build.require(q_bits.device, (torch.int32,), **tensors)
    # the three outputs are views of one allocation
    out = torch.empty((3, r, n_sel), dtype=torch.int32, device=q_bits.device)
    tables, sel_counts, logical = out.unbind(0)
    stream = torch.cuda.current_stream(q_bits.device).cuda_stream
    err = _select_fn()(
        q_bits.data_ptr(), k_pool.data_ptr(), row_tables.data_ptr(),
        counts.data_ptr(), lengths_rows.data_ptr(), tables.data_ptr(),
        sel_counts.data_ptr(), logical.data_ptr(),
        None if scores_out is None else scores_out.data_ptr(), r, g, w, page,
        nb, hk, n_pages, d, n_sel, stream)
    build.check(err, NAME)
    launches += 1
    return tables, sel_counts, logical
