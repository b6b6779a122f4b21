"""Phase-1 page scores of page-sparse decode: the CUDA kernel's wrapper.

Port of ``repro.kernels.binary_page_score.paged_page_scores`` (see
``csrc/binary_page_score.cu`` for the kernel's design). It takes what the
paged decode kernel takes: per-(slot, kv-head) ROW tables and per-block
valid counts. Its plain version is
``repro_torch.kernels.ref.paged_page_scores_ref``; the ops layer picks
between the two by tensor device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

NAME = "binary_page_score"
# launches of the CUDA kernel (plain integer; reset it to 0 before a run)
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _fn():
    fn = build.load(NAME).had_page_scores
    fn.argtypes = [_P] * 5 + [_I] * 8 + [_P]
    fn.restype = _I
    return fn


def paged_page_scores(q_bits: torch.Tensor, k_pool: torch.Tensor,
                      block_tables: torch.Tensor, counts: torch.Tensor, *,
                      d: int) -> torch.Tensor:
    """Launch the page-score kernel.

    q_bits [R, G, W] int32 (R = B*Hk rows); k_pool [n_pages, Hk, W, page]
    int32 bit-planes; block_tables / counts [R, nb] int32. Table entries
    outside [0, n_pages) count as 0. Returns [R, nb] int32 upper bounds in
    {-d, ..., d} (-d for a count-0 block).
    """
    global launches
    r, g, w = q_bits.shape
    n_pages, hk, w2, page = k_pool.shape
    nb = block_tables.shape[1]
    if not (w == w2 and r % hk == 0
            and block_tables.shape == counts.shape == (r, nb)):
        raise ValueError(f"shape mismatch: q {tuple(q_bits.shape)} k_pool "
                         f"{tuple(k_pool.shape)} tables "
                         f"{tuple(block_tables.shape)} counts "
                         f"{tuple(counts.shape)}")
    build.require(q_bits.device, (torch.int32,), q_bits=q_bits,
                  k_pool=k_pool, block_tables=block_tables, counts=counts)
    out = torch.empty((r, nb), dtype=torch.int32, device=q_bits.device)
    stream = torch.cuda.current_stream(q_bits.device).cuda_stream
    err = _fn()(q_bits.data_ptr(), k_pool.data_ptr(), block_tables.data_ptr(),
                counts.data_ptr(), out.data_ptr(), r, g, w, page, nb, hk,
                n_pages, d, stream)
    build.check(err, NAME)
    launches += 1
    return out
