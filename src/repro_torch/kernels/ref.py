"""Plain PyTorch versions of the ported kernels (twins of the oracles in
``repro.kernels.ref``): the same math with no tiling, built on
``repro_torch.core``.

``prefill_attention_ref`` is the plain version of the prefill kernel and
``paged_decode_attention_ref`` that of the paged decode kernel. The ops
layer runs them for tensors on the CPU; on the card they exist only to be
compared with the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core import hamming, topn


def _masked_topn_softmax_av(scores: torch.Tensor, v: torch.Tensor, *, d: int,
                            nsel: int, scale: float | torch.Tensor,
                            valid: torch.Tensor) -> torch.Tensor:
    """scores [..., Q, T] int32, v [..., T, Dv], valid [..., Q, T] ->
    [..., Q, Dv] float32."""
    keep = topn.topn_mask_binary(scores, nsel, d, valid=valid)
    a = topn.sparse_softmax(scores.to(torch.float32), keep, scale=scale)
    return a @ v.to(torch.float32)


def decode_attention_ref(q_bits: torch.Tensor, k_bits: torch.Tensor,
                         v: torch.Tensor, *, d: int, nsel: int,
                         scale: float | torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q_bits [BHk, G, W]; k_bits [BHk, T, W] row-major; v [BHk, T, Dv];
    lengths [BHk] int32. Returns [BHk, G, Dv] float32."""
    t = k_bits.shape[1]
    scores = hamming.binary_scores(q_bits, k_bits, d)        # [BHk, G, T]
    pos = torch.arange(t, device=k_bits.device)
    valid = (pos[None, :] < lengths.to(torch.int64)[:, None])[:, None, :]
    valid = torch.broadcast_to(valid, scores.shape)
    return _masked_topn_softmax_av(scores, v, d=d, nsel=nsel, scale=scale,
                                   valid=valid)


def gather_rows(k_pool: torch.Tensor, v_pool: torch.Tensor,
                block_tables: torch.Tensor):
    """Gather each slot's pages into contiguous rows.

    k_pool [n_pages, Hk, W, page] bit-planes; v_pool [n_pages, Hk, page, Dv];
    block_tables [B, nb] (-1 entries read page 0; callers mask by length).
    Returns k rows [B, Hk, nb*page, W] row-major and v rows
    [B, Hk, nb*page, Dv].
    """
    bt = block_tables.clamp_min(0).to(torch.int64)
    b, nb = bt.shape
    kg = k_pool[bt]                                # [B, nb, Hk, W, page]
    hk, w, page = kg.shape[2:]
    k_rows = kg.permute(0, 2, 1, 4, 3).reshape(b, hk, nb * page, w)
    vg = v_pool[bt]                                # [B, nb, Hk, page, Dv]
    v_rows = vg.permute(0, 2, 1, 3, 4).reshape(b, hk, nb * page, -1)
    return k_rows, v_rows


def paged_decode_attention_ref(q_bits: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_tables: torch.Tensor, *, d: int,
                               nsel: int, scale: float | torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of the paged decode kernel.

    q_bits [B, Hk, G, W]; k_pool [n_pages, Hk, W, page]; v_pool
    [n_pages, Hk, page, Dv]; block_tables [B, nb]; lengths [B] int32.
    Gathers each slot's pages into the contiguous row-major layout and
    defers to decode_attention_ref. Returns [B, Hk, G, Dv] float32.
    """
    b, hk, g, w = q_bits.shape
    k_rows, v_rows = gather_rows(k_pool, v_pool, block_tables)
    t = k_rows.shape[2]
    lens = lengths.to(torch.int32)[:, None].expand(b, hk).reshape(-1)
    out = decode_attention_ref(q_bits.reshape(b * hk, g, w),
                               k_rows.reshape(b * hk, t, w),
                               v_rows.reshape(b * hk, t, -1), d=d, nsel=nsel,
                               scale=scale, lengths=lens)
    return out.reshape(b, hk, g, -1)


def prefill_attention_ref(q_bits: torch.Tensor, k_bits: torch.Tensor,
                          v: torch.Tensor, *, d: int, nsel: int,
                          scale: float | torch.Tensor,
                          kv_length: torch.Tensor | int,
                          q_offset: torch.Tensor | int, group_size: int,
                          q_length: torch.Tensor | int | None = None,
                          causal: bool = True) -> torch.Tensor:
    """Plain version of the prefill kernel.

    q_bits [BH, S, W]; k_bits [BHk, T, W] row-major; v [BHk, T, Dv].
    kv_length / q_offset / q_length: scalars or [BH] per-query-row values.
    Query rows at or past q_length are zeros. Returns [BH, S, Dv] float32.
    """
    bh, s, _ = q_bits.shape
    t = k_bits.shape[1]
    dev = q_bits.device

    def per_row(x):
        return torch.broadcast_to(torch.as_tensor(x, dtype=torch.int64,
                                                  device=dev), (bh,))

    qoff, kvl = per_row(q_offset), per_row(kv_length)
    qlen = per_row(s if q_length is None else q_length)
    kb = torch.repeat_interleave(k_bits, group_size, dim=0)  # [BH, T, W]
    vg = torch.repeat_interleave(v, group_size, dim=0)
    scores = hamming.binary_scores(q_bits, kb, d)            # [BH, S, T]
    qpos = qoff[:, None, None] + torch.arange(s, device=dev)[None, :, None]
    kpos = torch.arange(t, device=dev)[None, None, :]
    valid = kpos < kvl[:, None, None]
    if causal:
        valid = valid & (kpos <= qpos)
    valid = torch.broadcast_to(valid, scores.shape)
    out = _masked_topn_softmax_av(scores, vg, d=d, nsel=nsel, scale=scale,
                                  valid=valid)
    q_live = torch.arange(s, device=dev)[None, :] < qlen[:, None]
    return torch.where(q_live[:, :, None], out, 0.0)
