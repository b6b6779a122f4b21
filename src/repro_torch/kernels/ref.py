"""Plain PyTorch versions of the ported kernels (twins of the oracles in
``repro.kernels.ref``): the same math with no tiling of the grid, built on
``repro_torch.core``.

Each kernel's plain version takes exactly what its wrapper takes:

  K1 ``prefill_attention_ref``           binary_prefill_attention
  K2 ``paged_decode_attention_rows_ref`` binary_paged_decode_attention
  K3 ``paged_select_pages_ref``          binary_page_score (fused: the
     bounds of ``paged_page_scores_ref``, then ``select_pages``)
  K4 ``decode_attention_ref``            binary_decode_attention
  K5 ``hamming_score_ref``               hamming_score

``paged_decode_attention_ref``, ``page_scores_ref`` and
``paged_sparse_decode_attention_ref`` are the JAX oracles' per-slot
signatures over them. The ops layer runs the plain versions for tensors on
the CPU; on the card they exist only to be compared with the kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import hamming, topn

# Logical key positions per accumulation tile, as in the CUDA kernels.
TILE_KEYS = 64
# Selection score that forces a block in (the frontier) or out (past it).
BIG = (2 ** 31 - 1) // 4


def hamming_score_ref(q_bits: torch.Tensor, k_bits: torch.Tensor,
                      d: int) -> torch.Tensor:
    """q_bits [..., M, W], k_bits [..., N, W] row-major -> [..., M, N]
    int32 scores d - 2 * ham (both of the kernel's methods give these)."""
    return hamming.binary_scores(q_bits, k_bits, d)


def _masked_topn_softmax_av(scores: torch.Tensor, v: torch.Tensor, *, d: int,
                            nsel: int, scale: float | torch.Tensor,
                            valid: torch.Tensor) -> torch.Tensor:
    """scores [..., Q, T] int32, v [..., T, Dv], valid [..., Q, T] ->
    [..., Q, Dv] float32.

    The kernels' arithmetic: kept keys weigh exp(scale * (s - d)) (<= 1,
    so no max is subtracted), and numerator and denominator are summed per
    tile of TILE_KEYS positions, tile after tile. A result so depends only
    on the kept keys at each logical position, never on how many masked
    positions trail them (dense cache, paged rows, compacted page tables).
    """
    keep = topn.topn_mask_binary(scores, nsel, d, valid=valid)
    e = torch.where(keep, torch.exp(scale * (scores - d).to(torch.float32)),
                    0.0)
    v = v.to(torch.float32)
    pad = (-scores.shape[-1]) % TILE_KEYS
    if pad:
        e = F.pad(e, (0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    num = e.new_zeros(e.shape[:-1] + v.shape[-1:])
    den = e.new_zeros(e.shape[:-1] + (1,))
    for t0 in range(0, e.shape[-1], TILE_KEYS):
        et = e[..., t0:t0 + TILE_KEYS]
        num = num + et @ v[..., t0:t0 + TILE_KEYS, :]
        den = den + et.sum(-1, keepdim=True)
    return num / den.clamp_min(1e-30)


def decode_attention_ref(q_bits: torch.Tensor, k_bits: torch.Tensor,
                         v: torch.Tensor, *, d: int, nsel: int,
                         scale: float | torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of the contiguous-cache decode kernel.

    q_bits [BHk, G, W]; k_bits [BHk, T, W] row-major; v [BHk, T, Dv];
    lengths [BHk] int32. Returns [BHk, G, Dv] float32."""
    t = k_bits.shape[1]
    scores = hamming.binary_scores(q_bits, k_bits, d)        # [BHk, G, T]
    pos = torch.arange(t, device=k_bits.device)
    valid = (pos[None, :] < lengths.to(torch.int64)[:, None])[:, None, :]
    valid = torch.broadcast_to(valid, scores.shape)
    return _masked_topn_softmax_av(scores, v, d=d, nsel=nsel, scale=scale,
                                   valid=valid)


def row_tables(block_tables: torch.Tensor, lengths: torch.Tensor, hk: int,
               page: int):
    """Per-slot [B, nb] table + [B] lengths -> per-(slot, kv-head) ROW
    tables [B*Hk, nb] (-1 clamped to 0), per-block valid counts
    [B*Hk, nb], and per-row lengths [B*Hk], all int32."""
    bt = block_tables.to(torch.int32).clamp_min(0)
    b, nb = bt.shape
    bt_rows = torch.repeat_interleave(bt, hk, dim=0)
    len_f = torch.repeat_interleave(lengths.to(torch.int32), hk)
    blocks = torch.arange(nb, dtype=torch.int32, device=bt.device)
    counts = (len_f[:, None] - blocks[None] * page).clamp(0, page)
    return (bt_rows.contiguous(), counts.to(torch.int32).contiguous(),
            len_f)


def _row_pages(k_pool: torch.Tensor, tables: torch.Tensor,
               counts: torch.Tensor):
    """Row tables [R, nb] and counts -> (page ids [R, nb] int64 with
    entries outside [0, n_pages) sent to page 0, kv-head index [R, 1],
    valid [R, nb, page] bool: offset t of listed block i holds a key iff
    t < its count; out-of-range entries count as 0)."""
    n_pages, hk, _, page = k_pool.shape
    r = tables.shape[0]
    ok = (tables >= 0) & (tables < n_pages)
    tbl = torch.where(ok, tables, 0).to(torch.int64)
    cnt = torch.where(ok, counts.clamp(0, page), 0)
    head = (torch.arange(r, device=tables.device) % hk)[:, None]
    offs = torch.arange(page, device=tables.device)
    return tbl, head, offs[None, None] < cnt[..., None]


def paged_decode_attention_rows_ref(q_bits: torch.Tensor,
                                    k_pool: torch.Tensor,
                                    v_pool: torch.Tensor,
                                    tables: torch.Tensor,
                                    counts: torch.Tensor, *, d: int,
                                    nsel: int,
                                    scale: float | torch.Tensor
                                    ) -> torch.Tensor:
    """Plain version of the paged decode kernel, on the kernel's inputs.

    q_bits [R, G, W] (R = B*Hk rows); k_pool [n_pages, Hk, W, page]
    bit-planes; v_pool [n_pages, Hk, page, Dv]; tables / counts [R, nb]
    row tables and valid tokens per listed block. Gathers each row's
    listed pages into logical order (position i*page + t) and defers to
    the masked top-N softmax. Returns [R, G, Dv] float32.
    """
    r, _, w = q_bits.shape
    tbl, head, valid = _row_pages(k_pool, tables, counts)
    t = valid.shape[1] * valid.shape[2]
    k_rows = k_pool[tbl, head].transpose(-1, -2).reshape(r, t, w)
    v_rows = v_pool[tbl, head].reshape(r, t, -1)
    scores = hamming.binary_scores(q_bits, k_rows, d)         # [R, G, T]
    valid = torch.broadcast_to(valid.reshape(r, 1, t), scores.shape)
    return _masked_topn_softmax_av(scores, v_rows, d=d, nsel=nsel,
                                   scale=scale, valid=valid)


def paged_decode_attention_ref(q_bits: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_tables: torch.Tensor, *, d: int,
                               nsel: int, scale: float | torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """Per-slot form of paged_decode_attention_rows_ref (the JAX oracle's
    signature): q_bits [B, Hk, G, W]; block_tables [B, nb]; lengths [B]
    int32. Returns [B, Hk, G, Dv] float32."""
    b, hk, g, w = q_bits.shape
    tables, counts, _ = row_tables(block_tables, lengths, hk,
                                   k_pool.shape[-1])
    out = paged_decode_attention_rows_ref(
        q_bits.reshape(b * hk, g, w), k_pool, v_pool, tables, counts, d=d,
        nsel=nsel, scale=scale)
    return out.reshape(b, hk, g, -1)


def paged_page_scores_ref(q_bits: torch.Tensor, k_pool: torch.Tensor,
                          tables: torch.Tensor, counts: torch.Tensor, *,
                          d: int) -> torch.Tensor:
    """Plain version of the page-score kernel, on the kernel's inputs.

    Unpacks each listed page's valid keys to bits and counts, per bit j,
    the keys with bit j set (cnt_j). Bit j of some valid key can match
    q_j iff (q_j = +1 and cnt_j > 0) or (q_j = -1 and cnt_j < n_valid);
    ub = 2 * #matchable - d, maxed over the group. Only the first d bits
    are unpacked, so tail bits never count.

    q_bits [R, G, W]; k_pool [n_pages, Hk, W, page]; tables / counts
    [R, nb]. Returns [R, nb] int32 (-d for a count-0 block).
    """
    tbl, head, valid = _row_pages(k_pool, tables, counts)
    kg = k_pool[tbl, head].transpose(-1, -2)       # [R, nb, page, W]
    kbit = (hamming.unpack_bits(kg, d) > 0) & valid[..., None]
    cnt = kbit.sum(2)                              # [R, nb, d]
    nv = valid.sum(-1)                             # [R, nb]
    qpos = hamming.unpack_bits(q_bits, d) > 0      # [R, G, d]
    match = torch.where(qpos[:, :, None, :], cnt[:, None] > 0,
                        cnt[:, None] < nv[:, None, :, None])
    ub = 2 * match.sum(-1) - d                     # [R, G, nb]
    return ub.amax(1).to(torch.int32)


def page_scores_ref(q_bits: torch.Tensor, k_pool: torch.Tensor,
                    block_tables: torch.Tensor, *, d: int,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Per-slot form of paged_page_scores_ref (the JAX oracle's
    signature): q_bits [B, Hk, G, W]; block_tables [B, nb]; lengths [B].
    Returns [B, Hk, nb] int32."""
    b, hk, g, w = q_bits.shape
    tables, counts, _ = row_tables(block_tables, lengths, hk,
                                   k_pool.shape[-1])
    out = paged_page_scores_ref(q_bits.reshape(b * hk, g, w), k_pool,
                                tables, counts, d=d)
    return out.reshape(b, hk, -1)


def top_blocks(scores: torch.Tensor, n: int) -> torch.Tensor:
    """Indices [..., n] of the n highest scores along the last axis, ties
    to the lowest index (as ``lax.top_k``; ``torch.topk`` makes no such
    promise): a stable descending sort, cut to n. int64, in rank order."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[..., :n]


def selection_scores(scores: torch.Tensor, lengths: torch.Tensor, *,
                     page: int) -> torch.Tensor:
    """[..., nb] page scores, [...] lengths -> scores with blocks past the
    frontier forced to -BIG and the frontier (the block of token
    lengths-1) forced to +BIG, so it is always selected."""
    nb = scores.shape[-1]
    blocks = torch.arange(nb, dtype=torch.int64, device=scores.device)
    lengths = lengths.to(torch.int64)[..., None]
    frontier = (lengths - 1).clamp_min(0) // page
    s = torch.where(blocks * page < lengths, scores.to(torch.int64), -BIG)
    return torch.where(blocks == frontier, BIG, s)


def select_pages(scores: torch.Tensor, block_tables: torch.Tensor,
                 lengths: torch.Tensor, *, page: int, n_sel: int):
    """Phase-1 -> phase-2 handoff: keep each row's top-n_sel pages, with
    the frontier (tail) page ALWAYS among them.

    scores [R, nb] per-page scores (higher = keep); block_tables [R, nb]
    int32 physical ids; lengths [R] int32 valid context lengths. n_sel is
    clamped to nb. Returns compacted (tables [R, n_sel], counts
    [R, n_sel], logical [R, n_sel]) int32 with blocks in ascending logical
    order, so phase 2 accumulates in the dense walk's order. Blocks past
    the frontier are forced out; any still picked (fewer resident blocks
    than n_sel) keep count 0 and a clamped page id. Ties go to the lowest
    logical block, as ``lax.top_k`` breaks them in the JAX package, so
    tables, counts and logical ids equal JAX's exactly.
    """
    n_sel = min(n_sel, scores.shape[1])
    lengths = lengths.to(torch.int32)
    s = selection_scores(scores, lengths, page=page)
    idx = top_blocks(s, n_sel).sort(dim=1).values      # ascending
    counts = (lengths[:, None] - idx * page).clamp(0, page)
    tables = torch.gather(block_tables.to(torch.int32), 1, idx).clamp_min(0)
    return (tables.contiguous(), counts.to(torch.int32).contiguous(),
            idx.to(torch.int32))


def paged_select_pages_ref(q_bits: torch.Tensor, k_pool: torch.Tensor,
                           row_tables: torch.Tensor, counts: torch.Tensor,
                           lengths_rows: torch.Tensor, *, d: int, page: int,
                           n_sel: int):
    """Plain version of the fused page-select kernel, on the kernel's
    inputs: the bounds of ``paged_page_scores_ref``, then
    ``select_pages``. Returns (tables, counts, logical) [R, min(n_sel, nb)]
    int32."""
    scores = paged_page_scores_ref(q_bits, k_pool, row_tables, counts, d=d)
    return select_pages(scores, row_tables, lengths_rows, page=page,
                        n_sel=n_sel)


def paged_sparse_decode_attention_ref(q_bits: torch.Tensor,
                                      k_pool: torch.Tensor,
                                      v_pool: torch.Tensor,
                                      block_tables: torch.Tensor, *, d: int,
                                      nsel: int,
                                      scale: float | torch.Tensor,
                                      lengths: torch.Tensor,
                                      page_topn: int) -> torch.Tensor:
    """Plain two-phase page-sparse decode (the ops page_topn= path).

    Phase 1: page_scores_ref per (slot, kv-head). Selection: the top
    page_topn pages per row, the frontier forced in and pages past it
    forced out. Phase 2: the paged decode over the FULL table with the
    dropped pages' counts set to 0 -- the kept set the compacted-table
    kernel attends, expressed as a mask instead of a compaction.

    Shapes as paged_decode_attention_ref. Returns [B, Hk, G, Dv] float32.
    """
    b, hk, g, w = q_bits.shape
    page = k_pool.shape[-1]
    nb = block_tables.shape[1]
    tables, counts, len_f = row_tables(block_tables, lengths, hk, page)
    scores = page_scores_ref(q_bits, k_pool, block_tables, d=d,
                             lengths=lengths).reshape(b * hk, nb)
    idx = top_blocks(selection_scores(scores, len_f, page=page),
                     min(page_topn, nb))
    keep = torch.zeros_like(counts, dtype=torch.bool).scatter_(1, idx, True)
    out = paged_decode_attention_rows_ref(
        q_bits.reshape(b * hk, g, w), k_pool, v_pool, tables,
        torch.where(keep, counts, 0), d=d, nsel=nsel, scale=scale)
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
