"""Public wrappers over the HAD attention kernels (torch twin of
``repro.kernels.ops``).

They handle layout (bit-planes vs row-major keys), GQA row flattening and
per-slot -> per-row scalars, and dispatch by the DEVICE OF THE TENSORS:
CUDA tensors launch the hand-written kernel (a failed build or launch
raises; nothing falls back), CPU tensors run the kernel's plain version
from ``repro_torch.kernels.ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import binary_paged_decode_attention as _pdec
from repro_torch.kernels import binary_prefill_attention as _pre
from repro_torch.kernels import ref


def to_bitplanes(k_bits: torch.Tensor) -> torch.Tensor:
    """Row-major packed bits [..., T, W] <-> bit-plane layout [..., W, T]."""
    return k_bits.transpose(-1, -2)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel source name."""
    return {_pre.NAME: _pre.launches, _pdec.NAME: _pdec.launches}


def reset_launch_counts() -> None:
    _pre.launches = 0
    _pdec.launches = 0


def _per_slot(x, b: int, device) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(x, dtype=torch.int32,
                                              device=device), (b,))


def _row_tables(block_tables: torch.Tensor, lengths: torch.Tensor, hk: int,
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


def paged_decode_attention(q_bits: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor, *,
                           d: int, nsel: int, scale: float,
                           lengths: torch.Tensor,
                           page_topn: int | None = None) -> torch.Tensor:
    """HAD decode attention for one new token against paged K/V pools.

    q_bits [B, H, W] int32; k_pool [n_pages, Hk, W, page]; v_pool
    [n_pages, Hk, page, Dv]; block_tables [B, nb] int32 (-1 entries past a
    row's length are clamped -- per-block counts mask them); lengths [B]
    int32 valid cache lengths. Returns [B, H, Dv] float32.
    """
    if page_topn is not None:
        raise NotImplementedError(
            "page-sparse decode (page_topn) is not ported yet: ROADMAP "
            "queue 1 item 6 and kernel K3 (binary_page_score)")
    b, h, w = q_bits.shape
    _, hk, _, page = k_pool.shape
    g = h // hk
    qf = q_bits.reshape(b, hk, g, w)
    lengths = _per_slot(lengths, b, q_bits.device)
    if not q_bits.is_cuda:
        out = ref.paged_decode_attention_ref(
            qf, k_pool, v_pool, block_tables, d=d, nsel=nsel, scale=scale,
            lengths=lengths)
        return out.reshape(b, h, -1)
    bt_rows, counts, _ = _row_tables(block_tables, lengths, hk, page)
    out = _pdec.paged_decode_attention(
        qf.reshape(b * hk, g, w).contiguous(), k_pool, v_pool, bt_rows,
        counts, d=d, nsel=nsel, scale=scale)
    return out.reshape(b, h, -1)


def prefill_attention(q_bits: torch.Tensor, k_bits: torch.Tensor,
                      v: torch.Tensor, *, d: int, nsel: int, scale: float,
                      kv_length, q_offset=0, q_length=None,
                      causal: bool = True) -> torch.Tensor:
    """HAD prefill attention over a query chunk.

    q_bits [B, H, S, W] int32; k_bits [B, Hk, T, W] int32 row-major;
    v [B, Hk, T, Dv]. kv_length / q_offset / q_length are scalars or [B]
    int32 per-slot values (q_length: valid queries of a padded chunk; rows
    past it are zeros). Returns [B, H, S, Dv] float32.
    """
    b, h, s, w = q_bits.shape
    _, hk, t, _ = k_bits.shape
    g = h // hk
    dv = v.shape[-1]
    dev = q_bits.device
    kv_len = torch.repeat_interleave(_per_slot(kv_length, b, dev), h)
    q_off = torch.repeat_interleave(_per_slot(q_offset, b, dev), h)
    q_len = torch.repeat_interleave(
        _per_slot(s if q_length is None else q_length, b, dev), h)
    qf = q_bits.reshape(b * h, s, w)
    kf = k_bits.reshape(b * hk, t, w)
    vf = v.reshape(b * hk, t, dv)
    if not q_bits.is_cuda:
        out = ref.prefill_attention_ref(
            qf, kf, vf, d=d, nsel=nsel, scale=scale, kv_length=kv_len,
            q_offset=q_off, group_size=g, q_length=q_len, causal=causal)
    else:
        out = _pre.prefill_attention(
            qf.contiguous(), kf.contiguous(), vf.contiguous(), d=d,
            nsel=nsel, scale=scale, kv_length=kv_len.contiguous(),
            q_offset=q_off.contiguous(), q_length=q_len.contiguous(),
            group_size=g, n_kv_heads=hk, causal=causal)
    return out.reshape(b, h, s, dv)
