"""Public wrappers over the HAD kernels (torch twin of
``repro.kernels.ops``).

They handle layout (bit-planes vs row-major keys), GQA row flattening,
per-slot -> per-row tables and scalars, and page selection, and dispatch
by the DEVICE OF THE TENSORS: CUDA tensors launch the hand-written kernel
(a failed build or launch raises; nothing falls back), CPU tensors run the
kernel's plain version from ``repro_torch.kernels.ref`` on the same
inputs. Each entry reports its kernel's work through ``kernels.cost``
from shapes and lengths, so a counted step gives the same flops and bytes
on either device.

Meta tensors (the dry run's production-mesh count, which builds the step
without storage) get empty outputs of the right shape and dtype, and the
work of a fully valid call, from shapes alone, since no length can be
read: a decode over every position of the cache but a dense
self-attention cache's last, its trash position (every position of a
cross cache); a causal prefill of a whole prompt from position 0 (kv
length = queries = the chunk), a non-causal one of every query over every
key; every listed page full. Those are the dry run's cells: whole
prompts, decode at position seq_len - 1.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import binary_decode_attention as _dec
from repro_torch.kernels import binary_page_score as _pscore
from repro_torch.kernels import binary_paged_decode_attention as _pdec
from repro_torch.kernels import binary_prefill_attention as _pre
from repro_torch.kernels import cost as _cost
from repro_torch.kernels import hamming_score as _hs
from repro_torch.kernels import ref
from repro_torch.kernels.ref import row_tables as _row_tables
from repro_torch.kernels.ref import select_pages  # noqa: F401 (public)

_KERNELS = (_pre, _pdec, _pscore, _dec, _hs)
# counters that split a kernel's launches by the caller's kind, as
# "<kernel name>.<counter>"
_SPLITS = ((_pre, "noncausal_launches"), (_dec, "cross_launches"))


def to_bitplanes(k_bits: torch.Tensor) -> torch.Tensor:
    """Row-major packed bits [..., T, W] <-> bit-plane layout [..., W, T]."""
    return k_bits.transpose(-1, -2)


def launch_counts(splits: bool = False) -> dict[str, int]:
    """Kernel launches since the last reset, by kernel source name; with
    `splits`, also the split counters ("binary_prefill_attention.
    noncausal_launches", "binary_decode_attention.cross_launches")."""
    out = {k.NAME: k.launches for k in _KERNELS}
    if splits:
        out.update({f"{k.NAME}.{a}": getattr(k, a) for k, a in _SPLITS})
    return out


def reset_launch_counts(counts: dict[str, int] | None = None) -> None:
    """Set every kernel's launch count and split counter to 0, or to
    `counts` (by name; a split counter it lacks is left as it is)."""
    for k in _KERNELS:
        k.launches = 0 if counts is None else counts[k.NAME]
    for k, a in _SPLITS:
        setattr(k, a, 0 if counts is None
                else counts.get(f"{k.NAME}.{a}", getattr(k, a)))


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add `counts` (by name, split counters included) to the launch
    counts: the launches a CUDA graph replay makes, which no wrapper
    counts."""
    for k in _KERNELS:
        k.launches += counts.get(k.NAME, 0)
    for k, a in _SPLITS:
        setattr(k, a, getattr(k, a) + counts.get(f"{k.NAME}.{a}", 0))


def _per_slot(x, b: int, device) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(x, dtype=torch.int32,
                                              device=device), (b,))


def hamming_scores(q_bits: torch.Tensor, k_bits: torch.Tensor, d: int, *,
                   method: str = "xor") -> torch.Tensor:
    """Binary scores for row-major packed bits with arbitrary leading dims.

    q_bits [..., M, W]; k_bits [..., N, W] int32 -> [..., M, N] int32.
    method "xor" or "int8" selects the kernel's arithmetic on the card; the
    integers are the same either way, and on the CPU both are the plain
    version's.
    """
    if method not in _hs.METHODS:
        raise ValueError(f"method must be one of {_hs.METHODS}, got "
                         f"{method!r}")
    lead = q_bits.shape[:-2]
    m, w = q_bits.shape[-2:]
    n = k_bits.shape[-2]
    qf = q_bits.reshape(-1, m, w)
    kf = k_bits.reshape(-1, n, w)
    with _cost.kernel(_hs.NAME, lambda: _cost.k5_work(
            batch=qf.shape[0], m=m, n=n, w=w)):
        if q_bits.is_meta:
            out = qf.new_empty((qf.shape[0], m, n))
        elif not q_bits.is_cuda:
            out = ref.hamming_score_ref(qf, kf, d)
        else:
            out = _hs.hamming_score(qf.contiguous(), kf.contiguous(), d,
                                    method=method)
    return out.reshape(*lead, m, n)


def decode_attention(q_bits: torch.Tensor, k_bits: torch.Tensor,
                     v: torch.Tensor, *, d: int, nsel: int, scale: float,
                     lengths, bitplanes: bool = False,
                     cross: bool = False) -> torch.Tensor:
    """HAD decode attention for one new token over a contiguous cache.

    q_bits [B, H, W] int32; k_bits [B, Hk, T, W] row-major, or
    [B, Hk, W, T] when bitplanes=True (the dense cache's layout); v
    [B, Hk, T, Dv]; lengths scalar or [B] int32 valid cache lengths;
    cross tags a cross-attention layer's launch (the kernel's
    `cross_launches`). Returns [B, H, Dv] float32.
    """
    b, h, w = q_bits.shape
    hk = k_bits.shape[1]
    t = k_bits.shape[-1] if bitplanes else k_bits.shape[-2]
    g = h // hk
    dv = v.shape[-1]
    qf = q_bits.reshape(b * hk, g, w)
    vf = v.reshape(b * hk, t, dv)
    len_f = torch.repeat_interleave(_per_slot(lengths, b, q_bits.device), hk)
    with _cost.kernel(_dec.NAME, lambda: _cost.k4_work(
            rows=b * hk, g=g, w=w, dv=dv, v_bytes=v.element_size(),
            lengths=([t if cross else t - 1] * (b * hk) if q_bits.is_meta
                     else len_f.clamp(0, t).cpu().numpy()))):
        if q_bits.is_meta:
            out = v.new_empty((b * hk, g, dv), dtype=torch.float32)
        elif not q_bits.is_cuda:
            k_rows = to_bitplanes(k_bits) if bitplanes else k_bits
            out = ref.decode_attention_ref(
                qf, k_rows.reshape(b * hk, t, w), vf, d=d, nsel=nsel,
                scale=scale, lengths=len_f)
        else:
            k_planes = k_bits if bitplanes else to_bitplanes(k_bits)
            out = _dec.decode_attention(
                qf.contiguous(), k_planes.reshape(b * hk, w, t).contiguous(),
                vf.contiguous(), len_f.contiguous(), d=d, nsel=nsel,
                scale=scale, cross=cross)
    return out.reshape(b, h, dv)


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

    page_topn < nb switches on two-phase page-sparse decode: phase 1
    scores every listed page per (slot, kv-head) with the popcount upper
    bound and compacts each row's table to its top page_topn pages plus
    the frontier (`select_pages` of the bounds; on the card one launch of
    K3 does both), and phase 2 runs the decode kernel over the compacted
    table. At page_topn >= resident pages the result is bit-identical to
    the dense walk.
    """
    b, h, w = q_bits.shape
    _, hk, _, page = k_pool.shape
    g = h // hk
    qf = q_bits.reshape(b * hk, g, w).contiguous()
    lengths = _per_slot(lengths, b, q_bits.device)
    bt_rows, counts, len_f = _row_tables(block_tables, lengths, hk, page)
    r, nb = bt_rows.shape
    if q_bits.is_meta:
        return _paged_decode_meta(q_bits, v_pool, r, nb, page, g, w,
                                  page_topn)
    if page_topn is not None and page_topn < nb:
        select = (_pscore.paged_select_pages if q_bits.is_cuda
                  else ref.paged_select_pages_ref)
        listed = counts
        with _cost.kernel(_pscore.NAME, lambda: _cost.k3_work(
                rows=r, g=g, w=w, nb=nb, n_sel=page_topn,
                counts=listed.cpu().numpy())):
            bt_rows, counts, _ = select(qf, k_pool, bt_rows, counts, len_f,
                                        d=d, page=page, n_sel=page_topn)
    dv = v_pool.shape[-1]
    with _cost.kernel(_pdec.NAME, lambda: _cost.k2_work(
            rows=r, g=g, w=w, dv=dv, v_bytes=v_pool.element_size(),
            nb=bt_rows.shape[1], counts=counts.cpu().numpy())):
        if not q_bits.is_cuda:
            out = ref.paged_decode_attention_rows_ref(
                qf, k_pool, v_pool, bt_rows, counts, d=d, nsel=nsel,
                scale=scale)
        else:
            out = _pdec.paged_decode_attention(
                qf, k_pool, v_pool, bt_rows, counts, d=d, nsel=nsel,
                scale=scale)
    return out.reshape(b, h, -1)


def _paged_decode_meta(q_bits, v_pool, r: int, nb: int, page: int, g: int,
                       w: int, page_topn: int | None) -> torch.Tensor:
    """`paged_decode_attention` on meta: every listed page full."""
    full = [[page] * nb] * r
    if page_topn is not None and page_topn < nb:
        with _cost.kernel(_pscore.NAME, lambda: _cost.k3_work(
                rows=r, g=g, w=w, nb=nb, n_sel=page_topn, counts=full)):
            nb = page_topn
        full = [[page] * nb] * r
    dv = v_pool.shape[-1]
    with _cost.kernel(_pdec.NAME, lambda: _cost.k2_work(
            rows=r, g=g, w=w, dv=dv, v_bytes=v_pool.element_size(), nb=nb,
            counts=full)):
        out = v_pool.new_empty((r, g, dv), dtype=torch.float32)
    b, h = q_bits.shape[:2]
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
    if q_bits.is_meta:
        full = {"kv_length": [s if causal else t] * (b * h),
                "q_offset": [0] * (b * h), "q_length": [s] * (b * h)}
    with _cost.kernel(_pre.NAME, lambda: _cost.k1_work(
            rows=b * h, s=s, w=w, dv=dv, v_bytes=v.element_size(),
            group_size=g, causal=causal, **(full if q_bits.is_meta else dict(
                kv_length=kv_len.clamp(0, t).cpu().numpy(),
                q_offset=q_off.cpu().numpy(),
                q_length=q_len.cpu().numpy())))):
        if q_bits.is_meta:
            out = v.new_empty((b * h, s, dv), dtype=torch.float32)
        elif not q_bits.is_cuda:
            out = ref.prefill_attention_ref(
                qf, kf, vf, d=d, nsel=nsel, scale=scale, kv_length=kv_len,
                q_offset=q_off, group_size=g, q_length=q_len,
                causal=causal)
        else:
            out = _pre.prefill_attention(
                qf.contiguous(), kf.contiguous(), vf.contiguous(), d=d,
                nsel=nsel, scale=scale, kv_length=kv_len.contiguous(),
                q_offset=q_off.contiguous(), q_length=q_len.contiguous(),
                group_size=g, n_kv_heads=hk, causal=causal)
    return out.reshape(b, h, s, dv)

