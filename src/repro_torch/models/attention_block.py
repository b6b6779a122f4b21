"""GQA attention block (torch twin of ``repro.models.attention_block``):
the training / evaluation forward modes and the serving paths.

Training and evaluation (`attn_forward`, no cache): "std" full-precision
softmax (teacher / baseline), "fp_topn" top-N only, "had_train" the
stage-scheduled binarization + top-N, "had_eval" hard-sign binarization +
top-N, and the "sab_train" / "sab_eval" attention-matrix binarization
ablation; `attn_forward_distill` is the fused teacher + student forward
with the Eq. 9 KL. Binarization follows RoPE. In stages 3-4 and in
had_eval the student's logits are taken as the integer product of the
signs times sigma_q * sigma_k (``core.attention``: exact top-N ties).

On the binary (HAD) path keys and queries are binarized after RoPE and
packed to 32-bit words. Two caches, as in the JAX package:

  * paged -- the K cache is a shared pool of bit-plane pages and V a pool
    of pages in the model dtype, addressed through per-slot block tables.
    Prefill chunks gather every slot's pages into rows and run the prefill
    kernel; decode steps read pages in place through the paged decode
    kernel, optionally page-sparse (``page_topn``).
  * dense -- per-slot k_bits [B, Hk, W, max_len + 1] bit-planes and v
    [B, Hk, max_len + 1, Dh] rows. Prefill runs the prefill kernel over the
    cache rows; decode runs the contiguous-cache decode kernel.

A cross-attention layer ("C") reads a static cache of image keys and
values instead: ``init_cross_cache`` sizes it at exactly n_image_tokens
positions (no trash position: its valid length is the whole cache),
``fill_cross_cache`` computes it from the projected image embeddings,
and the serving step reads it per slot (dense) or through pooled state
entries (``cross_cache_read`` / ``cross_cache_write``). Its queries take
no RoPE and attend every image key, non-causally: the prefill kernel for
a chunk, the contiguous-cache decode kernel for a decode step, paged
engine or not.

The binary path goes through ``repro_torch.kernels.ops``, which dispatches
by tensor device. The full-precision baseline (``binary=False``) keeps K
and V in the model dtype, in the same two layouts, and runs
``core.attention.standard_attention`` over gathered rows: the JAX package
has no kernel there either. Caches are updated IN PLACE (index_put_),
unlike the JAX package's functional updates, so a step never copies a
cache. Writes that must be dropped go to a trash page (paged) or a trash
position (dense) at the end of the cache instead, which no read ever
treats as valid.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core import attention as A
from repro_torch.core import binarize as BZ
from repro_torch.core import hamming
from repro_torch.core.attention import standard_attention
from repro_torch.distributed import collectives
from repro_torch.kernels import ops
from repro_torch.kernels.ref import top_blocks
from repro_torch.models import common
from repro_torch.models.config import ModelConfig


class Attention(nn.Module):
    """wq/wk/wv/wo ([in, out], as in the JAX tree) plus the frozen
    binarization scales sigma_q/sigma_k (buffers)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
        dt = cfg.dtype

        def weight(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.wq = weight(d, h * dh)
        self.wk = weight(d, hk * dh)
        self.wv = weight(d, hk * dh)
        self.wo = weight(h * dh, d)
        sigma = torch.tensor(cfg.had.sigma_init, dtype=torch.float32)
        self.register_buffer("sigma_q", sigma.clone().to(device))
        self.register_buffer("sigma_k", sigma.clone().to(device))
        self.base_scale = cfg.attn_scale
        # from the host value: a module built on the meta device has none
        self.scale = _logit_scale(sigma.item(), sigma.item(), self.base_scale)

    def refresh_scale(self) -> None:
        """Recompute the float32 logit scale (sigma_q * sigma_k) *
        cfg.attn_scale (dh^-0.5, or the published attention_multiplier)
        from the sigma buffers. Called once when the weights are set, so
        the serving hot path never reads a device scalar back."""
        self.scale = _logit_scale(self.sigma_q.item(), self.sigma_k.item(),
                                  self.base_scale)


def _logit_scale(sigma_q: float, sigma_k: float, base: float) -> float:
    sq, sk = np.float32(sigma_q), np.float32(sigma_k)
    return float(np.float32(sq * sk) * np.float32(base))


# ---------------------------------------------------------------------------
# training / evaluation forward (no cache)
# ---------------------------------------------------------------------------

def _project_qkv(p: Attention, x: torch.Tensor, x_kv: torch.Tensor,
                 cfg: ModelConfig):
    """-> q [B, H, S, Dh], k / v [B, Hk, Skv, Dh]."""
    b, s, _ = x.shape
    skv = x_kv.shape[1]
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = (x @ p.wq).reshape(b, s, h, dh).transpose(1, 2)
    k = (x_kv @ p.wk).reshape(b, skv, hk, dh).transpose(1, 2)
    v = (x_kv @ p.wv).reshape(b, skv, hk, dh).transpose(1, 2)
    return q, k, v


def _rope(q, k, cfg: ModelConfig):
    if cfg.pos == "rope":
        q = common.apply_rope(q, torch.arange(q.shape[2], device=q.device),
                              theta=cfg.rope_theta)
        k = common.apply_rope(k, torch.arange(k.shape[2], device=k.device),
                              theta=cfg.rope_theta)
    return q, k


def _student_qk(p: Attention, q: torch.Tensor, k: torch.Tensor, *,
                stage: int | None, c: torch.Tensor | None):
    """The student's Q/K for top-N attention: (q, k, qk_scale).

    stage 1-2: the tanh transforms (qk_scale None); stage 3-4: the STE
    signs of q / sigma_q and k / sigma_k with qk_scale = sigma_q * sigma_k,
    equal in value to JAX's sigma * STE(x / sigma) products, gradients
    included, with exact ties; stage None (had_eval): the hard signs."""
    if stage is None or stage >= BZ.Stage.STAGE3_STE:
        # sigma rounded to the activations' dtype, as JAX casts it; the
        # product in float32, as JAX's float32 logits multiply the terms
        sq, sk = p.sigma_q.to(q.dtype), p.sigma_k.to(k.dtype)
        qk_scale = sq.to(torch.float32) * sk.to(torch.float32)
        if stage is None:
            return BZ.hard_sign(q), BZ.hard_sign(k), qk_scale
        return BZ.ste_sign(q / sq), BZ.ste_sign(k / sk), qk_scale
    return (BZ.binarize(q, stage=stage, c=c, sigma=p.sigma_q),
            BZ.binarize(k, stage=stage, c=c, sigma=p.sigma_k), None)


def _stage_c(att: dict):
    """(stage, c) of the step in `att` (JAX `binarize_scheduled`: stage 4
    uses stage 3's transform)."""
    sched: BZ.CSchedule = att["sched"]
    step = int(att["step"])
    return sched.stage_at_traced(step), sched.c_at(step)


def attn_forward(p: Attention, x: torch.Tensor, *, cfg: ModelConfig,
                 mode: str, att: dict, x_kv: torch.Tensor | None = None,
                 cross: bool = False) -> torch.Tensor:
    """Training / evaluation forward (no cache): x [B, S, D] -> [B, S, D].
    att carries n, sched, step, threshold_method, attn_dtype and the
    optional kv_valid / kv_valid_cross [B, Skv] masks."""
    x_kv = x if x_kv is None else x_kv
    q, k, v = _project_qkv(p, x, x_kv, cfg)
    if not cross:
        q, k = _rope(q, k, cfg)
    causal = cfg.causal and not cross
    scale = cfg.attn_scale
    kv_valid = att.get("kv_valid_cross") if cross else att.get("kv_valid")
    if mode == "std" or not cfg.had.enabled:
        return _out(p, standard_attention(q, k, v, scale=scale, causal=causal,
                                          kv_valid=kv_valid))
    n = att["n"]
    kw = dict(n=n, scale=scale, causal=causal, kv_valid=kv_valid,
              method=att.get("threshold_method"),
              attn_dtype=att.get("attn_dtype", torch.float32))
    if mode == "fp_topn":
        return _out(p, A.had_topn_attention(q, k, v, **kw))
    if mode in ("had_train", "had_eval"):
        stage, c = _stage_c(att) if mode == "had_train" else (None, None)
        qb, kb, qk_scale = _student_qk(p, q, k, stage=stage, c=c)
        return _out(p, A.had_topn_attention(qb, kb, v, qk_scale=qk_scale,
                                            **kw))
    if mode in ("sab_train", "sab_eval"):
        return _out(p, _sab_attention(q, k, v, scale=scale, causal=causal))
    raise ValueError(f"unknown mode {mode}")


def _sab_attention(q, k, v, *, scale: float, causal: bool) -> torch.Tensor:
    """"w/ SAB" ablation (paper tables 1-2): BiViT-style softmax-aware
    binarization of the ATTENTION MATRIX (Q/K stay full precision). A row
    is binarized to {0, alpha} with alpha preserving the kept mass; the
    STE passes gradients through the comparison."""
    hk = k.shape[1]
    qg = A._group(q, hk)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        qi = torch.arange(q.shape[2], device=q.device)[:, None]
        kj = torch.arange(k.shape[2], device=q.device)[None, :]
        logits = torch.where(kj <= qi, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    thresh = probs.mean(-1, keepdim=True)
    keep = (probs >= thresh).to(torch.float32)
    keep = keep + (probs - probs.detach())                  # STE
    kd = keep.detach()
    alpha = ((probs * kd).sum(-1, keepdim=True)
             / kd.sum(-1, keepdim=True).clamp_min(1.0))
    a_bin = keep * alpha
    a_bin = a_bin / a_bin.sum(-1, keepdim=True).clamp_min(1e-9)
    ctx = torch.einsum("bhgqk,bhkd->bhgqd", a_bin, v.to(torch.float32))
    return A._ungroup(ctx).to(v.dtype)


def attn_forward_distill(pt: Attention, ps: Attention, xt: torch.Tensor,
                         xs: torch.Tensor, *, cfg: ModelConfig, att: dict,
                         xt_kv: torch.Tensor | None = None,
                         xs_kv: torch.Tensor | None = None,
                         cross: bool = False):
    """Teacher + student fused forward with the attention KL (Eq. 9).
    Returns (yt, ys, kl_sum, row_count)."""
    xt_kv = xt if xt_kv is None else xt_kv
    xs_kv = xs if xs_kv is None else xs_kv
    qt, kt, vt = _project_qkv(pt, xt, xt_kv, cfg)
    qs, ks, vs = _project_qkv(ps, xs, xs_kv, cfg)
    if not cross:
        qt, kt = _rope(qt, kt, cfg)
        qs, ks = _rope(qs, ks, cfg)
    stage, c = _stage_c(att)
    qs, ks, qk_scale = _student_qk(ps, qs, ks, stage=stage, c=c)
    res = A.distill_pair_attention(
        qt, kt, vt, qs, ks, vs, n=att["n"], scale=cfg.attn_scale,
        causal=cfg.causal and not cross,
        kv_valid=att.get("kv_valid_cross") if cross else att.get("kv_valid"),
        q_block=cfg.q_block, method=att.get("threshold_method"),
        qk_scale=qk_scale, attn_dtype=att.get("attn_dtype", torch.float32))
    return (_out(pt, res.teacher_out), _out(ps, res.student_out),
            res.kl_sum, res.row_count)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               binary: bool = True, device=None) -> dict:
    """One layer's dense cache: binary, k_bits [B, Hk, W, max_len+1] int32
    bit-planes; full precision, k [B, Hk, max_len+1, Dh]; and v
    [B, Hk, max_len+1, Dh], all but k_bits in the model dtype. Position
    ``max_len`` is a trash position that absorbs dropped writes; no length
    ever reaches it, and positions [0, max_len) match the JAX cache."""
    hk, dh = cfg.n_kv_heads, cfg.dh
    rows = torch.zeros((batch, hk, max_len + 1, dh), dtype=cfg.dtype,
                       device=device)
    if not binary:
        return {"k": rows, "v": rows.clone()}
    w = hamming.packed_words(dh)
    return {
        "k_bits": torch.zeros((batch, hk, w, max_len + 1), dtype=torch.int32,
                              device=device),
        "v": rows,
    }


def init_cross_cache(cfg: ModelConfig, entries: int, *,
                     binary: bool = True, device=None) -> dict:
    """One cross layer's cache: `entries` rows (slots of a dense cache, or
    pool entries) of exactly max(n_image_tokens, 1) positions, laid out as
    `init_cache`'s (binary, k_bits [E, Hk, W, T] bit-planes; full
    precision, k [E, Hk, T, Dh]; and v [E, Hk, T, Dh]), as the JAX
    package sizes it. Unlike a self-attention cache it has no trash
    position: attention reads every position as valid."""
    hk, dh, t = cfg.n_kv_heads, cfg.dh, max(cfg.n_image_tokens, 1)
    rows = torch.zeros((entries, hk, t, dh), dtype=cfg.dtype, device=device)
    if not binary:
        return {"k": rows, "v": rows.clone()}
    return {"k_bits": torch.zeros((entries, hk, hamming.packed_words(dh), t),
                                  dtype=torch.int32, device=device),
            "v": rows}


def fill_cross_cache(p: Attention, img: torch.Tensor, *, cfg: ModelConfig,
                     binary: bool) -> dict:
    """The static cross-attention cache of projected image embeddings
    img [B, T, D] (JAX ``fill_cross_cache``): K bits as bit-planes
    [B, Hk, W, T] and V [B, Hk, T, Dh] (full precision: K rows)."""
    b, t, _ = img.shape
    hk, dh = cfg.n_kv_heads, cfg.dh
    k = (img @ p.wk).reshape(b, t, hk, dh).transpose(1, 2)
    v = (img @ p.wv).reshape(b, t, hk, dh).transpose(1, 2)
    if binary:
        return {"k_bits": hamming.pack_bits(k.to(torch.float32))
                .transpose(-1, -2), "v": v}
    return {"k": k, "v": v}


def cross_cache_read(pool: dict, entries: torch.Tensor) -> dict:
    """Gather cross-cache entries into a [B, ...] batch view (a copy)."""
    return common.pool_read(pool, entries)


def cross_cache_write(pool: dict, new: dict, entries: torch.Tensor,
                      ok: torch.Tensor) -> None:
    """Scatter a cross-cache batch view into its entries, in place; rows
    not `ok` go to the pool's trash entry."""
    common.pool_write(pool, new, entries, ok)


def _cache_write(buf: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                 axis: int, n_valid: torch.Tensor | None = None,
                 active: torch.Tensor | None = None,
                 slots: torch.Tensor | None = None) -> None:
    """Write `new` into the dense cache `buf` at per-slot positions, in
    place.

    buf [slots, ...] with max_len+1 positions on `axis` (the last one the
    trash position); new [B, ...] with S tokens on `axis`, row b into
    slot `slots[b]` (default: slot b); pos [B] position of new's token 0
    per row. Exactly [pos, pos + n_valid) of active rows is
    written; padding tokens (j >= n_valid[b]), inactive rows and positions
    past max_len go to the trash position. Dropped tokens are never
    clamped onto real positions: index_put_ with duplicate indices that
    carry different values leaves the result undefined.
    """
    b, s = new.shape[0], new.shape[axis]
    trash = buf.shape[axis] - 1
    steps = torch.arange(s, device=buf.device)
    gpos = pos.to(torch.int64)[:, None] + steps[None]              # [B, S]
    ok = gpos < trash
    if n_valid is not None:
        ok = ok & (steps[None] < n_valid.to(torch.int64)[:, None])
    if active is not None:
        ok = ok & active[:, None]
    rows = (torch.arange(b, device=buf.device) if slots is None
            else slots)[:, None].expand(b, s)
    # a view with the token axis second: index_put_ writes through it
    torch.movedim(buf, axis, 1)[rows, torch.where(ok, gpos, trash)] = \
        torch.movedim(new, axis, 1).to(buf.dtype)


def _update_binary_cache(cache: dict, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor,
                         n_valid: torch.Tensor | None = None,
                         active: torch.Tensor | None = None,
                         slots: torch.Tensor | None = None) -> None:
    """k, v [B, Hk, S, Dh] written into the dense cache (its rows
    `slots`) in place."""
    kb = hamming.pack_bits(k.to(torch.float32))            # [B, Hk, S, W]
    _cache_write(cache["k_bits"], kb.transpose(-1, -2), pos, axis=3,
                 n_valid=n_valid, active=active, slots=slots)
    _cache_write(cache["v"], v, pos, axis=2, n_valid=n_valid, active=active,
                 slots=slots)


def _update_std_cache(cache: dict, k: torch.Tensor, v: torch.Tensor,
                      pos: torch.Tensor, n_valid: torch.Tensor | None = None,
                      active: torch.Tensor | None = None,
                      slots: torch.Tensor | None = None) -> None:
    """Full precision: k, v [B, Hk, S, Dh] written into the dense cache
    (its rows `slots`) in place."""
    for name, new in (("k", k), ("v", v)):
        _cache_write(cache[name], new, pos, axis=2, n_valid=n_valid,
                     active=active, slots=slots)


def _dense_rows(cache: dict, slots: torch.Tensor | None) -> dict:
    """The dense cache, or its rows `slots` (a copy) for a step whose
    batch rows address those slots."""
    return cache if slots is None else common.pool_read(cache, slots)


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int, *,
                     binary: bool = True, device=None) -> dict:
    """One layer's page pools: binary, k_bits [n_pages+1, Hk, W, page]
    int32 bit-planes; full precision, k [n_pages+1, Hk, page, Dh]; and v
    [n_pages+1, Hk, page, Dh], all but k_bits in the model dtype. Page
    ``n_pages`` is a trash page that absorbs dropped writes; no block
    table ever names it, and pages [0, n_pages) match the JAX pools."""
    hk, dh = cfg.n_kv_heads, cfg.dh
    pages = torch.zeros((n_pages + 1, hk, page_size, dh), dtype=cfg.dtype,
                        device=device)
    if not binary:
        return {"k": pages, "v": pages.clone()}
    w = hamming.packed_words(dh)
    return {
        "k_bits": torch.zeros((n_pages + 1, hk, w, page_size),
                              dtype=torch.int32, device=device),
        "v": pages,
    }


def _paged_cache_write(pool: torch.Tensor, new: torch.Tensor,
                       pos: torch.Tensor, bt: torch.Tensor, *,
                       offset_axis: int, n_valid: torch.Tensor | None = None,
                       active: torch.Tensor | None = None) -> None:
    """Scatter per-token values into a page pool through the block table.

    pool [n_pages+1, ...] with the in-page offset at `offset_axis`; new
    [B, S, ...]; pos [B] position of new[:, 0] per slot; bt [B, nb] RAW
    block table (-1 = unallocated). Token (b, j) lands at page
    bt[b, (pos_b+j) // page], offset (pos_b+j) % page. Padding tokens
    (j >= n_valid[b]), inactive rows, positions past the table and -1
    entries under a valid token are routed to the trash page -- no host
    sync, no boolean filtering.
    """
    b, s = new.shape[:2]
    page = pool.shape[offset_axis]
    trash = pool.shape[0] - 1
    nb = bt.shape[1]
    steps = torch.arange(s, device=pool.device)
    gpos = pos.to(torch.int64)[:, None] + steps[None]              # [B, S]
    logical = torch.div(gpos, page, rounding_mode="floor")
    off = gpos - logical * page
    phys = torch.gather(bt.to(torch.int64), 1, logical.clamp(0, nb - 1))
    ok = logical < nb
    if n_valid is not None:
        ok = ok & (steps[None] < n_valid.to(torch.int64)[:, None])
    if active is not None:
        ok = ok & active[:, None]
    phys = torch.where(ok & (phys >= 0), phys, trash)
    idx: list = [phys.reshape(-1)] + [slice(None)] * (pool.ndim - 1)
    idx[offset_axis] = off.reshape(-1)
    pool[tuple(idx)] = new.reshape((b * s,) + new.shape[2:]).to(pool.dtype)


def gather_pages(pool: torch.Tensor, bt: torch.Tensor,
                 axis: int) -> torch.Tensor:
    """Block-table gather: pool [n_pages, ...] -> contiguous [B, ...] rows.

    `axis` is the token axis of the contiguous layout (pages land there,
    merged with the in-page offset axis). bt must be clamped (>= 0);
    pages past a slot's valid length carry garbage that callers mask.
    """
    g = pool[bt.to(torch.int64)]                   # [B, NB, *pool.shape[1:]]
    g = torch.movedim(g, 1, axis)                  # NB beside the page axis
    shape = g.shape
    return g.reshape(shape[:axis] + (shape[axis] * shape[axis + 1],)
                     + shape[axis + 2:])


def _update_binary_cache_paged(cache: dict, k: torch.Tensor, v: torch.Tensor,
                               pos: torch.Tensor, bt: torch.Tensor,
                               n_valid: torch.Tensor | None = None,
                               active: torch.Tensor | None = None) -> None:
    """k, v [B, Hk, S, Dh] scattered into the pools in place."""
    kb = hamming.pack_bits(k.to(torch.float32))            # [B, Hk, S, W]
    _paged_cache_write(cache["k_bits"], kb.permute(0, 2, 1, 3), pos, bt,
                       offset_axis=3, n_valid=n_valid, active=active)
    _paged_cache_write(cache["v"], v.transpose(1, 2), pos, bt, offset_axis=2,
                       n_valid=n_valid, active=active)


def _update_std_cache_paged(cache: dict, k: torch.Tensor, v: torch.Tensor,
                            pos: torch.Tensor, bt: torch.Tensor,
                            n_valid: torch.Tensor | None = None,
                            active: torch.Tensor | None = None) -> None:
    """Full precision: k, v [B, Hk, S, Dh] scattered into the pools in
    place."""
    for name, new in (("k", k), ("v", v)):
        _paged_cache_write(cache[name], new.transpose(1, 2), pos, bt,
                           offset_axis=2, n_valid=n_valid, active=active)


def _page_topn_keep(page_scores: torch.Tensor, kv_len: torch.Tensor, *,
                    page: int, n_sel: int) -> torch.Tensor:
    """Top-N page selection as a per-slot token mask (the full-precision
    page-sparse decode).

    page_scores [B, nb] per-page scores (higher = keep); kv_len [B] valid
    context lengths. Returns [B, nb*page] bool keeping the tokens of each
    slot's top-n_sel pages: the frontier (tail) page always among them,
    pages past the frontier never ranked in, ties to the lowest block (as
    ``lax.top_k``: a stable descending sort, never ``torch.topk``). Applied
    as a kv_valid restriction on the gathered rows, so at n_sel >= resident
    pages the result is bit-identical to the dense walk.
    """
    b, nb = page_scores.shape
    blocks = torch.arange(nb, device=page_scores.device)
    kv_len = kv_len.to(torch.int64)
    frontier = (kv_len - 1).clamp_min(0) // page
    s = torch.where(blocks[None] * page < kv_len[:, None],
                    page_scores.to(torch.float32), -torch.inf)
    s = torch.where(blocks[None] == frontier[:, None], torch.inf, s)
    idx = top_blocks(s, min(n_sel, nb))
    keep = torch.zeros((b, nb), dtype=torch.bool, device=s.device)
    keep.scatter_(1, idx, True)
    return keep.repeat_interleave(page, dim=1)


def _out(p: Attention, ctx: torch.Tensor, group=None) -> torch.Tensor:
    # tensor-parallel serving: ctx holds this rank's heads and wo is
    # replicated, so the full head axis is gathered first, which keeps one
    # device's contraction order (a sum of partial wo products would not)
    ctx = collectives.all_gather_heads(ctx, group)
    b, h, s, dh = ctx.shape
    y = ctx.transpose(1, 2).reshape(b, s, h * dh)
    return y.to(p.wo.dtype) @ p.wo


def attn_serve(p: Attention, x: torch.Tensor, *, cfg: ModelConfig,
               cache: dict, pos: torch.Tensor, n: int,
               block_tables: torch.Tensor | None = None,
               n_valid: torch.Tensor | None = None,
               active: torch.Tensor | None = None,
               page_topn: int | None = None,
               binary: bool = True, cross: bool = False,
               slots: torch.Tensor | None = None,
               group=None) -> torch.Tensor:
    """Prefill chunk (S > 1) or decode step (S == 1).

    x [B, S, D]; pos [B] per-slot position of x[:, 0]; block_tables
    [B, nb] raw table of a paged cache, or None for the dense cache;
    n_valid [B] real tokens per row of a padded chunk (the valid cache
    length becomes pos + n_valid); active [B] rows whose writes land;
    page_topn: page-sparse decode over the paged cache (decode steps
    only); binary: the HAD path (False: the full-precision baseline);
    cross: a cross-attention layer over the static cache `cache` (a
    [B, ...] view; see `_cross_attn`); slots [B] int: the dense cache's
    row of each batch row (default: row b is slot b; ignored by the
    paged cache). Updates `cache` in place (a self-attention layer) and
    returns y [B, S, D].

    group: the process group of tensor-parallel serving, where `p`, `cfg`
    and `cache` hold this rank's heads; the context is gathered over the
    group's heads before wo. The binary kernels select keys per (slot,
    kv head), so only the full-precision page-sparse decode needs one
    more collective (its per-slot page scores, a max over every head).
    """
    if cross:
        return _cross_attn(p, x, cfg=cfg, cache=cache, pos=pos, n=n,
                           binary=binary, group=group)
    b, s, _ = x.shape
    dh, h, hk = cfg.dh, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p.wq).reshape(b, s, h, dh).transpose(1, 2)
    k = (x @ p.wk).reshape(b, s, hk, dh).transpose(1, 2)
    v = (x @ p.wv).reshape(b, s, hk, dh).transpose(1, 2)
    q_pos = pos.to(torch.int64)[:, None] + torch.arange(s, device=x.device)
    if cfg.pos == "rope":
        q = common.apply_rope(q, q_pos, theta=cfg.rope_theta)
        k = common.apply_rope(k, q_pos, theta=cfg.rope_theta)
    kv_len = pos + (s if n_valid is None else n_valid)
    if not binary:
        return _out(p, _attn_std(q, k, v, cfg=cfg, cache=cache, pos=pos,
                                 kv_len=kv_len, block_tables=block_tables,
                                 n_valid=n_valid, active=active,
                                 page_topn=page_topn, slots=slots,
                                 group=group).to(x.dtype), group)
    qb = hamming.pack_bits(q.to(torch.float32))            # [B, H, S, W]
    if block_tables is None:
        _update_binary_cache(cache, k, v, pos, n_valid=n_valid,
                             active=active, slots=slots)
        rows = _dense_rows(cache, slots)
        if s == 1:
            y = ops.decode_attention(
                qb[:, :, 0], rows["k_bits"], rows["v"], d=dh, nsel=n,
                scale=p.scale, lengths=kv_len, bitplanes=True)[:, :, None]
        else:
            y = ops.prefill_attention(
                qb, ops.to_bitplanes(rows["k_bits"]), rows["v"], d=dh,
                nsel=n, scale=p.scale, kv_length=kv_len, q_offset=pos,
                q_length=n_valid, causal=cfg.causal)
        return _out(p, y.to(x.dtype), group)
    # writes see the RAW table (a -1 under a valid token is dropped);
    # reads clamp -1 to page 0, which only ever lies past a row's length
    bt = block_tables.clamp_min(0)
    _update_binary_cache_paged(cache, k, v, pos, block_tables,
                               n_valid=n_valid, active=active)
    if s == 1:
        y = ops.paged_decode_attention(
            qb[:, :, 0], cache["k_bits"], cache["v"], block_tables, d=dh,
            nsel=n, scale=p.scale, lengths=kv_len,
            page_topn=page_topn)[:, :, None]
    else:
        k_rows = gather_pages(cache["k_bits"], bt, 3)      # [B, Hk, W, T]
        v_rows = gather_pages(cache["v"], bt, 2)           # [B, Hk, T, Dh]
        y = ops.prefill_attention(
            qb, ops.to_bitplanes(k_rows), v_rows, d=dh, nsel=n,
            scale=p.scale, kv_length=kv_len, q_offset=pos, q_length=n_valid,
            causal=cfg.causal)
    return _out(p, y.to(x.dtype), group)


def _cross_attn(p: Attention, x: torch.Tensor, *, cfg: ModelConfig,
                cache: dict, pos: torch.Tensor, n: int,
                binary: bool, group=None) -> torch.Tensor:
    """The cross branch of `attn_serve`, as the JAX package's: queries
    without RoPE attend every position of the static cache [B, ...]
    (valid length: the whole cache), non-causally, and nothing is written.
    Binary: a decode step runs the contiguous-cache decode kernel over the
    bit-planes, paged engine or not, and a chunk the prefill kernel with
    causal=False and every query live; full precision,
    ``standard_attention``. `page_topn` does not apply."""
    b, s, _ = x.shape
    dh, h = cfg.dh, cfg.n_heads
    q = (x @ p.wq).reshape(b, s, h, dh).transpose(1, 2)
    if not binary:
        return _out(p, standard_attention(
            q, cache["k"], cache["v"], scale=cfg.attn_scale, causal=False,
            q_offset=pos).to(x.dtype), group)
    t = cache["v"].shape[2]
    # lengths as device fills, never host copies: a captured step holds them
    kv_len = torch.full((b,), t, dtype=torch.int32, device=x.device)
    qb = hamming.pack_bits(q.to(torch.float32))            # [B, H, S, W]
    if s == 1:
        y = ops.decode_attention(
            qb[:, :, 0], cache["k_bits"], cache["v"], d=dh, nsel=n,
            scale=p.scale, lengths=kv_len, bitplanes=True,
            cross=True)[:, :, None]
    else:
        y = ops.prefill_attention(
            qb, ops.to_bitplanes(cache["k_bits"]), cache["v"], d=dh, nsel=n,
            scale=p.scale, kv_length=kv_len, q_offset=pos,
            q_length=torch.full((b,), s, dtype=torch.int32,
                                device=x.device), causal=False)
    return _out(p, y.to(x.dtype), group)


def _attn_std(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              cfg: ModelConfig, cache: dict, pos: torch.Tensor,
              kv_len: torch.Tensor, block_tables: torch.Tensor | None,
              n_valid: torch.Tensor | None, active: torch.Tensor | None,
              page_topn: int | None, slots: torch.Tensor | None = None,
              group=None) -> torch.Tensor:
    """The full-precision branch of `attn_serve` (JAX
    ``attn_serve(binary=False)``): write the new K/V, gather the rows
    (paged) or take the dense cache, mask past each slot's length and run
    ``standard_attention`` at scale dh^-0.5. Returns [B, H, S, Dh]. A
    dense cache is read and written at its rows `slots` when given.

    The dense cache is read as [..., :max_len, :], made contiguous, so that
    it reduces over the same shapes as the paged rows (nb * page
    positions): when max_len % page == 0 the two are bit-identical.

    Each kv head's attention is its own product, so that a rank holding
    some of the kv heads computes each as one device does.

    Page-sparse decode (paged, S == 1, page_topn) scores each page by its
    exact max QK logit over kv heads, grouped heads and in-page positions,
    one score per SLOT, and keeps the `_page_topn_keep` pages as a kv_valid
    restriction (no compacted table). Under tensor parallelism (`group`)
    the slot's score is the max over every rank's kv heads.
    """
    b, _, s, dh = q.shape
    if block_tables is None:
        _update_std_cache(cache, k, v, pos, n_valid=n_valid, active=active,
                          slots=slots)
        rows = _dense_rows(cache, slots)
        t_max = rows["v"].shape[2] - 1                     # less the trash
        k_rows = rows["k"][:, :, :t_max].contiguous()
        v_rows = rows["v"][:, :, :t_max].contiguous()
    else:
        _update_std_cache_paged(cache, k, v, pos, block_tables,
                                n_valid=n_valid, active=active)
        bt = block_tables.clamp_min(0)
        k_rows = gather_pages(cache["k"], bt, 2)           # [B, Hk, T, Dh]
        v_rows = gather_pages(cache["v"], bt, 2)
        t_max = k_rows.shape[2]
    kv_valid = (torch.arange(t_max, device=q.device)[None, :]
                < kv_len.to(torch.int64)[:, None])          # [B, T]
    if block_tables is not None and s == 1 and page_topn is not None:
        hk = cfg.n_kv_heads
        page = cache["v"].shape[2]
        qg = q[:, :, 0].reshape(b, hk, -1, dh).to(torch.float32)
        logits = torch.einsum("bkgd,bktd->bkgt", qg,
                              k_rows.to(torch.float32))
        logits = torch.where(kv_valid[:, None, None], logits, -torch.inf)
        sc = logits.reshape(b, -1, t_max // page, page).amax(dim=(1, 3))
        sc = collectives.all_reduce_max(sc, group)
        kv_valid = kv_valid & _page_topn_keep(sc, kv_len, page=page,
                                              n_sel=page_topn)
    # one product a kv head: on the card a float32 GEMM's kernel, and so
    # its rounding, depends on the batch count, which differs between one
    # device (every kv head) and a tensor-parallel rank (its kv heads);
    # a kv head alone is the same product on both
    hk = k_rows.shape[1]
    g = q.shape[1] // hk
    return torch.cat([standard_attention(
        q[:, i * g:(i + 1) * g], k_rows[:, i:i + 1], v_rows[:, i:i + 1],
        scale=cfg.attn_scale, causal=cfg.causal, q_offset=pos,
        kv_valid=kv_valid) for i in range(hk)], dim=1)
