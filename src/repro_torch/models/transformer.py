"""Decoder LM for serving (torch twin of the serving half of
``repro.models.transformer``).

`Transformer` holds per-layer `Block`s whose parameter names follow the
JAX tree (``blocks/pos0/{norm1,mixer,norm2,ffn}``), with the JAX
package's leading ``n_groups`` axis unstacked into a list of layers; the
JAX ``lax.scan`` over groups is a Python loop here. Layer
``g * len(layer_pattern) + i`` is group g of pattern position i.

A layer's mixer is picked by its pattern character: self-attention ("A"),
cross-attention ("C") or a Mamba2 SSM ("M", models/ssm.py); its FFN is an
MoE (models/moe.py) at the pattern positions `layer_uses_moe` names,
else a dense MLP. So the port serves decoders (smollm-135m,
llama-3.2-vision-11b, mamba2-130m, jamba-1.5-large-398b, dbrx-132b), on
the binary path or the full-precision baseline, over the paged or the
dense cache. Cross layers attend the image K/V of a static cache, filled
from per-request image embeddings (``frontend_proj``, then each layer's
wk/wv); SSM layers carry {h, conv} state. Both kinds of state are dense
per-slot rows, or entries of a state pool addressed by ``state_tables``
when the engine pools state. Encoders and frames frontends raise.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention_block as AB
from repro_torch.models import common, moe, ssm
from repro_torch.models.config import ModelConfig


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for model families this slice lacks,
    naming their ROADMAP.md items (queue 1, 'Still to port')."""
    todo = "is not ported yet: see ROADMAP.md queue 1, 'Still to port'"
    if not cfg.causal or cfg.pos != "rope":
        raise NotImplementedError(
            f"{cfg.name}: an encoder or learned positions {todo}, item 3 "
            f"(training, distillation and the encoder archs)")
    if cfg.frontend_dim and "C" not in cfg.layer_pattern:
        raise NotImplementedError(
            f"{cfg.name}: a frames frontend {todo}, item 1 (frames "
            f"frontends)")


def layer_kinds(cfg: ModelConfig) -> str:
    """The pattern character of every layer, in layer order."""
    return cfg.layer_pattern * cfg.n_groups


def layer_uses_moe(cfg: ModelConfig, layer: int) -> bool:
    """Layer `layer` has an MoE FFN: JAX's `_position_uses_moe` rule on
    its pattern position."""
    pos = layer % cfg.group_size
    return cfg.n_experts > 0 and pos % cfg.moe_every == cfg.moe_every - 1


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                              requires_grad=False)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype

        def weight(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.w1 = weight(d, f)
        self.w2 = weight(f, d)
        self.w3 = weight(d, f) if cfg.act == "swiglu" else None


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: str, use_moe: bool,
                 device=None):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.mixer = (ssm.SSM(cfg, device) if kind == "M"
                      else AB.Attention(cfg, device=device))
        if cfg.d_ff > 0:
            self.norm2 = RMSNorm(cfg.d_model, cfg.dtype, device)
            self.ffn = (moe.MoE(cfg, device) if use_moe
                        else MLP(cfg, device))


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        d, v, dt = cfg.d_model, cfg.padded_vocab, cfg.dtype
        self.embed = nn.Parameter(torch.zeros((v, d), dtype=dt, device=device),
                                  requires_grad=False)
        self.final_norm = RMSNorm(d, dt, device)
        self.lm_head = (None if cfg.tie_embeddings else nn.Parameter(
            torch.zeros((d, v), dtype=dt, device=device), requires_grad=False))
        # image embeddings [.., frontend_dim] -> the cross layers' width
        self.frontend_proj = (nn.Parameter(torch.zeros(
            (cfg.frontend_dim, d), dtype=dt, device=device),
            requires_grad=False) if cfg.frontend_dim else None)
        self.blocks = nn.ModuleList(
            Block(cfg, kind, layer_uses_moe(cfg, i), device)
            for i, kind in enumerate(layer_kinds(cfg)))

    def refresh_scales(self) -> None:
        """Recompute every attention layer's logit scale after sigmas were
        loaded."""
        for blk in self.blocks:
            if isinstance(blk.mixer, AB.Attention):
                blk.mixer.refresh_scale()


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cpu") -> Transformer:
    """Seeded random weights: truncated normal at fan-in std for dense
    weights (stacked expert weights [E, ...] take E as their fan-in, as
    in the JAX package), normal * 0.02 for the embedding, ones for norms;
    SSM layers: A_log 0, D 1, dt_bias 0, conv_w at std 0.5; MoE routers
    float32 at std 0.02 (the JAX init's distributions; jax.random's
    numbers differ). Drawn on the
    generator's device (a CPU generator by default; a CUDA generator draws
    a full-size model on the card, without the host copy), then moved to
    `device`. The numbers depend on the generator's device."""
    model = Transformer(cfg, device=generator.device)
    dt = cfg.dtype

    def dense(param, scale=None):
        param.copy_(common.dense_init(tuple(param.shape), param.dtype,
                                      generator=generator, scale=scale))

    with torch.no_grad():
        model.embed.copy_(common.embed_init(tuple(model.embed.shape), dt,
                                            generator=generator))
        if model.lm_head is not None:
            dense(model.lm_head)
        if model.frontend_proj is not None:
            dense(model.frontend_proj)
        for blk in model.blocks:
            if isinstance(blk.mixer, ssm.SSM):
                dense(blk.mixer.w_in)
                dense(blk.mixer.w_out)
                dense(blk.mixer.conv_w, scale=0.5)
                blk.mixer.D.fill_(1.0)
                blk.mixer.norm.fill_(1.0)
            else:
                for name in ("wq", "wk", "wv", "wo"):
                    dense(getattr(blk.mixer, name))
            if cfg.d_ff > 0:
                if isinstance(blk.ffn, moe.MoE):
                    dense(blk.ffn.router, scale=0.02)
                for name in ("w1", "w2", "w3"):
                    w = getattr(blk.ffn, name)
                    if w is not None:
                        dense(w)
    return model.to(device)


def init_caches(cfg: ModelConfig, *, paged: bool, batch: int = 0,
                max_len: int = 0, n_pages: int = 0, page_size: int = 16,
                binary: bool = True, state_pages: int | None = None,
                device=None) -> list[dict]:
    """One cache dict per layer. Self-attention layers: page pools when
    `paged` (see attention_block.init_paged_cache; n_pages, page_size),
    else dense per-slot caches (attention_block.init_cache; batch,
    max_len). Cross layers (attention_block.init_cross_cache) and SSM
    layers (ssm.init_state: float32 h, conv inputs): dense [batch, ...]
    per-slot state, or, with `state_pages`, a pool of state_pages entries
    plus one trash entry, addressed by serve_step's `state_tables`. Packed
    K bits when `binary`, else full-precision K."""
    out = []
    state_rows = batch if state_pages is None else state_pages + 1
    for kind in layer_kinds(cfg):
        if kind == "C":
            out.append(AB.init_cross_cache(cfg, state_rows, binary=binary,
                                           device=device))
        elif kind == "M":
            out.append(ssm.init_state(cfg, state_rows, device=device))
        elif paged:
            out.append(AB.init_paged_cache(cfg, n_pages, page_size,
                                           binary=binary, device=device))
        else:
            out.append(AB.init_cache(cfg, batch, max_len, binary=binary,
                                     device=device))
    return out


@torch.no_grad()
def fill_cross_caches(model: Transformer, caches: list[dict],
                      image_embeds: torch.Tensor, rows: torch.Tensor,
                      ok: torch.Tensor, *, pooled: bool,
                      binary: bool = True) -> None:
    """Fill every cross layer's cache from image embeddings, in place.

    image_embeds [R, T_img, frontend_dim]; rows [R] int: each embedding
    row's cache row (dense caches) or its pool entry (`pooled`); ok [R]
    bool: rows to write (the rest are dropped). The embeddings go through
    ``frontend_proj``, then each layer's wk / wv (JAX ``_image_context``
    and ``fill_cross_cache``)."""
    cfg = model.cfg
    img = image_embeds.to(cfg.dtype) @ model.frontend_proj   # [R, T, D]
    rows = rows.to(torch.int64)
    for kind, blk, cache in zip(layer_kinds(cfg), model.blocks, caches):
        if kind != "C":
            continue
        new = AB.fill_cross_cache(blk.mixer, img, cfg=cfg, binary=binary)
        if pooled:
            AB.cross_cache_write(cache, new, rows, ok)
            continue
        keep = ok.reshape(-1, 1, 1, 1)
        for name, leaf in cache.items():
            leaf.index_copy_(0, rows, torch.where(
                keep, new[name].to(leaf.dtype), leaf.index_select(0, rows)))


def _cross_view(cache: dict, st: torch.Tensor | None,
                st_ok: torch.Tensor | None,
                zero: torch.Tensor | None) -> dict:
    """A cross layer's cache as a [B, ...] view for one step: the dense
    cache itself, or each row's pool entry gathered through `st`. Rows in
    `zero` (fresh admissions without an image this step) are zeroed
    first, in place: the dense rows, or the pool entries of rows that
    hold one (rows without one read zeros)."""
    if st is None:
        if zero is not None:
            m = zero.reshape(-1, 1, 1, 1)
            for leaf in cache.values():
                leaf.masked_fill_(m, 0)
        return cache
    view = AB.cross_cache_read(cache, st)
    if zero is not None:
        m = zero.reshape(-1, 1, 1, 1)
        view = {name: leaf.masked_fill(m, 0) for name, leaf in view.items()}
        AB.cross_cache_write(cache, view, st, st_ok & zero)
    return view


def _ssm_serve(blk: Block, h: torch.Tensor, cache: dict, *,
               cfg: ModelConfig, st: torch.Tensor | None,
               st_ok: torch.Tensor | None, active: torch.Tensor | None,
               n_valid: torch.Tensor | None,
               fresh: torch.Tensor | None) -> torch.Tensor:
    """An SSM layer's step (JAX serve_step's "M" branch): read the rows'
    state (dense rows, or pool entries through `st`), zero the `fresh`
    rows' view, run the chunk (`ssm_forward`) or the decode step
    (`ssm_decode`), and write the new state back in place: pool entries
    of the `st_ok` rows, or the dense rows that are `active`."""
    view = cache if st is None else ssm.state_read(cache, st)
    if fresh is not None:
        view = {name: leaf.masked_fill(
            fresh.reshape((-1,) + (1,) * (leaf.ndim - 1)), 0)
            for name, leaf in view.items()}
    if h.shape[1] == 1:
        mix, new = ssm.ssm_decode(blk.mixer, h, cfg=cfg, state=view)
    else:
        mix, new = ssm.ssm_forward(blk.mixer, h, cfg=cfg, state=view,
                                   n_valid=n_valid)
    if st is not None:
        ssm.state_write(cache, new, st, st_ok)
    else:
        for name, leaf in cache.items():
            val = new[name].to(leaf.dtype)
            if active is not None:
                val = torch.where(
                    active.reshape((-1,) + (1,) * (leaf.ndim - 1)), val,
                    leaf)
            leaf.copy_(val)
    return mix


@torch.no_grad()
def serve_step(model: Transformer, tokens: torch.Tensor, caches: list[dict],
               *, pos: torch.Tensor, n: int,
               block_tables: torch.Tensor | None = None,
               active: torch.Tensor | None = None,
               n_valid: torch.Tensor | None = None,
               page_topn: int | None = None,
               binary: bool = True,
               state_tables: torch.Tensor | None = None,
               image_embeds: torch.Tensor | None = None,
               zero_fresh: bool = True,
               logits_mode: str = "all") -> torch.Tensor:
    """Prefill (tokens [B, S>1]) or decode (tokens [B, 1]) against the
    caches, which are updated in place.

    pos [B] int per-slot position of tokens[:, 0]; block_tables [B, nb]
    for paged caches, None for dense ones; active [B] bool rows whose cache
    writes land (others ride along and produce garbage logits); n_valid
    [B] real tokens per row of a padded chunk; page_topn: page-sparse
    decode over paged caches (ignored by prefill chunks and cross layers);
    binary: the HAD path over packed K bits, or (False) the full-precision
    baseline over caches made with init_caches(binary=False).

    Cross and SSM layers (JAX ``serve_step``'s "C" and "M" positions):
    state_tables [B] int entry ids when their state is pooled (-1: no
    entry; reads see entry 0, writes are dropped), else it is dense
    per-slot state. image_embeds [B, T_img, frontend_dim] fills the cross
    caches of the active rows (pooled: of active rows with an entry)
    before the layers run, as the JAX step does when its batch carries
    them. A row that starts a request in this chunk (active, pos 0,
    n_valid given) never sees the previous occupant's state: its SSM state
    reads zeros, and without images its cross cache is zeroed (the dense
    row or pool entry, in place). `zero_fresh=False` skips both zeros, for
    a caller that zeroes those rows itself before the step (the serving
    runner, outside its captured graphs). A decode step never writes a
    cross cache.

    logits_mode="last" returns each row's logits at its last valid
    position only. Returns float32 logits [B, S or 1, padded_vocab].
    """
    cfg = model.cfg
    b, s = tokens.shape
    st = st_ok = None
    if state_tables is not None:
        st = state_tables.to(torch.int64)
        st_ok = st >= 0 if active is None else (st >= 0) & active
    if image_embeds is not None:
        live = (torch.ones((b,), dtype=torch.bool, device=tokens.device)
                if active is None else active)
        if st is None:
            fill_cross_caches(model, caches, image_embeds,
                              torch.arange(b, device=tokens.device), live,
                              pooled=False, binary=binary)
        else:
            fill_cross_caches(model, caches, image_embeds, st, st_ok,
                              pooled=True, binary=binary)
    fresh = None
    if zero_fresh and n_valid is not None and active is not None:
        fresh = active & (pos == 0)
    # every active cross row is filled when images ride along
    zero = fresh if image_embeds is None else None
    x = model.embed[tokens.to(torch.int64)]                # [B, S, D]
    for kind, blk, cache in zip(layer_kinds(cfg), model.blocks, caches):
        h = common.rmsnorm(blk.norm1.w, x, eps=cfg.norm_eps)
        if kind == "M":
            x = x + _ssm_serve(blk, h, cache, cfg=cfg, st=st, st_ok=st_ok,
                               active=active, n_valid=n_valid, fresh=fresh)
        elif kind == "C":
            view = _cross_view(cache, st, st_ok, zero)
            x = x + AB.attn_serve(blk.mixer, h, cfg=cfg, cache=view,
                                  pos=pos, n=n, binary=binary, cross=True)
        else:
            x = x + AB.attn_serve(blk.mixer, h, cfg=cfg, cache=cache,
                                  pos=pos, n=n, block_tables=block_tables,
                                  n_valid=n_valid, active=active,
                                  page_topn=page_topn, binary=binary)
        if cfg.d_ff > 0:
            h2 = common.rmsnorm(blk.norm2.w, x, eps=cfg.norm_eps)
            if isinstance(blk.ffn, moe.MoE):
                x = x + moe.moe_ffn(blk.ffn, h2, cfg=cfg)
            else:
                x = x + common.mlp(blk.ffn.w1, blk.ffn.w2, blk.ffn.w3, h2,
                                   act=cfg.act)
    if logits_mode == "last":
        if n_valid is None:
            x = x[:, -1:]
        else:
            idx = (n_valid.to(torch.int64) - 1).clamp(0, s - 1)
            x = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    x = common.rmsnorm(model.final_norm.w, x, eps=cfg.norm_eps)
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    return common.unembed(x, head)
