"""Model assembly (torch twin of ``repro.models.transformer``): the
training / evaluation forward, the distillation forward and the serving
step.

`Transformer` holds per-layer `Block`s whose parameter names follow the
JAX tree (``blocks/pos0/{norm1,mixer,norm2,ffn}``), with the JAX
package's leading ``n_groups`` axis unstacked into a list of layers; the
JAX ``lax.scan`` over groups is a Python loop here. Layer
``g * len(layer_pattern) + i`` is group g of pattern position i.

A layer's mixer is picked by its pattern character: self-attention ("A"),
cross-attention ("C") or a Mamba2 SSM ("M", models/ssm.py); its FFN is an
MoE (models/moe.py) at the pattern positions `layer_uses_moe` names,
else a dense MLP. Inputs are token embeddings, or `frames` through
``frontend_proj`` (the audio / vision stub frontend of the encoders and
of frames requests), plus learned positions (``pos_embed``) where the
config has them; attention is causal or, for encoders, bidirectional.

`forward` runs every mode of ``attention_block.attn_forward``;
`forward_distill` runs teacher and student side by side with the Eq. 9
KL. With ``cfg.remat`` both run each group of layers (and, for groups of
more than one layer, each layer inside it) under
``torch.utils.checkpoint``, as JAX nests ``jax.checkpoint``. The student
of `student_subset` is a `Transformer` whose trainable tensors are its
own and whose other tensors are the teacher's, shared.

Granite's multipliers (`embedding_multiplier`, `residual_multiplier`,
`logits_scaling`; see models/config.py) act where the published model
applies them: the token embeddings, each mixer's and FFN's output before
the residual add, the logits. At 1 they add no operation.

`serve_step` serves decoders on the binary path or the full-precision
baseline, over the paged or the dense cache. Cross layers attend the
image K/V of a static cache, filled from per-request image embeddings
(``frontend_proj``, then each layer's wk/wv); SSM layers carry {h, conv}
state. Both kinds of state are dense per-slot rows, or entries of a state
pool addressed by ``state_tables`` when the engine pools state.
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import losses
from repro_torch.distributed import collectives
from repro_torch.models import attention_block as AB
from repro_torch.models import common, moe, ssm
from repro_torch.models.config import ModelConfig


#: serve_step's region of a layer's mixer, by its pattern character
MIXER_REGIONS = {"A": "attn", "C": "cross", "M": "ssm"}


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
        self.cfg = cfg
        d, v, dt = cfg.d_model, cfg.padded_vocab, cfg.dtype
        self.embed = nn.Parameter(torch.zeros((v, d), dtype=dt, device=device),
                                  requires_grad=False)
        self.final_norm = RMSNorm(d, dt, device)
        self.lm_head = (None if cfg.tie_embeddings else nn.Parameter(
            torch.zeros((d, v), dtype=dt, device=device), requires_grad=False))
        # frames or image embeddings [.., frontend_dim] -> the model width
        self.frontend_proj = (nn.Parameter(torch.zeros(
            (cfg.frontend_dim, d), dtype=dt, device=device),
            requires_grad=False) if cfg.frontend_dim else None)
        self.pos_embed = (nn.Parameter(torch.zeros(
            (cfg.max_pos, d), dtype=dt, device=device), requires_grad=False)
            if cfg.pos == "learned" else None)
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
    in the JAX package), normal * 0.02 for the embeddings (tokens and
    learned positions), ones for norms;
    SSM layers: A_log 0, D 1, dt_bias 0, conv_w at std 0.5, conv_b 0;
    MoE routers float32 at std 0.02 (the JAX init's distributions;
    jax.random's numbers differ). Drawn on the
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
        if model.pos_embed is not None:
            model.pos_embed.copy_(common.embed_init(
                tuple(model.pos_embed.shape), dt, generator=generator))
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
                for name in ("w1", "w2", "w3", "ws1", "ws2", "ws3"):
                    w = getattr(blk.ffn, name, None)
                    if w is not None:
                        dense(w)
    return model.to(device)


# ---------------------------------------------------------------------------
# the student
# ---------------------------------------------------------------------------

def _share(mod: nn.Module, **own) -> nn.Module:
    """A new module of mod's class holding mod's parameters, buffers and
    children (the same tensors), with the `own` attributes replaced."""
    new = mod.__class__.__new__(mod.__class__)
    new.__dict__.update(mod.__dict__)
    for slot in ("_parameters", "_buffers", "_modules"):
        new.__dict__[slot] = dict(mod.__dict__[slot])
    for name, val in own.items():
        setattr(new, name, val)
    return new


def merge_student(cfg: ModelConfig, teacher: Transformer,
                  student: Transformer) -> Transformer:
    """The student's trainable subset (``cfg.trainable``) overlaid on the
    teacher: with "all", the student itself; with "attention", a model
    whose A / C layers hold the student's mixer and norm1 and whose every
    other tensor is the teacher's."""
    if cfg.trainable == "all":
        return student
    return _share(teacher, blocks=nn.ModuleList(
        _share(tb, mixer=sb.mixer, norm1=sb.norm1) if kind in "AC" else tb
        for kind, tb, sb in zip(layer_kinds(cfg), teacher.blocks,
                                student.blocks)))


def student_subset(cfg: ModelConfig, teacher: Transformer) -> Transformer:
    """The student (Alg. 1 line 1): "all" -> a full copy of the teacher;
    "attention" -> copies of the A / C mixers (sigmas included) and their
    norm1, every other tensor the teacher's own, shared and not copied.
    The copied tensors require grad (`student_tensors`), the teacher's do
    not."""
    if cfg.trainable == "all":
        student = copy.deepcopy(teacher)
    else:
        student = _share(teacher, blocks=nn.ModuleList(
            _share(b, mixer=copy.deepcopy(b.mixer),
                   norm1=copy.deepcopy(b.norm1)) if kind in "AC" else b
            for kind, b in zip(layer_kinds(cfg), teacher.blocks)))
    for t in student_tensors(cfg, student).values():
        t.requires_grad_(True)
    return student


def named_tensors(model: Transformer) -> dict[str, torch.Tensor]:
    """Every parameter and buffer of `model` by its module path."""
    out = dict(model.named_parameters())
    out.update(model.named_buffers())
    return out


def student_tensors(cfg: ModelConfig,
                    student: Transformer) -> dict[str, torch.Tensor]:
    """The student's own tensors, JAX's `student_subset` tree leaves:
    every tensor ("all"), or the A / C layers' mixer tensors and norm1
    ("attention"). sigma_q / sigma_k are among them (the optimizer skips
    them)."""
    named = named_tensors(student)
    if cfg.trainable == "all":
        return named
    kinds = layer_kinds(cfg)
    return {name: t for name, t in named.items()
            if name.startswith("blocks.")
            and kinds[int(name.split(".")[1])] in "AC"
            and name.split(".")[2] in ("mixer", "norm1")}


# ---------------------------------------------------------------------------
# training / evaluation forward
# ---------------------------------------------------------------------------

def _residual(y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A mixer's or an FFN's output as it joins the residual stream."""
    m = cfg.residual_multiplier
    return y if m == 1.0 else y * m


def _embed_scaled(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    m = cfg.embedding_multiplier
    return x if m == 1.0 else x * m


def _logits_scaled(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    m = cfg.logits_scaling
    return logits if m == 1.0 else logits / m


def _embed_inputs(model: Transformer, batch: dict,
                  cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings, or `frames` [B, S, frontend_dim] through
    frontend_proj (the audio / vision stub frontend), plus learned
    positions."""
    if "frames" in batch:
        x = batch["frames"].to(cfg.dtype) @ model.frontend_proj
    else:
        x = _embed_scaled(model.embed[batch["tokens"].to(torch.int64)], cfg)
    if cfg.pos == "learned":
        x = x + model.pos_embed[:x.shape[1]][None]
    return x


def _image_context(model: Transformer, batch: dict,
                   cfg: ModelConfig) -> torch.Tensor | None:
    if "C" not in cfg.layer_pattern or "image_embeds" not in batch:
        return None
    return batch["image_embeds"].to(cfg.dtype) @ model.frontend_proj


def _ffn(blk: Block, h: torch.Tensor, cfg: ModelConfig):
    """(y, MoE aux loss) of a layer's FFN on the training path."""
    if isinstance(blk.ffn, moe.MoE):
        return moe.moe_ffn_train(blk.ffn, h, cfg=cfg)
    return (common.mlp(blk.ffn.w1, blk.ffn.w2, blk.ffn.w3, h, act=cfg.act),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _layer_fwd(blk: Block, x: torch.Tensor, kind: str, *, cfg: ModelConfig,
               mode: str, att: dict, img: torch.Tensor | None):
    h = common.rmsnorm(blk.norm1.w, x, eps=cfg.norm_eps)
    if kind == "M":
        mix, _ = ssm.ssm_forward(blk.mixer, h, cfg=cfg)
    else:
        mix = AB.attn_forward(blk.mixer, h, cfg=cfg, mode=mode, att=att,
                              x_kv=img if kind == "C" else None,
                              cross=kind == "C")
    x = x + _residual(mix, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.d_ff > 0:
        y, aux = _ffn(blk, common.rmsnorm(blk.norm2.w, x, eps=cfg.norm_eps),
                      cfg)
        x = x + _residual(y, cfg)
    return x, aux


def _run_layers(cfg: ModelConfig, layer_fn, carry: tuple) -> tuple:
    """carry = layer_fn(layer, *carry) over every layer, group by group.
    With cfg.remat (and gradients on), each group runs under a checkpoint,
    and so does each layer of a group of more than one (JAX's nested
    jax.checkpoint)."""
    span = cfg.group_size
    remat = cfg.remat and torch.is_grad_enabled()

    def group(g, *carry):
        for i in range(span):
            if remat and span > 1:
                carry = checkpoint(layer_fn, g * span + i, *carry,
                                   use_reentrant=False)
            else:
                carry = layer_fn(g * span + i, *carry)
        return carry

    for g in range(cfg.n_groups):
        carry = (checkpoint(group, g, *carry, use_reentrant=False) if remat
                 else group(g, *carry))
    return carry


class ForwardOut(NamedTuple):
    logits: torch.Tensor
    moe_aux: torch.Tensor


def _final(model: Transformer, x: torch.Tensor, cfg: ModelConfig):
    return common.rmsnorm(model.final_norm.w, x, eps=cfg.norm_eps)


def _unembed(model: Transformer, h: torch.Tensor, cfg: ModelConfig):
    return _logits_scaled(common.unembed(
        h, model.embed.T if cfg.tie_embeddings else model.lm_head), cfg)


def _head(model: Transformer, x: torch.Tensor, cfg: ModelConfig):
    return _unembed(model, _final(model, x, cfg), cfg)


def forward(model: Transformer, batch: dict, *, cfg: ModelConfig,
            mode: str = "std", att: dict | None = None) -> ForwardOut:
    """Full forward: logits [B, S, padded_vocab] float32 and the mean MoE
    aux loss over layers. mode: std | fp_topn | had_train | had_eval |
    sab_train | sab_eval (see attention_block.attn_forward). batch holds
    `tokens` [B, S] or `frames` [B, S, frontend_dim], and `image_embeds`
    for cross layers."""
    att = dict(att or {})
    kinds = layer_kinds(cfg)
    img = _image_context(model, batch, cfg)

    def layer(i, x, acc):
        x, aux = _layer_fwd(model.blocks[i], x, kinds[i], cfg=cfg,
                            mode=mode, att=att, img=img)
        return x, acc + aux

    x, acc = _run_layers(cfg, layer, (
        _embed_inputs(model, batch, cfg),
        torch.zeros((), dtype=torch.float32, device=model.embed.device)))
    return ForwardOut(_head(model, x, cfg), acc / max(cfg.n_layers, 1))


class DistillOut(NamedTuple):
    teacher_logits: torch.Tensor
    student_logits: torch.Tensor
    attention_kl: torch.Tensor     # Eq. 9 mean over all rows and maps
    moe_aux: torch.Tensor


def forward_distill(teacher: Transformer, student: Transformer, batch: dict,
                    *, cfg: ModelConfig, att: dict) -> DistillOut:
    """Combined teacher / student forward for the distillation step: the
    teacher through the standard path, the student through the
    stage-scheduled binarized path; the Eq. 9 KL accumulates over every
    attention map of every layer ('A' and 'C')."""
    ht, hs, kl, aux = distill_hidden(teacher, student, batch, cfg=cfg,
                                     att=att)
    return DistillOut(_unembed(teacher, ht, cfg), _unembed(student, hs, cfg),
                      kl, aux)


# output_kl_from_hidden's rows per block: about 2**24 logits (64 MB in
# float32)
KL_BLOCK_LOGITS = 1 << 24


def output_kl_from_hidden(teacher: Transformer, student: Transformer,
                          ht: torch.Tensor, hs: torch.Tensor, *,
                          cfg: ModelConfig) -> torch.Tensor:
    """Eq. 10 (`losses.output_kl` with the padded vocabulary masked) on
    the logits of the final hidden rows ht / hs [..., D] through each
    model's head, a block of about KL_BLOCK_LOGITS logits at a time under
    a checkpoint: the [rows, vocab] logits never exist in full (a
    full-vocabulary LM's take 1.6 GB a model at 8192 positions, and their
    gradient as much again). Each row's KL is the unblocked one's."""
    d = ht.shape[-1]
    t2, s2 = ht.reshape(-1, d), hs.reshape(-1, d)
    rows = max(1, KL_BLOCK_LOGITS // cfg.padded_vocab)
    mask = (None if cfg.vocab_size == cfg.padded_vocab else
            torch.arange(cfg.padded_vocab, device=ht.device)
            < cfg.vocab_size)

    def block(t, s):
        lt, ls = _unembed(teacher, t, cfg), _unembed(student, s, cfg)
        return losses.kl_divergence(
            lt, ls, mask=None if mask is None else torch.broadcast_to(
                mask, lt.shape))

    per = [checkpoint(block, t2[i:i + rows], s2[i:i + rows],
                      use_reentrant=False) if torch.is_grad_enabled()
           else block(t2[i:i + rows], s2[i:i + rows])
           for i in range(0, t2.shape[0], rows)]
    return torch.cat(per).mean()


def distill_hidden(teacher: Transformer, student: Transformer, batch: dict,
                   *, cfg: ModelConfig, att: dict):
    """`forward_distill` up to the heads: (teacher and student final-normed
    hidden states [B, S, D], the attention KL, the mean MoE aux)."""
    att = dict(att)
    kinds = layer_kinds(cfg)
    img_t = _image_context(teacher, batch, cfg)
    img_s = _image_context(student, batch, cfg)

    def layer(i, xt, xs, kl, rows, acc):
        bt, bs, kind = teacher.blocks[i], student.blocks[i], kinds[i]
        ht = common.rmsnorm(bt.norm1.w, xt, eps=cfg.norm_eps)
        hs = common.rmsnorm(bs.norm1.w, xs, eps=cfg.norm_eps)
        if kind == "M":
            xt = xt + _residual(ssm.ssm_forward(bt.mixer, ht, cfg=cfg)[0],
                                cfg)
            xs = xs + _residual(ssm.ssm_forward(bs.mixer, hs, cfg=cfg)[0],
                                cfg)
        else:
            cross = kind == "C"
            yt, ys, kl_i, rows_i = AB.attn_forward_distill(
                bt.mixer, bs.mixer, ht, hs, cfg=cfg, att=att,
                xt_kv=img_t if cross else None,
                xs_kv=img_s if cross else None, cross=cross)
            xt, xs = xt + _residual(yt, cfg), xs + _residual(ys, cfg)
            kl, rows = kl + kl_i, rows + rows_i
        if cfg.d_ff > 0:
            ft, _ = _ffn(bt, common.rmsnorm(bt.norm2.w, xt,
                                            eps=cfg.norm_eps), cfg)
            fs, m = _ffn(bs, common.rmsnorm(bs.norm2.w, xs,
                                            eps=cfg.norm_eps), cfg)
            xt, xs = xt + _residual(ft, cfg), xs + _residual(fs, cfg)
            acc = acc + m
        return xt, xs, kl, rows, acc

    zero = torch.zeros((), dtype=torch.float32, device=teacher.embed.device)
    xt, xs, kl, rows, acc = _run_layers(cfg, layer, (
        _embed_inputs(teacher, batch, cfg), _embed_inputs(student, batch, cfg),
        zero, zero, zero))
    return (_final(teacher, xt, cfg), _final(student, xs, cfg),
            kl / rows.clamp_min(1.0), acc / max(cfg.n_layers, 1))


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
                zero: torch.Tensor | None,
                slots: torch.Tensor | None = None) -> dict:
    """A cross layer's cache as a [B, ...] view for one step: the dense
    cache itself, its rows `slots`, or each row's pool entry gathered
    through `st`. Rows in `zero` (fresh admissions without an image this
    step) are zeroed first, in place: the dense rows, or the pool entries
    of rows that hold one (rows without one read zeros)."""
    if st is None and slots is None:
        if zero is not None:
            m = zero.reshape(-1, 1, 1, 1)
            for leaf in cache.values():
                leaf.masked_fill_(m, 0)
        return cache
    view = AB.cross_cache_read(cache, slots if st is None else st)
    if zero is not None:
        m = zero.reshape(-1, 1, 1, 1)
        view = {name: leaf.masked_fill(m, 0) for name, leaf in view.items()}
        if st is None:
            for name, leaf in cache.items():
                leaf.index_copy_(0, slots, view[name])
        else:
            AB.cross_cache_write(cache, view, st, st_ok & zero)
    return view


def _ssm_serve(blk: Block, h: torch.Tensor, cache: dict, *,
               cfg: ModelConfig, st: torch.Tensor | None,
               st_ok: torch.Tensor | None, active: torch.Tensor | None,
               n_valid: torch.Tensor | None,
               fresh: torch.Tensor | None,
               slots: torch.Tensor | None = None) -> torch.Tensor:
    """An SSM layer's step (JAX serve_step's "M" branch): read the rows'
    state (dense rows, the dense rows `slots`, or pool entries through
    `st`), zero the `fresh` rows' view, run the chunk (`ssm_forward`) or
    the decode step (`ssm_decode`), and write the new state back in
    place: pool entries of the `st_ok` rows, or the dense rows that are
    `active`."""
    if st is not None:
        view = ssm.state_read(cache, st)
    else:
        view = rows = (cache if slots is None
                       else ssm.state_read(cache, slots))
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
                    rows[name])
            if slots is None:
                leaf.copy_(val)
            else:
                leaf.index_copy_(0, slots, val)
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
               logits_mode: str = "all",
               frames: torch.Tensor | None = None,
               frames_rows: torch.Tensor | None = None,
               slots: torch.Tensor | None = None,
               group=None, marks=None) -> torch.Tensor:
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

    frames [B, S, frontend_dim] embeds a prefill chunk through
    ``frontend_proj`` instead of the token table (JAX ``_embed_inputs``),
    in the rows `frames_rows` [B] bool (default: every row). Learned
    positions add ``pos_embed[:S]``, as the JAX step does.

    slots [B] int: the row (slot) of the dense caches that each batch row
    reads and writes (the serving runner's one-row prefill chunk);
    default: row b is slot b. Page pools and pooled state are addressed by
    their tables instead.

    logits_mode="last" returns each row's logits at its last valid
    position only. Returns float32 logits [B, S or 1, padded_vocab].

    group: tensor-parallel serving's process group. `model` and `caches`
    then hold this rank's shard (``checkpoint.bridge.shard_model``: its
    heads, the kv heads of every k_bits / k / v leaf, and the lm_head's
    vocabulary slice when it was sharded); each attention layer gathers
    its context over the group's heads, and vocabulary-sharded logits are
    gathered at the end, so every rank returns the full logits, equal bit
    for bit to one device's.

    marks: called with a region's name where it ends, and with "start"
    first: "embed", each layer's mixer (`MIXER_REGIONS`) and FFN ("mlp",
    "moe"), then "head" (the last-row gather, final norm and unembedding);
    the serving runner's region timer. It launches nothing.
    """
    cfg = model.cfg
    b, s = tokens.shape
    if marks is not None:
        marks("start")
    st = st_ok = None
    if state_tables is not None:
        st = state_tables.to(torch.int64)
        st_ok = st >= 0 if active is None else (st >= 0) & active
    if slots is not None:
        slots = slots.to(torch.int64)
    if image_embeds is not None:
        live = (torch.ones((b,), dtype=torch.bool, device=tokens.device)
                if active is None else active)
        if st is None:
            fill_cross_caches(model, caches, image_embeds,
                              torch.arange(b, device=tokens.device)
                              if slots is None else slots, live,
                              pooled=False, binary=binary)
        else:
            fill_cross_caches(model, caches, image_embeds, st, st_ok,
                              pooled=True, binary=binary)
    fresh = None
    if zero_fresh and n_valid is not None and active is not None:
        fresh = active & (pos == 0)
    # every active cross row is filled when images ride along
    zero = fresh if image_embeds is None else None
    x = _embed_scaled(model.embed[tokens.to(torch.int64)], cfg)  # [B,S,D]
    if frames is not None:
        fx = frames.to(cfg.dtype) @ model.frontend_proj
        x = fx if frames_rows is None else torch.where(
            frames_rows[:, None, None], fx, x)
    if cfg.pos == "learned":
        x = x + model.pos_embed[:s][None]
    if marks is not None:
        marks("embed")
    for kind, blk, cache in zip(layer_kinds(cfg), model.blocks, caches):
        h = common.rmsnorm(blk.norm1.w, x, eps=cfg.norm_eps)
        if kind == "M":
            mix = _ssm_serve(blk, h, cache, cfg=cfg, st=st, st_ok=st_ok,
                             active=active, n_valid=n_valid, fresh=fresh,
                             slots=slots)
        elif kind == "C":
            view = _cross_view(cache, st, st_ok, zero, slots)
            mix = AB.attn_serve(blk.mixer, h, cfg=cfg, cache=view, pos=pos,
                                n=n, binary=binary, cross=True, group=group)
        else:
            mix = AB.attn_serve(blk.mixer, h, cfg=cfg, cache=cache, pos=pos,
                                n=n, block_tables=block_tables,
                                n_valid=n_valid, active=active,
                                page_topn=page_topn, binary=binary,
                                slots=slots, group=group)
        x = x + _residual(mix, cfg)
        if marks is not None:
            marks(MIXER_REGIONS[kind])
        if cfg.d_ff > 0:
            h2 = common.rmsnorm(blk.norm2.w, x, eps=cfg.norm_eps)
            if isinstance(blk.ffn, moe.MoE):
                y = moe.moe_ffn(blk.ffn, h2, cfg=cfg)
            else:
                y = common.mlp(blk.ffn.w1, blk.ffn.w2, blk.ffn.w3, h2,
                               act=cfg.act)
            x = x + _residual(y, cfg)
            if marks is not None:
                marks("moe" if isinstance(blk.ffn, moe.MoE) else "mlp")
    if logits_mode == "last":
        if n_valid is None:
            x = x[:, -1:]
        else:
            idx = (n_valid.to(torch.int64) - 1).clamp(0, s - 1)
            x = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    x = common.rmsnorm(model.final_norm.w, x, eps=cfg.norm_eps)
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    logits = _logits_scaled(common.unembed_blocked(x, head), cfg)
    if logits.shape[-1] != cfg.padded_vocab:
        # a vocabulary-sharded lm_head: each column is a whole dot product
        # (the model dim is not split), so gathering the ranks' columns in
        # rank order gives one device's logits exactly
        logits = collectives.all_gather_last(logits, group)
    if marks is not None:
        marks("head")
    return logits
