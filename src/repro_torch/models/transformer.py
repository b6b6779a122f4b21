"""Dense decoder LM for serving (torch twin of the serving half of
``repro.models.transformer``).

`Transformer` holds per-layer `Block`s whose parameter names follow the
JAX tree (``blocks/pos0/{norm1,mixer,norm2,ffn}``), with the JAX
package's leading ``n_groups`` axis unstacked into a list of layers; the
JAX ``lax.scan`` over groups is a Python loop here.

This slice serves dense decoders whose layer pattern is all "A" (e.g.
smollm-135m) on the binary path or the full-precision baseline, over the
paged or the dense cache; other families raise.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention_block as AB
from repro_torch.models import common
from repro_torch.models.config import ModelConfig


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for model families this slice lacks."""
    todo = ("is not ported yet: see ROADMAP.md queue 1, 'Still to port' "
            "(hybrid, cross-attention, MoE and frontends)")
    if set(cfg.layer_pattern) != {"A"}:
        raise NotImplementedError(
            f"{cfg.name}: layer pattern {cfg.layer_pattern!r} with SSM "
            f"('M') or cross-attention ('C') layers {todo}")
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: an MoE FFN {todo}")
    if not cfg.causal or cfg.pos != "rope" or cfg.frontend_dim:
        raise NotImplementedError(
            f"{cfg.name}: an encoder, learned positions or a frontend "
            f"{todo}")


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
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.mixer = AB.Attention(cfg, device=device)
        if cfg.d_ff > 0:
            self.norm2 = RMSNorm(cfg.d_model, cfg.dtype, device)
            self.ffn = MLP(cfg, device)


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
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))

    def refresh_scales(self) -> None:
        """Recompute every layer's logit scale after sigmas were loaded."""
        for blk in self.blocks:
            blk.mixer.refresh_scale()


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cpu") -> Transformer:
    """Seeded random weights: truncated normal at fan-in std for dense
    weights, normal * 0.02 for the embedding, ones for norms (the JAX
    init's distributions; jax.random's numbers differ). Drawn on the CPU
    generator, then moved to `device`."""
    model = Transformer(cfg, device="cpu")
    dt = cfg.dtype

    def dense(param):
        param.copy_(common.dense_init(tuple(param.shape), dt,
                                      generator=generator))

    with torch.no_grad():
        model.embed.copy_(common.embed_init(tuple(model.embed.shape), dt,
                                            generator=generator))
        if model.lm_head is not None:
            dense(model.lm_head)
        for blk in model.blocks:
            for name in ("wq", "wk", "wv", "wo"):
                dense(getattr(blk.mixer, name))
            if cfg.d_ff > 0:
                for name in ("w1", "w2", "w3"):
                    w = getattr(blk.ffn, name)
                    if w is not None:
                        dense(w)
    return model.to(device)


def init_caches(cfg: ModelConfig, *, paged: bool, batch: int = 0,
                max_len: int = 0, n_pages: int = 0, page_size: int = 16,
                binary: bool = True, device=None) -> list[dict]:
    """One cache dict per layer: page pools when `paged` (see
    attention_block.init_paged_cache; n_pages, page_size), else dense
    per-slot caches (attention_block.init_cache; batch, max_len); packed
    K bits when `binary`, else full-precision K."""
    if paged:
        return [AB.init_paged_cache(cfg, n_pages, page_size, binary=binary,
                                    device=device)
                for _ in range(cfg.n_layers)]
    return [AB.init_cache(cfg, batch, max_len, binary=binary, device=device)
            for _ in range(cfg.n_layers)]


@torch.no_grad()
def serve_step(model: Transformer, tokens: torch.Tensor, caches: list[dict],
               *, pos: torch.Tensor, n: int,
               block_tables: torch.Tensor | None = None,
               active: torch.Tensor | None = None,
               n_valid: torch.Tensor | None = None,
               page_topn: int | None = None,
               binary: bool = True,
               logits_mode: str = "all") -> torch.Tensor:
    """Prefill (tokens [B, S>1]) or decode (tokens [B, 1]) against the
    caches, which are updated in place.

    pos [B] int per-slot position of tokens[:, 0]; block_tables [B, nb]
    for paged caches, None for dense ones; active [B] bool rows whose cache
    writes land (others ride along and produce garbage logits); n_valid
    [B] real tokens per row of a padded chunk; page_topn: page-sparse
    decode over paged caches (ignored by prefill chunks); binary: the HAD
    path over packed K bits, or (False) the full-precision baseline over
    caches made with init_caches(binary=False).
    logits_mode="last" returns each row's logits at its last valid
    position only. Returns float32 logits [B, S or 1, padded_vocab].
    """
    cfg = model.cfg
    s = tokens.shape[1]
    x = model.embed[tokens.to(torch.int64)]                # [B, S, D]
    for blk, cache in zip(model.blocks, caches):
        h = common.rmsnorm(blk.norm1.w, x, eps=cfg.norm_eps)
        x = x + AB.attn_serve(blk.mixer, h, cfg=cfg, cache=cache, pos=pos,
                              n=n, block_tables=block_tables,
                              n_valid=n_valid, active=active,
                              page_topn=page_topn, binary=binary)
        if cfg.d_ff > 0:
            h2 = common.rmsnorm(blk.norm2.w, x, eps=cfg.norm_eps)
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
