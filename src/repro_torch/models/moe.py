"""Mixture-of-Experts FFN (torch twin of ``repro.models.moe``):
`moe_ffn` is JAX's ``moe_ffn(no_drop=True)``, the form the serve step
calls, and `moe_ffn_train` its training form (``no_drop=False``: capacity
int(tg * k * capacity_factor / E) + 1, tokens past it dropped, plus the
Switch load-balance aux loss).

Tokens are cut into groups of `tg` (at most 512; the group size shrinks
until it divides the token count, so groups may span batch rows), routed
top-k by a float32 softmax router (ties to the lowest expert, as
``lax.top_k``), their k gates renormalised, and placed in per-expert
capacity buffers, k-slot 0 of every token claiming its place before slot
1, and so on (GShard order); a token past an expert's capacity is dropped
from that expert. The JAX package builds one-hot dispatch and combine
tensors and contracts them; here each kept (token, slot) is copied into
its place of one static [E, G * cap, D] buffer (every shape fixed by the
step's, as CUDA graphs need), every expert runs one batched matmul over
its G * cap rows, and each token sums its k outputs weighted by its gates
rounded to the model dtype. The results equal the contraction's: every
buffer row holds one token or zeros, and only kept rows are read back.

The gates are the top k of a softmax over every expert, renormalised:
exactly the softmax over the top k logits (each is exp(l_i) over the sum
of the chosen exp(l_j)), which is how Granite's gate is published (top k
logits, then their softmax) and DBRX's (softmax, top k, then a sum-1
norm); the two orders differ in float32 rounding only. A config with a
`shared_expert_width` adds a SwiGLU expert of that width that every
token passes through (``ws1``, ``ws2``, ``ws3``) to the routed sum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common
from repro_torch.models.config import ModelConfig

GROUP_SIZE = 512


class MoE(nn.Module):
    """One MoE FFN's weights, named as the JAX tree's: a float32 router
    [D, E] and stacked expert weights w1 [E, D, F], w2 [E, F, D] and, for
    SwiGLU, w3 [E, D, F]; with a shared expert of width Fs, ws1 / ws3
    [D, Fs] and ws2 [Fs, D]."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.dtype

        def weight(*shape, dtype=dt):
            return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.router = weight(d, e, dtype=torch.float32)
        self.w1 = weight(e, d, f)
        self.w2 = weight(e, f, d)
        self.w3 = weight(e, d, f) if cfg.act == "swiglu" else None
        fs = cfg.shared_expert_width
        self.ws1 = weight(d, fs) if fs else None
        self.ws2 = weight(fs, d) if fs else None
        self.ws3 = weight(d, fs) if fs else None


def group_shape(tokens: int, cfg: ModelConfig) -> tuple[int, int, int]:
    """(groups G, tokens a group tg, capacity a group and expert cap) of
    serving's no-drop dispatch: 4x each expert's expected load, at least
    16, at most tg."""
    tg = min(GROUP_SIZE, tokens)
    while tokens % tg:
        tg -= 1
    expected = tg * cfg.experts_per_token / cfg.n_experts
    return tokens // tg, tg, min(tg, max(int(4 * expected) + 1, 16))


def train_group_shape(tokens: int, cfg: ModelConfig,
                      group_size: int = GROUP_SIZE) -> tuple[int, int, int]:
    """(groups G, tokens a group tg, capacity a group and expert cap) of
    training's dispatch: int(tg * k * capacity_factor / E) + 1 places,
    tokens past them dropped."""
    tg = min(group_size, tokens)
    while tokens % tg:
        tg -= 1
    cap = max(int(tg * cfg.experts_per_token * cfg.capacity_factor
                  / cfg.n_experts) + 1, 1)
    return tokens // tg, tg, cap


def _route(p: MoE, xg: torch.Tensor, cfg: ModelConfig):
    """(router probabilities [G, Tg, E] float32, gates, experts)."""
    k = cfg.experts_per_token
    probs = torch.softmax(xg.to(torch.float32) @ p.router, dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[..., :k], experts[..., :k]
    return (probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9),
            experts)


def route(p: MoE, xg: torch.Tensor, cfg: ModelConfig):
    """Top-k routing of grouped tokens xg [G, Tg, D]: (gates [G, Tg, k]
    float32, renormalised; experts [G, Tg, k] int64), each token's experts
    in descending probability, ties to the lowest expert (a stable sort;
    torch.topk does not promise the order of ties)."""
    return _route(p, xg, cfg)[1:]


def moe_ffn(p: MoE, x: torch.Tensor, *, cfg: ModelConfig) -> torch.Tensor:
    """x [B, S, D] -> y [B, S, D]."""
    b, s, d = x.shape
    g, tg, cap = group_shape(b * s, cfg)
    xg = x.reshape(g, tg, d)
    gates, experts = route(p, xg, cfg)
    y = _experts(p, xg, gates, experts, cap, cfg).reshape(b, s, d)
    return y if p.ws1 is None else y + shared_expert(p, x)


def shared_expert(p: MoE, x: torch.Tensor) -> torch.Tensor:
    """The shared SwiGLU expert every token passes through."""
    return common.mlp(p.ws1, p.ws2, p.ws3, x, act="swiglu")


def moe_ffn_train(p: MoE, x: torch.Tensor, *, cfg: ModelConfig,
                  group_size: int = GROUP_SIZE
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The training form: x [B, S, D] -> (y [B, S, D], aux load-balance
    loss, a float32 scalar E * sum_e f_e * p_e over top-1 token fractions
    f and mean router probabilities p). Each group's capacity is
    int(tg * k * capacity_factor / E) + 1; tokens past it are dropped."""
    b, s, d = x.shape
    e = cfg.n_experts
    g, tg, cap = train_group_shape(b * s, cfg, group_size)
    xg = x.reshape(g, tg, d)
    probs, gates, experts = _route(p, xg, cfg)
    y = _experts(p, xg, gates, experts, cap, cfg).reshape(b, s, d)
    if p.ws1 is not None:
        y = y + shared_expert(p, x)
    # a comparison, as _experts builds its one-hots: F.one_hot is a
    # scatter on the CPU and the card but not on the meta device, so the
    # dry run's counts would differ by device
    top1 = (experts[..., 0, None] == torch.arange(e, device=x.device)
            ).to(torch.float32)
    aux = e * (top1.mean((0, 1)) * probs.mean((0, 1))).sum()
    return y, aux


def _experts(p: MoE, xg: torch.Tensor, gates: torch.Tensor,
             experts: torch.Tensor, cap: int,
             cfg: ModelConfig) -> torch.Tensor:
    """Dispatch grouped tokens xg [G, Tg, D] to per-expert buffers of
    `cap` places a group, run the experts, combine: y [G, Tg, D]."""
    g, tg, d = xg.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    dev = xg.device
    # each kept (token, slot) gets row experts * (G * cap) + g * cap + pos
    # of the [E * G * cap] expert buffer; dropped ones point at its extra
    # trash row, which no expert reads
    rows, keeps = [], []
    fill = torch.zeros((g, e), dtype=torch.int64, device=dev)
    one_hot_of = torch.arange(e, device=dev)
    base = torch.arange(g, device=dev)[:, None] * cap              # [G, 1]
    for slot in range(k):
        idx = experts[..., slot]                                    # [G, Tg]
        oh = (idx[..., None] == one_hot_of).to(torch.int64)         # [G,Tg,E]
        pos_in_e = fill[:, None, :] + torch.cumsum(oh, dim=1) - oh
        pos = pos_in_e.gather(2, idx[..., None])[..., 0]
        keep = pos < cap
        rows.append(torch.where(keep, idx * (g * cap) + base + pos,
                                e * g * cap))
        keeps.append(keep)
        fill = fill + oh.sum(1)
    buf = torch.zeros((e * g * cap + 1, d), dtype=xg.dtype, device=dev)
    flat = xg.reshape(g * tg, d)
    for r in rows:
        buf.index_copy_(0, r.reshape(-1), flat)
    ein = buf[:-1].view(e, g * cap, d)
    h = torch.bmm(ein, p.w1)                                   # [E, G*cap, F]
    if cfg.act == "swiglu":
        h = F.silu(h) * torch.bmm(ein, p.w3)
    else:
        h = F.gelu(h, approximate="tanh")
    out = torch.bmm(h, p.w2).view(e * g * cap, d)
    y = torch.zeros((g, tg, d), dtype=torch.float32, device=dev)
    for slot, (r, keep) in enumerate(zip(rows, keeps)):
        got = out.index_select(0, r.reshape(-1).clamp_max(e * g * cap - 1))
        w = gates[..., slot].to(xg.dtype).to(torch.float32)[..., None]
        y = y + torch.where(keep[..., None], w * got.view(g, tg, d).to(
            torch.float32), torch.zeros((), device=dev))
    return y.to(xg.dtype)
