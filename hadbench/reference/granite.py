"""Plain float32 reference of granite-4.0-h-small (GraniteMoeHybrid, as
published), with HAD in its attention layers: whole sequences, no kernel,
cache, paging or batching, every layer's weights drawn again and freed
before the next. It imports nothing of the program.

Per layer (pattern ``MMMMMAMMMM``: 36 Mamba2 mixers, 4 attention layers),
with x0 = embed[tokens] * embedding_multiplier:

  x = x + residual_multiplier * mixer(rmsnorm(x) * norm1.w)
  x = x + residual_multiplier * ffn(rmsnorm(x) * norm2.w)
  logits = (rmsnorm(x) * final_norm.w) @ embed.T / logits_scaling

Mamba2 mixer (one B/C group, head size P, state size N, NH heads):
[x, z, B, C, dt] = h @ w_in; x, B and C go through the causal depthwise
conv of 4 taps with its bias, then silu; dt = softplus(dt + dt_bias),
A = -exp(A_log); per head h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T and
y_t = C_t . h_t + D x_t, computed as an SSD over the whole sequence in
chunks of ``ssm_chunk`` (the quadratic form inside a chunk, the state
carried between chunks); out = rmsnorm(y * silu(z)) * norm @ w_out.

Attention: no positional encoding, GQA; HAD's sign scores and top-N
keys (`model.had_attention`) with scale sigma_q * sigma_k *
attention_multiplier. FFN: the router's float32 logits, each token's top
k of them (ties to the lower expert) and a softmax over those k, the
chosen experts' SwiGLU outputs weighted by it (only the routed rows are
computed), plus the shared SwiGLU expert every token passes through.

`quant="fp8"` is the control, as in ``model.py``: every matrix product
(x @ w) from float8 operands; the conv, the SSD and the attention scores
are not matrix products of weights and stay float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from hadbench import weights
from hadbench.reference import model as base

topn = base.topn


def kinds(port: dict) -> str:
    """Every layer's pattern character, in layer order."""
    pat = port["layer_pattern"]
    return pat * (port["n_layers"] // len(pat))


def ssm_sizes(port: dict) -> dict:
    di = port["ssm_expand"] * port["d_model"]
    n, hd = port["ssm_state"], port["ssm_head_dim"]
    return {"di": di, "n": n, "hd": hd, "nh": di // hd,
            "conv": di + 2 * n}


def layer_specs(port: dict, i: int) -> list[tuple[str, tuple, str]]:
    """(name, shape, dtype name) of layer i's tensors, the port's names."""
    d, f, e = port["d_model"], port["d_ff"], port["n_experts"]
    fs, dt = port["shared_expert_width"], port["param_dtype"]
    p = f"blocks.{i}."
    if kinds(port)[i] == "M":
        s = ssm_sizes(port)
        mixer = [(p + "mixer.w_in", (d, 2 * s["di"] + 2 * s["n"] + s["nh"]),
                  dt),
                 (p + "mixer.w_out", (s["di"], d), dt),
                 (p + "mixer.A_log", (s["nh"],), "float32"),
                 (p + "mixer.D", (s["nh"],), "float32"),
                 (p + "mixer.dt_bias", (s["nh"],), "float32"),
                 (p + "mixer.conv_w", (4, s["conv"]), dt),
                 (p + "mixer.conv_b", (s["conv"],), dt),
                 (p + "mixer.norm", (s["di"],), dt)]
    else:
        h, hk, dh = port["n_heads"], port["n_kv_heads"], port["head_dim"]
        mixer = [(p + "mixer.wq", (d, h * dh), dt),
                 (p + "mixer.wk", (d, hk * dh), dt),
                 (p + "mixer.wv", (d, hk * dh), dt),
                 (p + "mixer.wo", (h * dh, d), dt)]
    return ([(p + "norm1.w", (d,), dt)] + mixer
            + [(p + "norm2.w", (d,), dt),
               (p + "ffn.router", (d, e), "float32"),
               (p + "ffn.w1", (e, d, f), dt), (p + "ffn.w2", (e, f, d), dt),
               (p + "ffn.w3", (e, d, f), dt), (p + "ffn.ws1", (d, fs), dt),
               (p + "ffn.ws2", (fs, d), dt), (p + "ffn.ws3", (d, fs), dt)])


def param_specs(port: dict) -> list[tuple[str, tuple, str]]:
    specs = weights.outer_specs(port)
    for i in range(port["n_layers"]):
        specs += layer_specs(port, i)
    return specs


def _dt_bias(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """softplus^-1 of a step drawn log-uniform in [0.001, 0.1] (Mamba2's
    initialisation)."""
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = x.uniform_(generator=gen).mul_(hi - lo).add_(lo).exp_()
    return dt + torch.log(-torch.expm1(-dt))


def _embed(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Normal at 0.02 / 12: the embeddings times the published
    embedding_multiplier (12) at the initializer range 0.02. At 0.02
    itself the scaled token embedding, read back through the tied head,
    outweighs every layer's output: each position's best logit is its own
    token's by ~10 standard deviations of the rest, whatever the layers
    compute, and no precision could move a served token."""
    return x.normal_(0.0, 0.02 / 12, generator=gen)


# the SSM's vectors (Mamba2's initialisation; the conv bias is
# torch.nn.Conv1d's, uniform within 1 / sqrt(its 4 taps)), and the
# embedding
draw_rules = {
    "embed": _embed,
    ".mixer.A_log": lambda x, gen: x.uniform_(1.0, 16.0,
                                              generator=gen).log_(),
    ".mixer.D": lambda x, gen: x.fill_(1.0),
    ".mixer.dt_bias": _dt_bias,
    ".mixer.conv_b": lambda x, gen: x.uniform_(-0.5, 0.5, generator=gen),
    ".mixer.norm": lambda x, gen: x.fill_(1.0),
}


def attn_layers(port: dict) -> int:
    """The attention layers, which launch K1 and K2."""
    return kinds(port).count("A")


def flops_per_token(port: dict, context: int, n: int, head: bool = True
                    ) -> float:
    """Model FLOPs of one token (2 a multiply-add): each Mamba2 mixer's
    projections, conv and recurrence (the state update and its read, NH x
    N x P each), each attention layer's projections and E.V over the keys
    HAD keeps, each FFN's routed experts, router and shared expert, and
    the head where the token's logits are computed."""
    d, v = port["d_model"], port["vocab_size"]
    h, hk, dh = port["n_heads"], port["n_kv_heads"], port["head_dim"]
    s = ssm_sizes(port)
    mamba = (d * (2 * s["di"] + 2 * s["n"] + s["nh"]) + s["di"] * d
             + 4 * s["conv"] + 2 * s["nh"] * s["n"] * s["hd"])
    attn = (d * h * dh + 2 * d * hk * dh + h * dh * d
            + h * dh * min(n, context))
    ffn = (3 * d * port["d_ff"] * port["experts_per_token"]
           + d * port["n_experts"] + 3 * d * port["shared_expert_width"])
    ks = kinds(port)
    return 2.0 * (ks.count("M") * mamba + ks.count("A") * attn
                  + len(ks) * ffn + head * d * v)


def ssd(xh: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, a: torch.Tensor, chunk: int) -> torch.Tensor:
    """The Mamba2 recurrence over a whole sequence, y_t = C_t . h_t (the
    skip term left to the caller): xh [T, NH, P], dt [T, NH], b and c
    [T, N], a [NH]; float32. Inside a chunk of L tokens, y_t = sum over
    s <= t of (C_t . B_s) exp(cum_t - cum_s) dt_s x_s plus exp(cum_t)
    C_t . h (cum the running sum of dt * a from the chunk's start, h the
    state carried in); then h = exp(cum_L) h + sum_s exp(cum_L - cum_s)
    dt_s B_s x_s^T."""
    t, nh, p = xh.shape
    h = torch.zeros((nh, b.shape[-1], p), dtype=torch.float32,
                    device=xh.device)
    out = torch.empty_like(xh)
    for t0 in range(0, t, chunk):
        t1 = min(t, t0 + chunk)
        x, d, bb, cc = xh[t0:t1], dt[t0:t1], b[t0:t1], c[t0:t1]
        cum = torch.cumsum(d * a, dim=0)                    # [L, NH]
        tri = torch.tril(torch.ones((t1 - t0, t1 - t0), dtype=torch.bool,
                                    device=xh.device))
        seg = torch.where(tri[:, :, None], cum[:, None] - cum[None],
                          -torch.inf)
        m = (cc @ bb.t())[:, :, None] * torch.exp(seg) * d[None]
        y = torch.einsum("tsh,shp->thp", m, x)
        y += torch.exp(cum)[:, :, None] * torch.einsum("tn,hnp->thp", cc, h)
        w = torch.exp(cum[-1][None] - cum) * d              # [L, NH]
        h = torch.exp(cum[-1])[:, None, None] * h + torch.einsum(
            "sh,sn,shp->hnp", w, bb, x)
        out[t0:t1] = y
    return out


class Reference(base.Reference):
    """The reference model of one run (see ``model.Reference``)."""

    def __init__(self, port: dict, *, seed: int, max_len: int, device,
                 quant: str | None = None, q_block: int = 1024):
        super().__init__(port, seed=seed, max_len=max_len, device=device,
                         quant=quant, q_block=q_block)
        sq = np.float32(port["had"]["sigma_init"])
        self.scale = float(np.float32(sq * sq)
                           * np.float32(port["attention_multiplier"]))

    def _w(self, name: str, shape, dtype: str) -> torch.Tensor:
        w = weights.draw(name, shape, seed=self.seed, device=self.device,
                         dtype=weights.DTYPES[dtype],
                         rules=draw_rules).to(torch.float32)
        # the conv is no matrix product
        if self.quant and w.ndim >= 2 and name != "embed" \
                and not name.endswith((".router", ".conv_w")):
            w = base.fp8(w, dim=-2)
        return w

    def _attn(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        port, dh = self.port, self.dh
        h, hk, t = port["n_heads"], port["n_kv_heads"], x.shape[0]
        q = self._mm(x, p["mixer.wq"]).view(t, h, dh).transpose(0, 1)
        k = self._mm(x, p["mixer.wk"]).view(t, hk, dh).transpose(0, 1)
        v = self._mm(x, p["mixer.wv"]).view(t, hk, dh).transpose(0, 1)
        ctx = base.had_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), n=self.n, scale=self.scale,
                                 q_block=self.q_block)
        return self._mm(ctx.transpose(0, 1).reshape(t, h * dh),
                        p["mixer.wo"])

    def _mamba(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        s = ssm_sizes(self.port)
        di, n, nh, hd = s["di"], s["n"], s["nh"], s["hd"]
        t = x.shape[0]
        xs, z, b, c, dt = torch.split(self._mm(x, p["mixer.w_in"]),
                                      [di, di, n, n, nh], dim=-1)
        xbc = torch.cat([xs, b, c], dim=-1)                 # [T, C]
        w = p["mixer.conv_w"]
        k = w.shape[0]
        xp = F.pad(xbc, (0, 0, k - 1, 0))
        conv = sum(xp[i:i + t] * w[i] for i in range(k)) + p["mixer.conv_b"]
        xs, b, c = torch.split(F.silu(conv), [di, n, n], dim=-1)
        dt = F.softplus(dt + p["mixer.dt_bias"])
        a = -torch.exp(p["mixer.A_log"])
        xh = xs.reshape(t, nh, hd)
        y = ssd(xh, dt, b, c, a, self.port["ssm_chunk"])
        y = (y + p["mixer.D"][:, None] * xh).reshape(t, di)
        return self._mm(self._norm(y * F.silu(z), p["mixer.norm"]),
                        p["mixer.w_out"])

    def _moe(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        k = self.port["experts_per_token"]
        logits = x @ p["ffn.router"]
        top, experts = torch.sort(logits, dim=-1, descending=True,
                                  stable=True)
        gates = torch.softmax(top[:, :k], dim=-1)
        experts = experts[:, :k]
        y = self._swiglu(x, p["ffn.ws1"], p["ffn.ws2"], p["ffn.ws3"])
        for e in range(logits.shape[-1]):
            rows, slot = torch.nonzero(experts == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            ye = self._swiglu(x[rows], p["ffn.w1"][e], p["ffn.w2"][e],
                              p["ffn.w3"][e])
            y.index_add_(0, rows, ye * gates[rows, slot, None])
        return y

    @torch.no_grad()
    def logits(self, seqs, positions) -> list[torch.Tensor]:
        """Float32 logits [len(pos), vocab] of each token sequence (1-d
        int arrays) at its `positions` (the logits at position i predict
        token i + 1)."""
        port = self.port
        outer = {name: (shape, dt)
                 for name, shape, dt in weights.outer_specs(port)}
        embed = self._w("embed", *outer["embed"])
        hs = [embed[torch.as_tensor(np.asarray(s, np.int64),
                                    device=self.device)]
              * port["embedding_multiplier"] for s in seqs]
        rm = port["residual_multiplier"]
        for i, kind in enumerate(kinds(port)):
            pre = f"blocks.{i}."
            p = {name[len(pre):]: self._w(name, shape, dt)
                 for name, shape, dt in layer_specs(port, i)}
            mixer = self._mamba if kind == "M" else self._attn
            for j, x in enumerate(hs):
                x = x + rm * mixer(p, self._norm(x, p["norm1.w"]))
                hs[j] = x + rm * self._moe(p, self._norm(x, p["norm2.w"]))
            del p
        # tied: the embedding table, quantized as a head
        head = base.fp8(embed.t(), dim=-2) if self.quant else embed.t()
        fw = self._w("final_norm.w", *outer["final_norm.w"])
        out = []
        for x, pos in zip(hs, positions):
            idx = torch.as_tensor(np.asarray(pos, np.int64),
                                  device=self.device)
            out.append(self._mm(self._norm(x[idx], fw), head)
                       / port["logits_scaling"])
        return out
