"""Plain float32 reference of the served decoders: the HAD serving
forward (binarized queries and keys, integer scores, the top-N keys of
each query in a softmax over full-precision values) over whole sequences,
with no kernel, cache, paging or batching.

It reads a configuration's ``port`` block and the run's seed, draws each
layer's weights again (``hadbench.weights``) and frees them before the
next, and keeps every sequence's hidden states, so a model larger than
half the card is never held twice. It imports nothing of the program.
Its equations are the port's serving model's, which depart from the
published architectures where the configuration files say so (RMSNorm
for dbrx's LayerNorm, no q/k/v clipping), plus HAD's: q and k rotated
(RoPE, pairs (2i, 2i+1)), then their signs (x >= 0 -> +1); the score
of a key is the integer sign dot product; a query keeps every key whose
score reaches its N-th largest among its causal keys (ties kept; all of
them when it has N or fewer); weights exp(scale * (score - d)) with
scale = sigma_q * sigma_k / sqrt(d); N = round(topn_frac * max_len)
clamped to [n_min, n_max]. MoE layers route each token to its top-k
experts by a float32 softmax (ties to the lower expert) with the k gates
renormalised, and every token reaches all of its experts.

`quant="fp8"` is the control: the same forward with every matrix product
computed from float8 (e4m3) operands, weights scaled per output column
and activations per row, the step below the bf16 the configurations
state.

The default model module (``hadbench/reference/__init__.py``): its tensors,
draws, FLOPs and attention layers are ``weights.param_specs``, the default
draw, ``flops.per_token`` and every layer.
"""
from __future__ import annotations


import numpy as np
import torch
import torch.nn.functional as F

from hadbench import flops, weights

E4M3_MAX = 448.0

param_specs = weights.param_specs
draw_rules: dict = {}
flops_per_token = flops.per_token


def attn_layers(port: dict) -> int:
    """Every layer is an attention layer."""
    return port["n_layers"]


def topn(port: dict, max_len: int) -> int:
    """N, the keys a query keeps, for an engine of `max_len` positions."""
    had = port["had"]
    return int(max(had["n_min"], min(had["n_max"],
                                      round(had["topn_frac"] * max_len))))


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `dim`
    (the slice's largest magnitude maps to the format's largest)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = amax / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [heads, T, dh] at positions 0..T-1; pairs (2i, 2i+1) rotate by
    position * theta ** (-2i / dh)."""
    _, t, dh = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                          device=x.device) / dh))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def had_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  n: int, scale: float, q_block: int = 1024) -> torch.Tensor:
    """Causal HAD attention of one sequence: q [H, T, d], k and v
    [Hk, T, d] float32 (after RoPE) -> [H, T, dv]."""
    h, t, d = q.shape
    hk = k.shape[0]
    g = h // hk
    qs = torch.where(q >= 0, 1.0, -1.0).view(hk, g, t, d)
    ks = torch.where(k >= 0, 1.0, -1.0)
    out = torch.empty((hk, g, t, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, t, q_block):
        q1 = min(t, q0 + q_block)
        s = torch.matmul(qs[:, :, q0:q1], ks[:, None, :q1].transpose(-1, -2))
        qi = torch.arange(q0, q1, device=q.device)
        valid = torch.arange(q1, device=q.device)[None, :] <= qi[:, None]
        n_eff = torch.clamp(qi + 1, max=n)
        # the largest level L = 2j - d with count(score >= L) >= n_eff
        lo = torch.zeros(s.shape[:-1], dtype=torch.int64, device=q.device)
        hi = torch.full_like(lo, d + 1)
        while bool((hi - lo > 1).any()):
            mid = (lo + hi) // 2
            cnt = ((s >= (2 * mid - d)[..., None]) & valid).sum(-1)
            ok = cnt >= n_eff
            lo = torch.where(ok, mid, lo)
            hi = torch.where(ok, hi, mid)
        keep = (s >= (2 * lo - d)[..., None]) & valid
        e = torch.where(keep, torch.exp(scale * (s - d)), 0.0)
        del s, keep
        out[:, :, q0:q1] = torch.matmul(e, v[:, None, :q1]) \
            / e.sum(-1, keepdim=True)
        del e
    return out.reshape(h, t, -1)


class Reference:
    """The reference model of one run: `port` (a configuration's ``port``
    block), the run's `seed`, the engine's `max_len` (it sets N)."""

    def __init__(self, port: dict, *, seed: int, max_len: int, device,
                 quant: str | None = None, q_block: int = 1024):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.port, self.seed, self.device = port, seed, torch.device(device)
        self.quant, self.q_block = quant, q_block
        self.n = topn(port, max_len)
        self.dh = port["head_dim"]
        had = port["had"]
        sq = np.float32(had["sigma_init"])
        self.scale = float(np.float32(sq * sq)
                           * np.float32(self.dh ** -0.5))

    def _w(self, name: str, shape, dtype: str) -> torch.Tensor:
        w = weights.draw(name, shape, seed=self.seed, device=self.device,
                         dtype=weights.DTYPES[dtype]).to(torch.float32)
        if self.quant and w.ndim >= 2 and not name.endswith(".router") \
                and name != "embed":    # a lookup, not a product
            w = fp8(w, dim=-2)
        return w

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.quant:
            x = fp8(x, dim=-1)
        return x @ w

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        eps = self.port["norm_eps"]
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w

    def _attn(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        port, dh = self.port, self.dh
        h, hk, t = port["n_heads"], port["n_kv_heads"], x.shape[0]
        q = self._mm(x, p["mixer.wq"]).view(t, h, dh).transpose(0, 1)
        k = self._mm(x, p["mixer.wk"]).view(t, hk, dh).transpose(0, 1)
        v = self._mm(x, p["mixer.wv"]).view(t, hk, dh).transpose(0, 1)
        theta = port["rope_theta"]
        ctx = had_attention(rope(q, theta), rope(k, theta), v.contiguous(),
                            n=self.n, scale=self.scale,
                            q_block=self.q_block)
        return self._mm(ctx.transpose(0, 1).reshape(t, h * dh),
                        p["mixer.wo"])

    def _swiglu(self, x, w1, w2, w3) -> torch.Tensor:
        return self._mm(F.silu(self._mm(x, w1)) * self._mm(x, w3), w2)

    def _moe(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        k = self.port["experts_per_token"]
        probs = torch.softmax(x @ p["ffn.router"], dim=-1)
        gates, experts = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
        gates, experts = gates[:, :k], experts[:, :k]
        gates = gates / gates.sum(-1, keepdim=True)
        y = torch.zeros_like(x)
        for e in range(probs.shape[-1]):
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
                                    device=self.device)] for s in seqs]
        if "lm_head" in outer:
            del embed
        for i in range(port["n_layers"]):
            pre = f"blocks.{i}."
            p = {name[len(pre):]: self._w(name, shape, dt)
                 for name, shape, dt in weights.layer_specs(port, i)}
            for j, x in enumerate(hs):
                x = x + self._attn(p, self._norm(x, p["norm1.w"]))
                hn = self._norm(x, p["norm2.w"])
                if "ffn.router" in p:
                    x = x + self._moe(p, hn)
                else:
                    x = x + self._swiglu(hn, p["ffn.w1"], p["ffn.w2"],
                                         p["ffn.w3"])
                hs[j] = x
            del p
        if "lm_head" in outer:
            head = self._w("lm_head", *outer["lm_head"])
        else:           # tied: the embedding table, quantized as a head
            head = fp8(embed.t(), dim=-2) if self.quant else embed.t()
        fw = self._w("final_norm.w", *outer["final_norm.w"])
        out = []
        for x, pos in zip(hs, positions):
            idx = torch.as_tensor(np.asarray(pos, np.int64),
                                  device=self.device)
            out.append(self._mm(self._norm(x[idx], fw), head))
        return out
