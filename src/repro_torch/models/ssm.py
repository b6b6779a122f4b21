"""Mamba2 (SSD) layer for serving (torch twin of ``repro.models.ssm``).

Scalar-per-head decay lets the sequence mixing run as chunked matmuls with
a short scan over chunks:

  h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t^T        (state [N, P])
  y_t = C_t^T h_t + D * x_t

Within a chunk of length L, M[t, s] = (C_t . B_s) exp(cum_t - cum_s) dt_s
(s <= t) gives y_intra = M @ x; the state carried into the chunk adds
y_inter = exp(cum_t) C_t . h. A decode step is one recurrence step on the
carried state. The SSD math runs in float32, as in the JAX package, whose
counterpart of every function here is computed outside any kernel.

A layer's serving state is {"h": float32 [B, NH, N, P], "conv": [B, K-1,
C]} (the last K-1 conv inputs, C = cfg.ssm_conv_width). Pooled state keeps
the same layout with the batch axis repurposed as state entries (plus the
port's trash entry), read and written through `state_read` /
`state_write`.

Two forms of the mixer, chosen by `cfg.ssm_mixer`. "jax", the JAX
package's (the default): the conv runs over x alone, unbiased, then
rmsnorm(y) * silu(z). "published", the published Mamba2 mixer (as
granite-4.0-h-small): the conv, with its bias, runs over x, B and C
together and silu follows on all three, and the gated norm is
rmsnorm(y * silu(z)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common
from repro_torch.models.config import ModelConfig

CONV_K = 4                        # the depthwise conv's kernel size


class SSM(nn.Module):
    """One Mamba2 mixer's weights, named as the JAX tree's: w_in [D,
    2 d_inner + 2 N + NH] (x, z, B, C, dt), w_out [d_inner, D], conv_w
    [4, C] (C = cfg.ssm_conv_width) and, in the published mixer, conv_b
    [C], the gated RMSNorm's weight `norm` [d_inner], and the float32
    per-head A_log, D and dt_bias [NH]."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        dt = cfg.dtype

        def weight(*shape, dtype=dt):
            return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.w_in = weight(d, 2 * di + 2 * n + nh)
        self.w_out = weight(di, d)
        self.A_log = weight(nh, dtype=torch.float32)
        self.D = weight(nh, dtype=torch.float32)
        self.dt_bias = weight(nh, dtype=torch.float32)
        self.conv_w = weight(CONV_K, cfg.ssm_conv_width)
        self.conv_b = (weight(cfg.ssm_conv_width)
                       if cfg.ssm_mixer == "published" else None)
        self.norm = weight(di)


def init_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """Zero serving state of one layer for `batch` rows (or entries)."""
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                          cfg.ssm_head_dim), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, CONV_K - 1, cfg.ssm_conv_width),
                            dtype=cfg.dtype, device=device)}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))       # jax.nn.softplus


def _split_in(p: SSM, x: torch.Tensor, cfg: ModelConfig):
    di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(x @ p.w_in, [di, di, n, n, nh], dim=-1)


def _conv_causal(xs: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None = None,
                 n_valid: torch.Tensor | None = None,
                 bias: torch.Tensor | None = None):
    """Depthwise causal conv, kernel size K. xs: [B, S, Di]; w: [K, Di];
    bias [Di] or None.

    Returns (silu(y), new_state [B, K-1, Di], the last K-1 inputs).
    `n_valid` ([B] int, optional): rows whose last S - n_valid inputs are
    chunk padding carry the K-1 inputs ending at their last valid token
    (a per-row gather), so a padded chunk leaves the state where an
    unpadded one would; n_valid 0 keeps the old state."""
    k = w.shape[0]
    b, s, di = xs.shape
    pad = (torch.zeros((b, k - 1, di), dtype=xs.dtype, device=xs.device)
           if state is None else state.to(xs.dtype))
    xp = torch.cat([pad, xs], dim=1)                      # [B, S+K-1, Di]
    y = sum(xp[:, i:i + s] * w[i] for i in range(k))
    if bias is not None:
        y = y + bias
    if k <= 1:
        new_state = pad
    elif n_valid is None:
        new_state = xp[:, -(k - 1):]
    else:
        idx = (n_valid.to(torch.int64)[:, None]
               + torch.arange(k - 1, device=xs.device))   # [B, K-1]
        new_state = xp.gather(1, idx[:, :, None].expand(b, k - 1, di))
    return F.silu(y), new_state


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                *, chunk: int, h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD sequence mixing.

    xh [B, S, NH, P] per-head inputs; dt [B, S, NH] softplus'd step sizes;
    bmat, cmat [B, S, N] (one B/C group); a [NH] negative decay rates;
    d_skip [NH]; h0 optional initial state [B, NH, N, P]. The chunk length
    is the largest L <= chunk that divides S (L changes the float result,
    so the rule is the JAX package's). Returns (y [B, S, NH, P], final
    state [B, NH, N, P] float32)."""
    b, s, nh, p = xh.shape
    n = bmat.shape[-1]
    l = min(chunk, s)
    while s % l:
        l -= 1
    nc = s // l
    xc = xh.reshape(b, nc, l, nh, p)
    dtc = dt.reshape(b, nc, l, nh)
    bc = bmat.reshape(b, nc, l, n)
    cc = cmat.reshape(b, nc, l, n)
    loga = dtc * a[None, None, None, :]                   # [B,NC,L,NH] <= 0
    cum = torch.cumsum(loga, dim=2)

    # intra-chunk: M[t,s] = (C_t.B_s) exp(cum_t - cum_s) dt_s for s <= t.
    # Above the diagonal cum_t - cum_s > 0 and exp() overflows to inf at
    # long chunks; its gradient there (0 * inf) would be NaN, so the
    # exponent is masked to -inf first (exp -> exactly 0). The JAX
    # package masks after the exp: the same values, and NaN gradients.
    gram = torch.einsum("bctn,bcsn->bcts", cc, bc)        # [B,NC,L,L]
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=xh.device))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    decay = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                  torch.full((), -torch.inf,
                                             dtype=seg.dtype,
                                             device=xh.device)))
    m = torch.where(tri[None, None, :, :, None],
                    gram[..., None] * decay * dtc[:, :, None, :, :],
                    torch.zeros((), dtype=decay.dtype, device=xh.device))
    y_intra = torch.einsum("bctsh,bcshp->bcthp", m, xc)

    # chunk-final states: h_c = sum_s exp(cum_L - cum_s) dt_s B_s x_s^T
    tail = torch.exp(cum[:, :, -1:, :] - cum) * dtc       # [B,NC,L,NH]
    h_chunk = torch.einsum("bcsh,bcsn,bcshp->bchnp", tail, bc, xc)

    # the scan over chunks: h_prev[c] is the state before chunk c
    chunk_decay = torch.exp(cum[:, :, -1, :])             # [B,NC,NH]
    h = (torch.zeros((b, nh, n, p), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.to(torch.float32))
    h_chunk = h_chunk.to(torch.float32)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + h_chunk[:, c]
    h_prev = torch.stack(h_prev, dim=1)                   # [B,NC,NH,N,P]

    y_inter = torch.einsum("bcth,bctn,bchnp->bcthp", torch.exp(cum), cc,
                           h_prev)
    y = (y_intra + y_inter).reshape(b, s, nh, p)
    y = y + xh * d_skip[None, None, :, None]
    return y.to(xh.dtype), h


def ssd_step(xh: torch.Tensor, dt: torch.Tensor, bvec: torch.Tensor,
             cvec: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
             h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence. xh [B, NH, P]; dt [B, NH]; bvec, cvec [B, N];
    h [B, NH, N, P]."""
    xf = xh.to(torch.float32)
    dec = torch.exp(dt * a[None, :])                      # [B,NH]
    upd = torch.einsum("bh,bn,bhp->bhnp", dt, bvec, xf)
    h_new = h * dec[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", cvec, h_new)
    y = y + xf * d_skip[None, :, None]
    return y.to(xh.dtype), h_new


def _gate_out(p: SSM, y: torch.Tensor, z: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    if cfg.ssm_mixer == "jax":
        y = common.rmsnorm(p.norm, y, eps=cfg.norm_eps) * F.silu(z)
    else:       # Mamba2's RMSNormGated: gate in float32, then the norm
        g = y.to(torch.float32) * F.silu(z.to(torch.float32))
        y = common.rmsnorm(p.norm, g, eps=cfg.norm_eps).to(y.dtype)
    return y @ p.w_out


def _mix_in(p: SSM, x: torch.Tensor, cfg: ModelConfig, conv_state,
            n_valid: torch.Tensor | None = None):
    """The in-projection and the causal conv: (x, z, B, C, dt, new conv
    state), x (and in the published mixer B and C) convolved and
    silu'd."""
    xs, z, bmat, cmat, dt = _split_in(p, x, cfg)
    if cfg.ssm_mixer == "jax":
        xs, conv = _conv_causal(xs, p.conv_w, conv_state, n_valid=n_valid)
        return xs, z, bmat, cmat, dt, conv
    xbc, conv = _conv_causal(torch.cat([xs, bmat, cmat], dim=-1), p.conv_w,
                             conv_state, n_valid=n_valid, bias=p.conv_b)
    n = cfg.ssm_state
    xs, bmat, cmat = torch.split(xbc, [cfg.d_inner, n, n], dim=-1)
    return xs, z, bmat, cmat, dt, conv


def ssm_forward(p: SSM, x: torch.Tensor, *, cfg: ModelConfig,
                state: dict | None = None,
                n_valid: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict]:
    """A chunk. x [B, S, D]; state {h, conv} to continue from (None: zero).

    `n_valid` ([B] int, optional): each row's trailing S - n_valid tokens
    are padding. Their dt is zeroed (decay 1, update 0: the identity), and
    the conv state ends at the last valid token, so the carried state
    equals an unpadded chunk's. Outputs at padded positions are garbage.
    Returns (out [B, S, D], new state)."""
    b, s, _ = x.shape
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    xs, z, bmat, cmat, dt, conv = _mix_in(
        p, x, cfg, None if state is None else state["conv"], n_valid)
    dt = _softplus(dt.to(torch.float32) + p.dt_bias)
    if n_valid is not None:
        valid = (torch.arange(s, device=x.device)[None, :]
                 < n_valid.to(torch.int64)[:, None])      # [B, S]
        dt = torch.where(valid[:, :, None], dt,
                         torch.zeros((), device=x.device))
    a = -torch.exp(p.A_log)
    y, h = ssd_chunked(xs.reshape(b, s, nh, hd).to(torch.float32), dt,
                       bmat.to(torch.float32), cmat.to(torch.float32), a,
                       p.D, chunk=cfg.ssm_chunk,
                       h0=None if state is None else state["h"])
    y = y.reshape(b, s, cfg.d_inner).to(x.dtype)
    return _gate_out(p, y, z, cfg), {"h": h, "conv": conv}


def ssm_decode(p: SSM, x: torch.Tensor, *, cfg: ModelConfig,
               state: dict) -> tuple[torch.Tensor, dict]:
    """A one-token step. x [B, 1, D]."""
    b = x.shape[0]
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    xs, z, bmat, cmat, dt, conv = _mix_in(p, x, cfg, state["conv"])
    dt = _softplus(dt.to(torch.float32) + p.dt_bias)[:, 0]
    a = -torch.exp(p.A_log)
    y, h = ssd_step(xs[:, 0].reshape(b, nh, hd), dt,
                    bmat[:, 0].to(torch.float32),
                    cmat[:, 0].to(torch.float32), a, p.D, state["h"])
    y = y.reshape(b, 1, cfg.d_inner).to(x.dtype)
    return _gate_out(p, y, z, cfg), {"h": h, "conv": conv}


def state_read(pool: dict, entries: torch.Tensor) -> dict:
    """Gather {h, conv} entries into a [B, ...] batch view (a copy)."""
    return common.pool_read(pool, entries)


def state_write(pool: dict, new: dict, entries: torch.Tensor,
                ok: torch.Tensor) -> None:
    """Scatter an updated {h, conv} batch view back into its entries, in
    place; rows not `ok` land in the trash entry."""
    common.pool_write(pool, new, entries, ok)
