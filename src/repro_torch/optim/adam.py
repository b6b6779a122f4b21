"""AdamW (torch twin of ``repro.optim.adam``), over named tensors:

* float32 or bfloat16 moment states (`state_dtype`);
* a mask of trainable tensors: the HAD sigmas (sigma_q / sigma_k) get no
  state (a zero-size moment, as in the JAX tree) and no update, though
  their gradients count in the global norm, as JAX's do;
* global-norm clipping (paper: 0.5) and bias correction by `count`;
* the update in float32, cast back to the parameter's dtype.

Parameters are dicts name -> tensor (a module's named tensors); `update`
writes the new values into them in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.5          # paper §3.9
    state_dtype: str = "float32"    # or "bfloat16" for giant models

    @property
    def sdtype(self):
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.state_dtype]


def default_mask(name: str, leaf: torch.Tensor) -> bool:
    """Trainable iff not a sigma buffer."""
    return not any(part in ("sigma_q", "sigma_k")
                   for part in name.split("."))


def init(params: dict[str, torch.Tensor], cfg: AdamWConfig,
         mask_fn: Callable = default_mask) -> dict:
    def zeros(name, p):
        shape = p.shape if mask_fn(name, p) else (0,)
        return torch.zeros(shape, dtype=cfg.sdtype, device=p.device)

    dev = next(iter(params.values())).device
    return {"mu": {n: zeros(n, p) for n, p in params.items()},
            "nu": {n: zeros(n, p) for n, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, leaves in key
    order (JAX sums them in its tree order)."""
    sq = [tree[k].to(torch.float32).square().sum() for k in sorted(tree)]
    return torch.stack(sq).sum().sqrt()


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / norm.clamp_min(1e-12), 1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def update(grads: dict[str, torch.Tensor], state: dict,
           params: dict[str, torch.Tensor], *, lr, cfg: AdamWConfig,
           mask_fn: Callable = default_mask) -> tuple[dict, dict]:
    """One AdamW step: params updated in place. Returns (new state,
    metrics {"grad_norm"})."""
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    count = state["count"] + 1
    cf = count.to(torch.float32)
    c1 = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32,
                            device=cf.device) ** cf
    c2 = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32,
                            device=cf.device) ** cf
    lr = torch.as_tensor(lr, device=cf.device).to(torch.float32)
    mu, nu = dict(state["mu"]), dict(state["nu"])
    for name, p in params.items():
        if not mask_fn(name, p):
            continue
        g32 = grads[name].to(torch.float32)
        mu32 = mu[name].to(torch.float32) * cfg.b1 + (1 - cfg.b1) * g32
        nu32 = nu[name].to(torch.float32) * cfg.b2 + (1 - cfg.b2) * g32 * g32
        step = lr * (mu32 / c1) / (torch.sqrt(nu32 / c2) + cfg.eps)
        if cfg.weight_decay:
            step = step + lr * cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - step).to(p.dtype))
        mu[name] = mu32.to(cfg.sdtype)
        nu[name] = nu32.to(cfg.sdtype)
    return {"mu": mu, "nu": nu, "count": count}, {"grad_norm": gnorm}
