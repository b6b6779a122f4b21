"""The collectives of tensor-parallel serving, over ``torch.distributed``.

Three collectives move data inside a serving step, as in the JAX
package's sharded step (``lax.all_gather`` / ``lax.pmax``):

* `all_gather_heads`: the attention context of the local heads, gathered
  tiled on axis 1 (heads) before ``wo``, in rank order;
* `all_gather_last`: the logits of a vocabulary-sharded lm_head, tiled on
  the last axis;
* `all_reduce_max`: the full-precision page-sparse decode's per-slot page
  scores, a max over every rank's kv heads.

`all_reduce_sum` is the sum behind ``compression.psum_compressed``.

Gathers move bytes only (a tensor travels as its uint8 view), so every
dtype is gathered bit for bit. `broadcast_object` sends one picklable
object (the runner's calls and plans) from the group's first rank. Each
collective takes the group and is the identity when the group is None or
has one rank.

gloo has no collective on CUDA tensors that NCCL-style code can rely on,
so under gloo a CUDA tensor is staged through host memory: copied to the
host, reduced there, copied back. The compute stays on the card.
`staged_counts()` says how many calls and bytes were staged.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_STAGED = {"calls": 0, "bytes": 0}


def staged_counts() -> dict[str, int]:
    """Collective calls (and their input bytes) staged through host memory
    since the last `reset_staged_counts()`."""
    return dict(_STAGED)


def reset_staged_counts() -> None:
    for key in _STAGED:
        _STAGED[key] = 0


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _host(x: torch.Tensor, group) -> tuple[torch.Tensor, bool]:
    """x, or its host copy when gloo must reduce a CUDA tensor."""
    if x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        _STAGED["calls"] += 1
        _STAGED["bytes"] += x.numel() * x.element_size()
        return x.cpu(), True
    return x, False


def _all_gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    src, staged = _host(x.contiguous(), group)
    raw = src.view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(parts, raw, group=group)
    out = torch.cat(parts, dim=axis % x.ndim).view(x.dtype)
    return out.to(x.device) if staged else out


def all_gather_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[B, h_local, ...] on each rank -> [B, h_local * ranks, ...], the
    ranks' heads in rank order."""
    return _all_gather(x, group, 1)


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """[..., n_local] on each rank -> [..., n_local * ranks], in rank
    order."""
    return _all_gather(x, group, -1)


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    src, staged = _host(x, group)
    out = src.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out.to(x.device) if staged else out


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of x over the ranks (a new tensor)."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of x over the ranks (a new tensor)."""
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def broadcast_object(obj, group, src: int):
    """`obj` of global rank `src`, on every rank of `group` (pickled)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]
