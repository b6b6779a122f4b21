"""Sharding rules (torch twin of ``repro.distributed.sharding``), as pure
shape logic: no device, no collective.

A spec is a `Spec`, a tuple with one entry per tensor dim: None
(replicated), a mesh axis name, or a tuple of axis names (the dim split
over their product), as JAX's ``PartitionSpec``. A mesh is anything with
a ``.shape`` mapping axis name -> size (``launch.mesh.HostMesh``, or
`AbstractMesh` for the production meshes). Rules are name-based on the
parameter's path (JAX tree keys, or the port's module path through
``checkpoint.bridge.jax_key``); a dim is sharded over an axis only when
the axis size divides it.

Two rule sets, as in the JAX package:

* training (`param_spec`, `cache_spec`, `batch_spec`): FSDP over
  ("pod", "data") and TP over "model" on the production mesh. The dry
  run prices each cell's per-chip memory and collectives from them
  (``launch.mesh_cost``); nothing shards a tensor by them.
* tensor-parallel serving (`serve_param_spec`, `serve_cache_spec`), the
  exact-parity layout the runner uses: wq / wk / wv sharded on the
  head-output dim, the k_bits / k / v cache leaves on the kv-head axis,
  the lm_head on the vocabulary when it divides, everything else (wo, the
  FFN, MoE, SSM, norms, embed, block tables and plan arrays) replicated.
  The context is gathered over heads before wo, never a sum of partial
  wo products, so no float sum changes order and the outputs are bit-
  identical to one device's.

`shard_tensor` slices a full tensor to a rank's shard of a spec.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

SERVE_HEAD_SHARDED = ("wq", "wk", "wv")
POOL_HEAD_LEAVES = ("k_bits", "k", "v")


class Spec(tuple):
    """A partition spec: one entry per dim, None, an axis name or a tuple
    of axis names. A one-axis tuple is stored as the name, as
    ``PartitionSpec`` stores it, so specs compare equal to JAX's as
    tuples."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh shape without devices (JAX ``AbstractMesh``): the production
    meshes the training rules are written against."""
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def fsdp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def batch_axes(mesh) -> tuple[str, ...]:
    return fsdp_axes(mesh)


def axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes)) if axes else 1


def _fits(dim: int, mesh, axes) -> bool:
    return axes is not None and dim % max(axis_size(mesh, axes), 1) == 0


def _path_names(path) -> list[str]:
    """Path entries as names: strings, a "//"- or "."-joined string, or
    JAX key objects (``.key`` / ``.name``)."""
    if isinstance(path, str):
        return path.replace("//", ".").split(".")
    return [str(getattr(p, "key", getattr(p, "name", p))) for p in path]


def param_spec(path, shape, mesh, *, fsdp_enabled: bool = True) -> Spec:
    """Training spec of one parameter of `shape` (JAX ``param_spec``):
    rules on the logical trailing dims, a leading stacked n_groups axis
    unsharded; fsdp_enabled=False keeps TP and replicates over the data
    axes."""
    name = _path_names(path)[-1]
    shape = tuple(shape)
    ndim = len(shape)
    fsdp = fsdp_axes(mesh) if fsdp_enabled else ()
    tp = "model"

    def pick(*cands):
        lead = max(ndim - len(cands), 0)
        spec: list = [None] * lead
        used: set = set()
        for dim, options in zip(shape[lead:], cands):
            chosen = None
            for ax in options:
                if ax is None or ax == ():
                    continue
                key = ax if isinstance(ax, str) else tuple(ax)
                if key in used:
                    continue
                if _fits(dim, mesh, ax):
                    chosen = ax
                    used.add(key)
                    break
            spec.append(chosen)
        return Spec(*spec)

    if ndim == 0 or "sigma" in name or name in ("A_log", "D", "dt_bias",
                                                "w", "count"):
        return Spec()
    if name == "embed":                      # [V, D]
        return pick((tp,), (fsdp,))
    if name == "pos_embed":                  # [T, D]
        return pick((fsdp,), (tp,))
    if name == "lm_head":                    # [D, V]
        return pick((fsdp,), (tp,))
    if name == "frontend_proj":              # [FD, D]
        return pick((None,), (tp,))
    if name in ("w1", "w3") and ndim >= 4:   # MoE [G, E, D, F]
        return pick((tp,), (fsdp,), (None,))
    if name == "w2" and ndim >= 4:           # MoE [G, E, F, D]
        return pick((tp,), (None,), (fsdp,))
    if name in ("wq", "w1", "w3", "w_in"):   # [.., D, out(tp)]
        return pick((fsdp,), (tp,))
    if name in ("wk", "wv"):                 # [.., D, Hk*Dh]
        return pick((fsdp,), (tp,))
    if name in ("wo", "w2", "w_out"):        # [.., in(tp), D]
        return pick((tp,), (fsdp,))
    if name == "router":                     # [.., D, E]
        return pick((fsdp,), (None,))
    if name == "conv_w":                     # [.., K, Di]
        return pick((None,), (tp,))
    return Spec()


def batch_spec(shape, mesh, *, global_batch: int) -> Spec:
    """Input batch spec (JAX ``batch_spec``, one leaf): the batch dim over
    (pod, data) when divisible, else replicated."""
    ba = batch_axes(mesh)
    spec: list = [None] * len(shape)
    if global_batch % max(axis_size(mesh, ba), 1) == 0 and len(shape) >= 1:
        spec[0] = ba
    return Spec(*spec)


def cache_spec(path, shape, mesh, *, global_batch: int) -> Spec:
    """Training / dry-run KV-cache and SSM-state spec of one leaf [G, B,
    ...] (JAX ``cache_spec``): batch over (pod, data) and sequence over
    model when divisible, else the sequence over every axis (SP)."""
    name = _path_names(path)[-1]
    shape = tuple(shape)
    ba = batch_axes(mesh)
    all_axes = ba + ("model",)
    batch_fits = global_batch % max(axis_size(mesh, ba), 1) == 0
    spec: list = [None] * len(shape)
    seq_axis = {"k_bits": 3, "v": 2, "k": 2}.get(name)
    if seq_axis is not None:
        seq_axis += 1                        # the leading n_groups dim
        if batch_fits:
            spec[1] = ba
            if shape[seq_axis] % axis_size(mesh, "model") == 0:
                spec[seq_axis] = "model"
        elif shape[seq_axis] % axis_size(mesh, all_axes) == 0:
            spec[seq_axis] = all_axes
        elif shape[seq_axis] % axis_size(mesh, ba) == 0:
            spec[seq_axis] = ba
        return Spec(*spec)
    if batch_fits and len(shape) >= 2:
        spec[1] = ba
    return Spec(*spec)


def serve_param_spec(path, shape, mesh) -> Spec:
    """Exact-parity tensor-parallel spec of one serving parameter (JAX
    ``serve_param_spec``)."""
    name = _path_names(path)[-1]
    shape = tuple(shape)
    tp = axis_size(mesh, "model")
    if tp <= 1 or len(shape) == 0:
        return Spec()
    if name in SERVE_HEAD_SHARDED:
        if shape[-1] % tp != 0:
            raise ValueError(
                f"serving TP: {name} head-output dim {shape[-1]} not "
                f"divisible by mesh model axis {tp}")
        return Spec(*([None] * (len(shape) - 1)), "model")
    if name == "lm_head" and shape[-1] % tp == 0:
        return Spec(*([None] * (len(shape) - 1)), "model")
    return Spec()


def serve_cache_spec(path, shape, mesh, *, head_axis: int = 2) -> Spec:
    """Head-sharded spec of one serving cache leaf (JAX
    ``serve_cache_spec``): k_bits / k / v shard their kv-head axis over
    "model", every other leaf is replicated. The kv-head axis is 2 in the
    JAX package's stacked layouts ([G, n_pages or B, Hk, ...]) and 1 in
    the port's per-layer caches ([n_pages + 1 or B, Hk, ...]), the
    pooled cross caches included."""
    name = _path_names(path)[-1]
    shape = tuple(shape)
    tp = axis_size(mesh, "model")
    if tp <= 1 or name not in POOL_HEAD_LEAVES:
        return Spec()
    if len(shape) <= head_axis or shape[head_axis] % tp != 0:
        raise ValueError(
            f"serving TP: cache leaf {name} shape {shape} has no "
            f"kv-head axis divisible by mesh model axis {tp}")
    return Spec(*([None] * head_axis), "model")


def _tree_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def serve_param_specs(params: Any, mesh) -> Any:
    """`serve_param_spec` over a nested dict of arrays (anything with
    .shape), keyed as the tree."""
    return _tree_map(lambda p, leaf: serve_param_spec(p, leaf.shape, mesh),
                     params)


def serve_cache_specs(caches: Any, mesh, *, head_axis: int = 2) -> Any:
    return _tree_map(lambda p, leaf: serve_cache_spec(
        p, leaf.shape, mesh, head_axis=head_axis), caches)


def shard_shape(shape, spec: Spec, mesh) -> tuple[int, ...]:
    """A rank's shard shape: each sharded dim divided by its axes' size."""
    return tuple(d if ax is None else d // axis_size(mesh, ax)
                 for d, ax in zip(tuple(shape), tuple(spec) + (None,) * (
                     len(shape) - len(spec))))


def mesh_coords(mesh, rank: int) -> dict[str, int]:
    """Rank -> its coordinate on every mesh axis (row-major over the axes
    in order, as a device mesh lays out its devices)."""
    coords = {}
    for name in reversed(list(mesh.shape)):
        size = mesh.shape[name]
        coords[name] = rank % size
        rank //= size
    return coords


def shard_tensor(full, spec: Spec, mesh, rank: int):
    """The shard of the full tensor `full` that mesh rank `rank` holds
    under `spec` (a view: slice per sharded dim)."""
    coords = mesh_coords(mesh, rank)
    out = full
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = 0
        for a in axes:                       # the axes' flattened index
            idx = idx * mesh.shape[a] + coords[a]
        size = full.shape[dim] // axis_size(mesh, axes)
        out = out.narrow(dim, idx * size, size)
    return out


def local_config(cfg, tp: int):
    """The per-rank model config of tensor-parallel serving: head_dim
    pinned first (it derives from d_model / n_heads when unset), then
    n_heads and n_kv_heads divided by tp."""
    if tp <= 1:
        return cfg
    return dataclasses.replace(cfg, head_dim=cfg.dh,
                               n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp)
