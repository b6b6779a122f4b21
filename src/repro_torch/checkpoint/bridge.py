"""Weight bridge between JAX parameter trees and the port's
`Transformer`, both ways.

The JAX package keeps per-layer parameters stacked along a leading
``n_groups`` axis under ``params["blocks"]["pos<i>"]`` (its serve step
scans over it). Layer ``g * len(layer_pattern) + i`` of the port is group
``g`` of pattern position ``i``; self- and cross-attention layers carry
the same weight names, SSM layers their own (``w_in``, ``w_out``,
``A_log``, ``D``, ``dt_bias``, ``conv_w``, ``norm``), MoE FFNs a float32
``router`` and expert weights stacked over experts; a model with a
frontend (cross layers or frames) carries ``frontend_proj`` too, and one
with learned positions ``pos_embed``. Two sources:

* `params_from_numpy` takes the tree as numpy arrays, e.g.
  ``jax.tree.map(np.asarray, params)`` -- no jax needed here.
* `load_npz` reads the JAX checkpoint manager's format (one ``.npz`` per
  collection, keys joined by ``//``) with numpy alone.

The inverse, `params_to_numpy`, gives a model's JAX tree (per-layer
tensors stacked back over groups); `to_jax_flat` / `from_jax_flat` map
any set of a model's named tensors (a student's subset, optimizer
moments) to and from the checkpoint's flat ``//`` keys (`jax_key`).

`shard_model` cuts a full model to one rank's shard for tensor-parallel
serving (``distributed.sharding.serve_param_spec`` on each tensor's JAX
key), so every rank starts from the same full weights.

bfloat16 arrays are recognised by dtype name (``ml_dtypes``' bfloat16, or
the 2-byte void dtype numpy gives them when ``ml_dtypes`` is absent) and
reinterpreted bit for bit through ``uint16``; `to_numpy` writes them as
that 2-byte void dtype, the bytes the JAX manager's ``np.savez`` writes.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import SSM
from repro_torch.models.transformer import Transformer, named_tensors

SEP = "//"


def to_torch(arr) -> torch.Tensor:
    """numpy array (incl. bfloat16) -> CPU tensor with the same bits."""
    arr = np.array(arr, order="C")                 # an owned copy, 0-d too
    if arr.dtype.name == "bfloat16" or arr.dtype == np.dtype("V2"):
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor -> a numpy array with the same bits (bfloat16 as the
    2-byte void dtype numpy gives it without ``ml_dtypes``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy().copy()


def jax_key(cfg: ModelConfig, name: str) -> tuple[str, int | None]:
    """A model tensor's name (module path, e.g. ``blocks.7.mixer.wq``) ->
    (its key in the JAX tree, ``//``-joined, e.g. ``blocks//pos1//mixer//
    wq``; its group along the stacked axis, or None outside the layers)."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return SEP.join(parts), None
    g, i = divmod(int(parts[1]), cfg.group_size)
    rest = parts[2:]
    if rest == ["mixer", "norm"]:            # an SSM's gated norm
        rest = ["mixer", "norm", "w"]
    return SEP.join(["blocks", f"pos{i}"] + rest), g


def to_jax_flat(cfg: ModelConfig, named: dict[str, torch.Tensor]
                ) -> dict[str, np.ndarray]:
    """Named tensors -> the JAX tree's flat keys, each layer tensor
    stacked over its groups (numpy, the same bits)."""
    groups: dict[str, dict[int, torch.Tensor]] = {}
    out: dict[str, np.ndarray] = {}
    for name, t in named.items():
        key, g = jax_key(cfg, name)
        if g is None:
            out[key] = to_numpy(t)
        else:
            groups.setdefault(key, {})[g] = t
    for key, by_g in groups.items():
        if sorted(by_g) != list(range(cfg.n_groups)):
            raise ValueError(f"{key}: groups {sorted(by_g)}")
        out[key] = to_numpy(torch.stack([by_g[g].detach().cpu()
                                         for g in range(cfg.n_groups)]))
    return out


def from_jax_flat(cfg: ModelConfig, flat: dict[str, np.ndarray],
                  names) -> dict[str, torch.Tensor]:
    """The inverse of `to_jax_flat` for the tensor names `names`: CPU
    tensors, layer tensors sliced out of their group's stack."""
    out = {}
    for name in names:
        key, g = jax_key(cfg, name)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.asarray(flat[key])
        out[name] = to_torch(arr if g is None else arr[g])
    return out


def params_to_numpy(model: Transformer) -> dict:
    """A model's weights as the JAX parameter tree of numpy arrays (the
    inverse of `params_from_numpy`; layer tensors stacked over groups)."""
    tree: dict = {}
    for key, arr in to_jax_flat(model.cfg, named_tensors(model)).items():
        node = tree
        *parents, leaf = key.split(SEP)
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree


def load_npz(directory: str, collection: str = "params") -> dict:
    """Read ``<directory>/<collection>.npz`` (a checkpoint step dir) into a
    nested dict of numpy arrays."""
    tree: dict = {}
    with np.load(os.path.join(directory, f"{collection}.npz")) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split(SEP)
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = z[key]
    return tree


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cpu"
                      ) -> Transformer:
    """Build a `Transformer` holding the weights of a JAX param tree."""
    model = Transformer(cfg, device="cpu")

    def put(param: torch.Tensor, arr, what: str) -> None:
        t = to_torch(arr)
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"{what}: shape {tuple(t.shape)} != "
                             f"{tuple(param.shape)}")
        param.copy_(t.to(param.dtype))

    with torch.no_grad():
        put(model.embed, tree["embed"], "embed")
        put(model.final_norm.w, tree["final_norm"]["w"], "final_norm")
        if model.lm_head is not None:
            put(model.lm_head, tree["lm_head"], "lm_head")
        if model.frontend_proj is not None:
            put(model.frontend_proj, tree["frontend_proj"], "frontend_proj")
        if model.pos_embed is not None:
            put(model.pos_embed, tree["pos_embed"], "pos_embed")
        span = len(cfg.layer_pattern)
        for layer, blk in enumerate(model.blocks):
            g, i = divmod(layer, span)
            src = tree["blocks"][f"pos{i}"]
            where = f"blocks/pos{i}[{g}]"
            put(blk.norm1.w, src["norm1"]["w"][g], f"{where}/norm1")
            mixer = src["mixer"]
            if isinstance(blk.mixer, SSM):
                put(blk.mixer.norm, mixer["norm"]["w"][g],
                    f"{where}/mixer/norm")
                names = ("w_in", "w_out", "A_log", "D", "dt_bias", "conv_w")
            else:
                names = ("wq", "wk", "wv", "wo", "sigma_q", "sigma_k")
            for name in names:
                put(getattr(blk.mixer, name), mixer[name][g],
                    f"{where}/mixer/{name}")
            if cfg.d_ff > 0:
                put(blk.norm2.w, src["norm2"]["w"][g], f"{where}/norm2")
                # an MoE FFN adds its router; its w1 / w2 / w3 are
                # stacked over experts ([E, D, F], [E, F, D])
                for name in ("router", "w1", "w2", "w3"):
                    w = getattr(blk.ffn, name, None)
                    if w is not None:
                        put(w, src["ffn"][name][g], f"{where}/ffn/{name}")
    model.refresh_scales()
    return model.to(device)


def shard_model(model: Transformer, mesh, rank: int | None = None
                ) -> Transformer:
    """The shard of a full model that mesh rank `rank` (default: the
    mesh's own) serves: a `Transformer` of the per-rank config
    (``sharding.local_config``) whose wq / wk / wv hold the rank's heads
    and whose lm_head holds its vocabulary slice when the vocabulary
    divides over the model axis (JAX ``serve_param_spec``); every other
    tensor is copied whole. The tensors are copies on the full model's
    device, so the full model can be dropped."""
    cfg = model.cfg
    tp = int(mesh.shape["model"])
    rank = mesh.rank if rank is None else rank
    local = Transformer(sharding.local_config(cfg, tp), device="meta")
    for name, t in named_tensors(model).items():
        key, _ = jax_key(cfg, name)
        spec = sharding.serve_param_spec(key, t.shape, mesh)
        part = sharding.shard_tensor(t.detach(), spec, mesh, rank).clone(
            memory_format=torch.contiguous_format)
        path, _, attr = name.rpartition(".")
        mod = local.get_submodule(path)
        if attr in mod._parameters:
            mod._parameters[attr] = nn.Parameter(part, requires_grad=False)
        else:
            mod._buffers[attr] = part
    local.refresh_scales()
    return local
