"""Weight bridge: JAX parameter trees -> the port's `Transformer`.

The JAX package keeps per-layer parameters stacked along a leading
``n_groups`` axis under ``params["blocks"]["pos<i>"]`` (its serve step
scans over it). Layer ``g * len(layer_pattern) + i`` of the port is group
``g`` of pattern position ``i``; self- and cross-attention layers carry
the same weight names, SSM layers their own (``w_in``, ``w_out``,
``A_log``, ``D``, ``dt_bias``, ``conv_w``, ``norm``), MoE FFNs a float32
``router`` and expert weights stacked over experts, and a model with
cross layers carries ``frontend_proj`` too. Two sources:

* `params_from_numpy` takes the tree as numpy arrays, e.g.
  ``jax.tree.map(np.asarray, params)`` -- no jax needed here.
* `load_npz` reads the JAX checkpoint manager's format (one ``.npz`` per
  collection, keys joined by ``//``) with numpy alone.

bfloat16 arrays are recognised by dtype name (``ml_dtypes``' bfloat16, or
the 2-byte void dtype numpy gives them when ``ml_dtypes`` is absent) and
reinterpreted bit for bit through ``uint16``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import SSM
from repro_torch.models.transformer import Transformer

SEP = "//"


def to_torch(arr) -> torch.Tensor:
    """numpy array (incl. bfloat16) -> CPU tensor with the same bits."""
    arr = np.array(arr, order="C")                 # an owned copy, 0-d too
    if arr.dtype.name == "bfloat16" or arr.dtype == np.dtype("V2"):
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


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
