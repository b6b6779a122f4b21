"""Training checkpoints (torch twin of ``repro.checkpoint.manager``):
atomic saves with retention, in the JAX manager's layout.

* every save goes to ``<dir>/step_<N>.tmp/`` and is published by
  ``os.rename`` to ``step_<N>/`` (a crash mid-save never corrupts the
  latest checkpoint);
* each collection is one ``.npz`` of a nested dict's leaves under their
  ``//``-joined key paths, plus a JSON manifest (step, collections, meta)
  -- the keys JAX's ``_flatten`` gives the same tree, so a checkpoint of
  one package restores into the other (a model's tensors go through
  `bridge.to_jax_flat` first: the training state's `state_tree`);
* `restore` fills a template's structure and dtypes;
* retention keeps the last `keep` checkpoints, deleting older ones only
  after a successful publish.

Leaves are numpy arrays or tensors (written with `bridge.to_numpy`:
bfloat16 as 2-byte void, the bytes JAX writes).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.checkpoint.bridge import SEP, to_numpy


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}{SEP}{key}" if prefix else str(key)
        if isinstance(val, dict):
            flat.update(_flatten(val, path))
        else:
            flat[path] = (to_numpy(val) if isinstance(val, torch.Tensor)
                          else np.asarray(val))
    return flat


def _unflatten_into(template, flat: dict[str, np.ndarray],
                    prefix: str = ""):
    out = {}
    for key, val in template.items():
        path = f"{prefix}{SEP}{key}" if prefix else str(key)
        if isinstance(val, dict):
            out[key] = _unflatten_into(val, flat, path)
            continue
        if path not in flat:
            raise KeyError(f"checkpoint missing leaf {path}")
        arr = flat[path]
        want = (to_numpy(val.reshape(-1)[:0]).dtype
                if isinstance(val, torch.Tensor) else np.asarray(val).dtype)
        if arr.dtype != want:
            arr = arr.astype(want)
        out[key] = arr
    return out


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, collections: dict,
             meta: dict | None = None) -> str:
        """collections: e.g. {"state": nested dict of tensors}."""
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for name, tree in collections.items():
            np.savez(os.path.join(tmp, f"{name}.npz"), **_flatten(tree))
        manifest = {"step": step, "collections": sorted(collections),
                    "meta": meta or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)       # atomic publish
        self._gc()
        return final

    def restore(self, templates: dict, *, step: int | None = None
                ) -> tuple[int, dict]:
        """Restore collections into `templates`' structure and dtypes, as
        nested dicts of numpy arrays."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self._step_dir(step)
        out = {}
        for name, template in templates.items():
            with np.load(os.path.join(d, f"{name}.npz")) as z:
                flat = {k: z[k] for k in z.files}
            out[name] = _unflatten_into(template, flat)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["step"] == step
        return step, out

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
