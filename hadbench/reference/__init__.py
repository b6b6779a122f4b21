"""The plain float32 references that decide ``correct``, one model module
a kind of model, and the lower-precision control each is shown to fail
with. A configuration names its module with a top-level ``"reference"``
key (``reference/<name>.py``); with none it is ``model.py``, the decoders
of HAD attention layers with SwiGLU or MoE FFNs.

A model module owns what the harness reads of a model's equations:

- `Reference(port, *, seed, max_len, device, quant=None)` with
  `logits(seqs, positions)`: the reference forward (``check.py``);
- `param_specs(port)`: (name, shape, dtype name) of every tensor;
- `draw_rules`: name suffix -> fill(x, gen) for the tensors that
  ``weights.draw``'s default does not define, drawn from the tensor's
  own generator (``program.build_model`` and the module's `Reference`);
- `flops_per_token(port, context, n, head=True)`: model FLOPs of one
  token (``metrics.step_mfu``, through ``trace.Context``);
- `attn_layers(port)`: the layers that launch K1 and K2
  (``run.kernel_shapes``, read by ``kernels/``).

A later configuration of another kind brings its module as a new file.
"""
from __future__ import annotations

import importlib
import re

DEFAULT = "model"
NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def module(name: str = DEFAULT):
    """The model module ``hadbench/reference/<name>.py``."""
    if not NAME.match(name):
        raise ValueError(f"bad model module name {name!r}")
    return importlib.import_module(f"{__name__}.{name}")
