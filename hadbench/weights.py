"""Seeded weights, drawn tensor by tensor.

Each tensor comes from its own generator, seeded by the run's seed and
the tensor's name, on the device that serves it and in a few large calls,
so the plain reference can draw one layer again by itself and get the
same numbers the program was given. Names and layouts ([in, out]; stacked
experts [E, in, out]) are the port's parameter names, which `param_specs`
works out from a configuration's ``port`` block alone.

Distributions: token embeddings normal at std 0.02 (the published
initializer range); norm weights ones; float32 routers truncated normal
at std 0.02; every other matrix truncated normal (+-2 sigma) at std
fan_in ** -0.5, fan_in being its input width. A model module
(``hadbench/reference/``) gives rules for the tensors this does not
define, such as an SSM's per-head vectors.
"""
from __future__ import annotations

import hashlib

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def tensor_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed from the run's seed (any integer) and a
    tensor's name."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def draw(name: str, shape, *, seed: int, device, dtype,
         rules: dict | None = None) -> torch.Tensor:
    """The tensor `name` of the run seeded `seed`, in `dtype`. `rules` (a
    model module's ``draw_rules``: name suffix -> fill(x, gen), which
    fills the float32 tensor x from the tensor's generator gen and
    returns it) come before the default, whose matrices need a fan-in:
    any other tensor of fewer than two dimensions raises."""
    shape = tuple(int(s) for s in shape)
    rule = next((fill for suffix, fill in (rules or {}).items()
                 if name.endswith(suffix)), None)
    if rule is None and name.endswith(".w"):     # norm weights
        return torch.ones(shape, dtype=dtype, device=device)
    if rule is None and len(shape) < 2:
        raise ValueError(f"no draw for {name} {list(shape)}: the default "
                         "draws matrices; give a rule in the model "
                         "module's draw_rules")
    gen = torch.Generator(device=device).manual_seed(tensor_seed(seed, name))
    x = torch.empty(shape, dtype=torch.float32, device=device)
    if rule is not None:
        return rule(x, gen).to(dtype)
    if name == "embed":
        x.normal_(0.0, 0.02, generator=gen)
        return x.to(dtype)
    std = 0.02 if name.endswith(".router") else shape[-2] ** -0.5
    torch.nn.init.trunc_normal_(x, std=1.0, a=-2.0, b=2.0, generator=gen)
    return x.mul_(std).to(dtype)


def layer_specs(port: dict, i: int) -> list[tuple[str, tuple, str]]:
    """(name, shape, dtype name) of layer i's tensors."""
    d, f = port["d_model"], port["d_ff"]
    h, hk, dh = port["n_heads"], port["n_kv_heads"], port["head_dim"]
    dt = port["param_dtype"]
    p = f"blocks.{i}."
    out = [(p + "norm1.w", (d,), dt), (p + "mixer.wq", (d, h * dh), dt),
           (p + "mixer.wk", (d, hk * dh), dt),
           (p + "mixer.wv", (d, hk * dh), dt),
           (p + "mixer.wo", (h * dh, d), dt), (p + "norm2.w", (d,), dt)]
    e = port.get("n_experts", 0)
    if e:
        out += [(p + "ffn.router", (d, e), "float32"),
                (p + "ffn.w1", (e, d, f), dt), (p + "ffn.w2", (e, f, d), dt),
                (p + "ffn.w3", (e, d, f), dt)]
    else:
        out += [(p + "ffn.w1", (d, f), dt), (p + "ffn.w2", (f, d), dt),
                (p + "ffn.w3", (d, f), dt)]
    return out


def outer_specs(port: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, dtype name) of the tensors outside the layers."""
    d, v, dt = port["d_model"], port["vocab_size"], port["param_dtype"]
    out = [("embed", (v, d), dt), ("final_norm.w", (d,), dt)]
    if not port.get("tie_embeddings", False):
        out.append(("lm_head", (d, v), dt))
    return out


def param_specs(port: dict) -> list[tuple[str, tuple, str]]:
    """Every tensor of the model a configuration's ``port`` block
    describes (a decoder of self-attention layers with dense SwiGLU or
    MoE FFNs)."""
    specs = outer_specs(port)
    for i in range(port["n_layers"]):
        specs += layer_specs(port, i)
    return specs
