"""Cells at a size a CPU test can hold: the published configurations'
``port`` blocks with every width cut (a smollm-like dense decoder and a
dbrx-like MoE one, two layers each), served by short traffic, for the
tests under ``tests/``. Never used by a measured run."""
from __future__ import annotations

import copy

from hadbench import manifest

WIDTHS = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
              d_ff=128, vocab_size=256, param_dtype="float32")


def port(config: str) -> dict:
    """`config`'s port block at the tiny widths (MoE: 4 experts, top 2),
    then the configuration file's own ``"tiny"`` overrides, if any."""
    cfg = manifest.read_json("configs", config)
    p = copy.deepcopy(cfg["port"])
    p.update(WIDTHS)
    if p.get("n_experts"):
        p.update(n_experts=4, experts_per_token=2)
    p.update(copy.deepcopy(cfg.get("tiny", {})))
    return p


def traffic(loop: str = "closed", *, prefix: bool = True) -> dict:
    """A closed loop of 4 sessions (with 40-80-token cached documents
    when `prefix`) or an open loop at 40 requests/s, on a 4-slot paged
    engine of 128 positions, 8-token pages and 32-token chunks."""
    t = {"loop": loop, "clients": 4, "rate_per_s": 40.0,
         "prompt": {"tokens": [8, 16]}, "output": {"tokens": [4, 8]},
         "engine": {"max_len": 128, "batch_slots": 4, "binary": True,
                    "paged": True, "page_size": 8, "prefill_chunk": 32,
                    "prefix_cache": prefix},
         "check": {"requests": 8}}
    if prefix and loop == "closed":
        t["prefix"] = {"tokens": [40, 80]}
    return t


def one_thread():
    """Run a CPU test's model on one thread (restored after): the test
    suite runs several workers at once, and a tiny model's steps gain
    nothing from more."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def cell(config: str = "smollm-135m", loop: str = "closed", *,
         prefix: bool = True, limit: float = 1e-3) -> dict:
    """A cell as `manifest.cell` returns one, at the tiny size."""
    bench = manifest.load()
    name = f"tiny.{config}.{loop}"
    return {"name": name, "chips": 1, "config": {"port": port(config)},
            "reference": manifest.reference_name(
                manifest.read_json("configs", config)),
            "traffic": traffic(loop, prefix=prefix),
            "limits": {"gap_max": {"limit": limit}},
            "end_to_end": bench["end_to_end"],
            "per_layer": bench["per_layer"]}
