"""The seam between a configuration and its model module
(``hadbench/reference/__init__.py``): a configuration file that names a
module is judged, drawn, FLOP-counted and roofline-counted through it; a
hybrid block of SSM and attention layers builds through the program when
its module gives rules for the SSM's vectors, and fails by name without
them; a configuration's own ``"tiny"`` overrides reach its CPU tests."""
import collections
import dataclasses
import json
import math
import shutil
import sys
import types

import pytest
import torch

from hadbench import manifest, program, reference, run, tiny, weights
from hadbench.reference import model as base

BENCH = manifest.load()
FAKE = "seam_fake"


one_thread = pytest.fixture(autouse=True)(tiny.one_thread)


def _fake_module(calls: collections.Counter) -> types.ModuleType:
    """A model module that counts every call into it: the default
    module's equations, `mixer.wq` drawn through a rule (the default's
    own draw of a matrix, so the reference still agrees), and one layer
    of K1 and K2 launches."""
    mod = types.ModuleType(f"hadbench.reference.{FAKE}")

    class Reference(base.Reference):
        def __init__(self, *a, **kw):
            calls["Reference"] += 1
            super().__init__(*a, **kw)

    def wq(x, gen):
        calls["rule"] += 1
        torch.nn.init.trunc_normal_(x, std=1.0, a=-2.0, b=2.0, generator=gen)
        return x.mul_(x.shape[-2] ** -0.5)

    def flops_per_token(*a, **kw):
        calls["flops_per_token"] += 1
        return base.flops_per_token(*a, **kw)

    def attn_layers(port):
        calls["attn_layers"] += 1
        return 1

    mod.Reference, mod.param_specs = Reference, base.param_specs
    mod.draw_rules = {".mixer.wq": wq}
    mod.flops_per_token, mod.attn_layers = flops_per_token, attn_layers
    return mod


def _files(tmp_path, monkeypatch, name: str, config: dict) -> None:
    """The benchmark's data files under `tmp_path`, plus `config` as
    ``configs/<name>.json``."""
    for kind in ("configs", "traffic", "limits"):
        shutil.copytree(manifest.HERE / kind, tmp_path / kind)
    (tmp_path / "configs" / f"{name}.json").write_text(json.dumps(config))
    monkeypatch.setattr(manifest, "HERE", tmp_path)


def test_a_configuration_runs_through_the_module_it_names(tmp_path,
                                                         monkeypatch):
    calls = collections.Counter()
    monkeypatch.setitem(sys.modules, f"hadbench.reference.{FAKE}",
                        _fake_module(calls))
    port = tiny.port("smollm-135m")
    _files(tmp_path, monkeypatch, "tiny-seam",
           {"source": "a test", "reduced": [], "reference": FAKE,
            "port": port})
    (tmp_path / "traffic" / "tiny_seam.json").write_text(
        json.dumps(tiny.traffic()))
    (tmp_path / "limits" / "tiny-seam.tiny_seam.json").write_text(
        json.dumps({"gap_max": {"limit": 1e-3}}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "tiny-seam.tiny_seam",
                               "config": "tiny-seam", "traffic": "tiny_seam",
                               "chips": 1, "why": "a test"})
    cell = manifest.cell(bench, "tiny-seam.tiny_seam")
    assert cell["reference"] == FAKE
    cell["per_layer"] = [m for m in BENCH["per_layer"]
                         if "smollm-135m.doc_turns" in m["workloads"]]
    out = run.run_cell(cell, seed=7, seconds=2.0, trace=True, device="cpu")
    assert out["correct"], out["check"]
    assert "step_mfu.decode" in out["metrics"]
    # judged by its Reference, drawn through its rule (wq of both layers),
    # FLOP-counted by it, its attention layers in the kernels' shapes
    assert calls["Reference"] == 1
    assert calls["rule"] == port["n_layers"]
    assert calls["flops_per_token"] > 0
    assert calls["attn_layers"] >= 1
    shapes = run.kernel_shapes(port, cell["traffic"]["engine"],
                               reference.module(FAKE))
    assert shapes["attn_layers"] == 1


def _hybrid_port() -> dict:
    """The port's reduced jamba-1.5-large-398b: one MMMMAMMM group at
    d 64, MoE every second layer."""
    from repro_torch.configs import get_config
    return dataclasses.asdict(get_config("jamba-1.5-large-398b",
                                         reduced=True))


def _dt_bias(x, gen):
    """softplus^-1 of a step log-uniform in [0.001, 0.1]."""
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = x.uniform_(generator=gen).mul_(hi - lo).add_(lo).exp_()
    return dt + torch.log(-torch.expm1(-dt))


SSM_RULES = {
    ".mixer.A_log": lambda x, gen: x.uniform_(1.0, 16.0,
                                              generator=gen).log_(),
    ".mixer.D": lambda x, gen: x.fill_(1.0),
    ".mixer.dt_bias": _dt_bias,
    ".mixer.norm": lambda x, gen: x.fill_(1.0),
}


def test_a_hybrid_block_builds_through_its_modules_draw_rules():
    port = _hybrid_port()
    assert port["layer_pattern"] == "MMMMAMMM" and port["d_model"] == 64
    model = program.build_model(port, seed=11, device="cpu", rules=SSM_RULES)
    params = dict(model.named_parameters())
    assert all(bool(p.isfinite().all()) for p in params.values())
    # a rule draws from the tensor's own generator
    name = "blocks.0.mixer.A_log"
    gen = torch.Generator().manual_seed(weights.tensor_seed(11, name))
    want = torch.empty(params[name].shape).uniform_(1.0, 16.0,
                                                    generator=gen).log_()
    assert torch.equal(params[name], want)
    assert bool((params["blocks.3.mixer.norm"] == 1).all())
    # what no rule names keeps the default draw
    for name in ("blocks.0.mixer.w_in", "blocks.4.mixer.wk",
                 "blocks.1.ffn.router"):
        p = params[name]
        assert torch.equal(p, weights.draw(name, p.shape, seed=11,
                                           device="cpu", dtype=p.dtype))


def test_without_rules_the_first_undefined_tensor_is_named():
    with pytest.raises(ValueError, match=r"blocks\.0\.mixer\.A_log\b"):
        program.build_model(_hybrid_port(), seed=11, device="cpu")


def test_tiny_takes_a_configurations_own_overrides(tmp_path, monkeypatch):
    for config in ("smollm-135m", "dbrx-132b-l8"):
        assert "tiny" not in manifest.read_json("configs", config)
    cfg = manifest.read_json("configs", "dbrx-132b-l8")
    cfg["tiny"] = {"n_layers": 3, "d_ff": 96, "experts_per_token": 1}
    _files(tmp_path, monkeypatch, "tiny-over", cfg)
    got = tiny.port("tiny-over")
    want = {**tiny.port("dbrx-132b-l8"), **cfg["tiny"]}
    assert got == want
    assert tiny.cell("tiny-over")["reference"] == reference.DEFAULT


@pytest.mark.parametrize("name", ["../model", "model.x", "", "2model"])
def test_a_bad_module_name_is_refused(name):
    with pytest.raises(ValueError, match="model module"):
        reference.module(name)
