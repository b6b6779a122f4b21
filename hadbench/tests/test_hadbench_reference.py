"""The plain reference against the port at a reduced size on the CPU, for
a dense and an MoE configuration, and the fp8 control failing where the
port passes."""
import numpy as np
import pytest
import torch

from hadbench import check, manifest, program, reference, run, tiny, weights
from hadbench.reference.model import Reference, topn

BENCH = manifest.load()


one_thread = pytest.fixture(autouse=True)(tiny.one_thread)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_weights_are_the_ports_parameters(config):
    """The program's parameters are its configuration's model module's
    `param_specs`, each drawn again alike by itself."""
    port = tiny.port(config)
    mod = reference.module(
        manifest.reference_name(manifest.read_json("configs", config)))
    model = program.build_model(port, seed=11, device="cpu",
                                rules=mod.draw_rules)
    got = {n: (tuple(p.shape), str(p.dtype).split(".")[1])
           for n, p in model.named_parameters()}
    want = {n: (tuple(s), dt) for n, s, dt in mod.param_specs(port)}
    assert got == want
    for name, p in model.named_parameters():
        again = weights.draw(name, p.shape, seed=11, device="cpu",
                             dtype=p.dtype, rules=mod.draw_rules)
        assert torch.equal(p, again), name


@pytest.mark.parametrize("config,prefix", [("smollm-135m", True),
                                           ("dbrx-132b-l8", False)])
def test_port_serves_the_references_best_tokens(config, prefix):
    """Prefill over cached prefixes (dense) and chunks (MoE), then decode
    through the paged pool: every served token is the reference's best,
    to float32 rounding."""
    cell = tiny.cell(config, prefix=prefix)
    out = run.run_cell(cell, seed=2 ** 31 + 3, seconds=1.0, trace=False,
                       device="cpu")
    assert out["correct"], out["check"]
    # decoded tokens, not only each prompt's first
    assert out["info"]["checked_tokens"] > out["info"]["checked_requests"]
    assert out["check"]["gap_max"]["value"] <= 1e-4


def test_the_fp8_control_fails_where_the_port_passes():
    port = tiny.port("smollm-135m")
    gen = np.random.default_rng(0)
    recs = []
    ref = Reference(port, seed=5, max_len=128, device="cpu")
    for rid in range(3):
        prompt = gen.integers(0, port["vocab_size"], 40 + 9 * rid)
        toks = []
        for _ in range(12):     # greedy on the float32 reference itself
            seq = np.concatenate([prompt, toks]).astype(np.int64)
            toks.append(int(ref.logits([seq], [[len(seq) - 1]])[0]
                            .argmax()))
        recs.append(type("R", (), {"prompt": prompt, "tokens": toks})())
    mod = reference.module()
    sound = check.served_gaps(mod, port, recs, seed=5, max_len=128,
                              device="cpu")
    ctl = check.served_gaps(mod, port, recs, seed=5, max_len=128,
                            device="cpu", quant="fp8")
    assert sound.max() == 0.0
    assert ctl.max() > 1e-2
    assert topn(port, 128) == 16


def test_the_control_is_judged_as_the_program_is():
    """A run with the control on: the program's tokens pass its cell's
    comparison and the fp8 control's, put in their place, fail it."""
    out = run.run_cell(tiny.cell(), seed=21, seconds=1.0, trace=False,
                       device="cpu", control="fp8")
    ctl = out["info"]["control"]
    assert out["correct"], out["check"]
    assert set(ctl["check"]) == set(out["check"])
    assert ctl["correct"] is False, ctl
