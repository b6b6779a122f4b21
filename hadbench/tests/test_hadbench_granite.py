"""granite-4.0-h-small through the harness at its ``"tiny"`` size on the
CPU: the port's Engine (chunked prefill, decode through the paged cache
and the pooled SSM state, a document's checkpoint restored under a turn)
gives the plain reference's logits (``reference/granite.py``), and a
bfloat16 port, one whose conv leaves B and C out, or one whose
restore zeroes the document's state does not; the model
module's seams (its tensors, draws, FLOPs, attention layers) as
``test_hadbench_model_modules.py`` holds them; the two cells load; the
replay loop gives every seed the same work; and the new readers read a
recorded event set."""
import copy
import importlib
import time

import numpy as np
import pytest
import torch

from hadbench import driver, manifest, program, reference, run, tiny, weights
from hadbench import trace as tr
from hadbench.reference import granite

BENCH = manifest.load()
CONFIG = "granite-4.0-h-small"
CELLS = ("smollm-135m.long_prompt", "granite-4.0-h-small.long_doc_turns")
# float32 on both sides: the reference's SSD runs over the whole sequence
# in chunks of 8 while the port's restarts at every prefill chunk and
# restored checkpoint, and the GEMMs and HAD's softmax sum in other
# orders. The tiny logits spread by ~7e-3 (the full size's spread: the
# "tiny" block's logits_scaling 2 makes up for the narrower width) and
# agree within 4e-8; bfloat16 moves them by 4e-2, a conv over x alone
# by 2e-2, a restore that zeroes the document's state by 9e-3
TOL = dict(rtol=0, atol=1e-6)


one_thread = pytest.fixture(autouse=True)(tiny.one_thread)


def _served_logits(port, monkeypatch, mutate=None):
    """Serve a document (into the prefix cache), two turns over it and a
    fresh prompt, one at a time, greedy, through the Engine on pooled
    state with documents' checkpoints; return the port's logits at every
    served token and the reference's at the same positions."""
    from repro_torch.serve import runner as R
    model = program.build_model(port, seed=17, device="cpu",
                                rules=granite.draw_rules)
    if mutate is not None:
        mutate(model, monkeypatch)
    eng = program.build_engine(port, model, dict(
        tiny.traffic()["engine"], state_checkpoints="documents"), device="cpu")
    rows = []
    sample = R._sample_token

    def record(logits, sp, rng):
        rows.append(np.array(logits, np.float64))
        return sample(logits, sp, rng)

    monkeypatch.setattr(R, "_sample_token", record)
    gen = np.random.default_rng(3)
    doc = gen.integers(0, port["vocab_size"], 45)
    eng.submit(doc, 0)
    eng.run()
    seqs, pos, got = [], [], []
    for prompt, n in ((np.concatenate([doc, gen.integers(0, 256, 9)]), 6),
                      (np.concatenate([doc, gen.integers(0, 256, 30)]), 5),
                      (gen.integers(0, 256, 37), 4)):
        k = len(rows)
        rid = eng.submit(prompt, n)
        toks = eng.run()[rid]
        got += rows[k:]
        seqs.append(np.concatenate([prompt, toks[:-1]]))
        pos.append(np.arange(len(prompt) - 1, len(prompt) - 1 + len(toks)))
    assert eng.stats["state_restores"] == 2
    assert eng.stats["state_misses"] == 0
    ref = granite.Reference(port, seed=17, max_len=128, device="cpu")
    want = torch.cat(ref.logits(seqs, pos)).double().numpy()
    return np.stack(got), want


def test_port_prefill_then_decode_equals_the_references_logits(monkeypatch):
    port = tiny.port(CONFIG)
    got, want = _served_logits(port, monkeypatch)
    assert got.shape == want.shape == (15, port["vocab_size"])
    np.testing.assert_allclose(got, want, **TOL)


def _conv_x_alone(model, monkeypatch):
    """The conv over x alone: B and C reach the SSD unconvolved."""
    from repro_torch.models import ssm
    mix_in = ssm._mix_in

    def mixed(p, x, cfg, conv_state, n_valid=None):
        _, _, b, c, _ = ssm._split_in(p, x, cfg)
        xs, z, _, _, dt, conv = mix_in(p, x, cfg, conv_state, n_valid)
        return xs, z, b, c, dt, conv

    monkeypatch.setattr(ssm, "_mix_in", mixed)


def _restore_zeroed(model, monkeypatch):
    """A checkpoint restore that zeroes the live state entry instead of
    copying the document's checkpoint into it."""
    from repro_torch.serve import runner as R
    copy_ = R.ModelRunner._state_copy

    def zeroed(self, src, dst, count=True):
        if count:
            return copy_(self, src, dst, count)
        self._state_zero(np.array([dst]), self._state_layers)

    monkeypatch.setattr(R.ModelRunner, "_state_copy", zeroed)


@pytest.mark.parametrize("fault", ["bfloat16", "conv_x_alone",
                                   "restore_zeroed"])
def test_a_lower_precision_or_a_conv_without_b_c_fails(fault, monkeypatch):
    port = tiny.port(CONFIG)
    if fault == "bfloat16":
        port = dict(port, param_dtype="bfloat16")
        want = _served_logits(tiny.port(CONFIG), monkeypatch)[1]
        got = _served_logits(port, monkeypatch)[0]
    else:
        got, want = _served_logits(port, monkeypatch, {
            "conv_x_alone": _conv_x_alone,
            "restore_zeroed": _restore_zeroed}[fault])
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, **TOL)


def test_the_module_gives_every_tensor_and_draws_it():
    """Its tensors are the program's parameters, each 1-d one drawn by a
    rule from its own generator; without the rules the first undefined
    tensor is named."""
    port = tiny.port(CONFIG)
    model = program.build_model(port, seed=11, device="cpu",
                                rules=granite.draw_rules)
    params = dict(model.named_parameters())
    assert {n: tuple(p.shape) for n, p in params.items()} == \
        {n: tuple(s) for n, s, _ in granite.param_specs(port)}
    assert all(bool(p.isfinite().all()) for p in params.values())
    name = "blocks.0.mixer.conv_b"
    gen = torch.Generator().manual_seed(weights.tensor_seed(11, name))
    want = torch.empty(params[name].shape).uniform_(-0.5, 0.5, generator=gen)
    assert torch.equal(params[name], want)
    a = -torch.exp(params["blocks.0.mixer.A_log"])
    assert bool(((a <= -1) & (a >= -16)).all())
    with pytest.raises(ValueError, match=r"blocks\.0\.mixer\.A_log\b"):
        program.build_model(port, seed=11, device="cpu")


def test_flops_and_attention_layers_follow_the_pattern():
    cfg = manifest.read_json("configs", CONFIG)
    port = cfg["port"]
    assert cfg["reference"] == "granite" and cfg["reduced"] == []
    assert granite.attn_layers(port) == 4
    assert granite.kinds(port)[5::10] == "AAAA"
    shapes = run.kernel_shapes(port, manifest.read_json(
        "traffic", "long_doc_turns")["engine"], reference.module("granite"))
    assert shapes["attn_layers"] == 4 and shapes["topn"] == 2935
    # 2 x the active parameters a token (9 B published), the head and
    # the keys kept aside: 36 mixers of 102.3 M, 4 attention layers of
    # 41.9 M, 40 FFNs of 10 routed experts and the shared one
    f = granite.flops_per_token(port, 1, 2935, head=False)
    assert 2 * 8.0e9 < f < 2 * 9.5e9
    head = granite.flops_per_token(port, 1, 2935) - f
    assert head == 2.0 * 4096 * 100352
    assert granite.flops_per_token(port, 3000, 2935, head=False) > f


def test_the_published_numbers_are_the_ports():
    """The configuration file holds the catalog's numbers, and the port
    block is the port's registered granite configuration."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = manifest.read_json("configs", CONFIG)
    want = dataclasses.asdict(get_config(CONFIG))
    got = dataclasses.asdict(program.model_config(cfg["port"]))
    for key in cfg["port"]:
        assert got[key] == want[key], key
    assert cfg["layer_types"] == ["attention" if k == "A" else "mamba"
                                  for k in granite.kinds(cfg["port"])]
    for key, port_key in (("hidden_size", "d_model"),
                          ("intermediate_size", "d_ff"),
                          ("num_local_experts", "n_experts"),
                          ("num_experts_per_tok", "experts_per_token"),
                          ("mamba_d_state", "ssm_state"),
                          ("mamba_d_head", "ssm_head_dim"),
                          ("mamba_chunk_size", "ssm_chunk"),
                          ("shared_intermediate_size",
                           "shared_expert_width"),
                          ("embedding_multiplier", "embedding_multiplier"),
                          ("residual_multiplier", "residual_multiplier"),
                          ("attention_multiplier", "attention_multiplier"),
                          ("logits_scaling", "logits_scaling")):
        assert cfg[key] == cfg["port"][port_key], key
    assert cfg["mamba_n_heads"] == granite.ssm_sizes(cfg["port"])["nh"]


# each cell's end-to-end metrics: those whose six-seed quartile spread on
# the card stayed within a third of their bounds (PERF.md §6)
REPORTED = {CELLS[0]: {"setup_s", "ttft_p95_ms", "itl_p50_ms"},
            CELLS[1]: {"setup_s", "itl_p50_ms", "itl_p95_ms"}}


@pytest.mark.parametrize("workload", CELLS)
def test_the_cell_loads(workload):
    cell = manifest.cell(BENCH, workload)
    assert cell["chips"] == 1
    assert {m["name"] for m in cell["end_to_end"]} == REPORTED[workload]
    assert set(cell["limits"]) == {"gap_mean"}
    if workload.startswith(CONFIG):
        assert cell["reference"] == "granite"
        assert {"ssm_device_ms.decode", "state_restore_share"} <= \
            {m["name"] for m in cell["per_layer"]}
        assert cell["traffic"]["engine"]["state_checkpoints"] == "documents"
    else:
        assert cell["traffic"]["loop"] == "replay"


def test_replay_gives_every_seed_the_same_work():
    traffic = manifest.read_json("traffic", "long_prompt")
    mod = importlib.import_module("hadbench.loops.replay")
    runs = []
    for seed in (1, 2 ** 31 + 5):
        loop = mod.make(traffic, seed=seed, vocab=49152, seconds=30.0)
        assert loop.setup_prompts() == []
        loop.start(100.0)
        assert loop.next_due() == 100.0
        sent = loop.due(101.6)
        assert [(r.client, r.due) for r in sent] == [(0, 100.0), (1, 101.5)]
        for _ in range(9):          # each client finishes, sends again
            for r in list(sent[-2:]):
                loop.finished(r, 200.0)
            sent += loop.due(200.0)
        runs.append(sent)
    a, b = runs
    sizes = [[(len(r.tokens), r.max_new) for r in x if r.client == c]
             for x in (a, b) for c in (0, 1)]
    sched = [tuple(e) for e in traffic["schedule"]]
    assert sizes[0] == sizes[2] == [sched[i % 8] for i in range(10)]
    assert sizes[1] == sizes[3] == [sched[(4 + i) % 8] for i in range(10)]
    assert not any(np.array_equal(x.tokens, y.tokens) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def recorded():
    """The tiny granite cell served for 4 s, its last 1 s profiled, as
    `run.run_cell` traces it: (tracer, the window's events, Context
    arguments, the engine). The window leaves decode-only steps
    unprofiled even on a loaded CPU."""
    from repro_torch.serve.telemetry import Telemetry
    threads = tiny.one_thread()
    next(threads)
    cell = tiny.cell(CONFIG)
    port = cell["config"]["port"]
    # two sessions with long outputs, so most steps decode alone
    traffic = dict(cell["traffic"], clients=2, output={"tokens": [24, 32]})
    engine = dict(traffic["engine"], state_checkpoints="documents")
    loop = importlib.import_module("hadbench.loops.closed").make(
        traffic, seed=5, vocab=port["vocab_size"], seconds=4.0)
    model = program.build_model(port, seed=5, device="cpu",
                                rules=granite.draw_rules)
    hub = Telemetry(trace_capacity=1 << 16, clock=time.time)
    eng = program.build_engine(port, model, engine, device="cpu",
                               telemetry=hub)
    for doc in loop.setup_prompts():
        eng.submit(doc, 0)
    eng.run()
    run.warm_up(eng, 5, port["vocab_size"])
    tr.warm_profiler()
    k0 = hub.recorder.recorded
    tracer = tr.Tracer(3.0, 1.0)
    driver.serve(eng, loop, 4.0, tracer=tracer)
    shapes = run.kernel_shapes(port, engine, granite)
    events = hub.recorder.events()[k0:]
    yield tracer, events, (port, shapes, shapes["topn"], granite), eng
    next(threads, None)


def test_the_new_readers_read_a_recorded_run(recorded):
    tracer, events, args, eng = recorded
    ctx = tr.Context(tracer, events, *args)
    ssm_ms = tr.reader("ssm_device_ms.decode").read(ctx)
    share = tr.reader("state_restore_share").read(ctx)
    assert ssm_ms is not None and ssm_ms > 0
    window = [ev for st, ev in zip(tracer.steps, events) if st["in_window"]]
    fresh = [a for ev in window for a in ev["admissions"]
             if a["resume"] == "fresh"]
    assert fresh
    assert share == 100.0 * sum(a["state_restore"] >= 0
                                for a in fresh) / len(fresh)
    assert share > 50.0
    assert eng.stats["state_misses"] == 0
    # events of a program whose rows say nothing of restores, or that
    # carry no spans: nothing to read
    older = copy.deepcopy(events)
    for ev in older:
        for a in ev["admissions"]:
            a.pop("state_restore")
    ctx = tr.Context(tracer, older, *args)
    for s, ev in zip(ctx.steps, [e for st, e in zip(tracer.steps, older)
                                 if st["in_window"]]):
        s["event"] = ev
    assert tr.reader("state_restore_share").read(ctx) is None
    bare = [{k: v for k, v in copy.deepcopy(ev).items()
             if k not in ("spans", "device_ms")} for ev in events]
    ctx = tr.Context(tracer, bare, *args)
    for s, ev in zip(ctx.steps, [e for st, e in zip(tracer.steps, bare)
                                 if st["in_window"]]):
        s["event"] = ev
    assert tr.reader("ssm_device_ms.decode").read(ctx) is None
    assert tr.reader("state_restore_share").read(ctx) is None
