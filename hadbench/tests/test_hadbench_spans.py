"""The readers of the program's spans (``spans.py`` and its readers in
``metrics/``), on a recorded tiny traced run on the CPU: every reader that
was there reads the same whether the events carry spans or not, and
whether a step holds its event or the live recorder gives it; the new
readers read nothing from events without spans; the traced run reports
every new metric that needs no device; the program's ``engine.step``
span lies inside the profiler's ``hadbench.step`` range (one epoch
clock); and the idle attribution's arithmetic on a hand-made step."""
import copy
import importlib
import time
import types

import pytest

from hadbench import driver, manifest, program, reference, run, spans, tiny
from hadbench import trace as tr

BENCH = manifest.load()
BEFORE = ["sched_host_ms", "execute_ms.decode", "execute_ms.prefill",
          "step_mfu.decode", "step_mfu.prefill", "k2_roofline",
          "k1_roofline", "idle_share"]
NEW = ["runner_host_ms.decode", "attn_device_ms.decode",
       "ffn_device_ms.decode", "head_device_ms.decode", "gc_host_ms",
       "idle_unnamed_share", "chunk_wait_ms"]


one_thread = pytest.fixture(autouse=True)(tiny.one_thread)


@pytest.fixture(scope="module")
def recorded():
    """A tiny closed-loop cell served for 2 s, its last 1 s profiled, as
    `run.run_cell` traces it: (tracer, the window's events, Context
    arguments, the hub)."""
    from repro_torch.serve.telemetry import Telemetry
    threads = tiny.one_thread()
    next(threads)
    cell = tiny.cell()
    port, traffic = cell["config"]["port"], cell["traffic"]
    loop = importlib.import_module("hadbench.loops.closed").make(
        traffic, seed=5, vocab=port["vocab_size"], seconds=2.0)
    model = program.build_model(port, seed=5, device="cpu")
    hub = Telemetry(trace_capacity=1 << 16, clock=time.time)
    eng = program.build_engine(port, model, traffic["engine"], device="cpu",
                               telemetry=hub)
    for doc in loop.setup_prompts():
        eng.submit(doc, 0)
    eng.run()
    run.warm_up(eng, 5, port["vocab_size"])
    tr.warm_profiler()
    k0 = hub.recorder.recorded
    tracer = tr.Tracer(1.0, 1.0)
    driver.serve(eng, loop, 2.0, tracer=tracer)
    module = reference.module(cell["reference"])
    shapes = run.kernel_shapes(port, traffic["engine"], module)
    yield (tracer, hub.recorder.events()[k0:],
           (port, shapes, shapes["topn"], module), hub)
    next(threads, None)


def _context(recorded, events, keep_event: bool):
    tracer, _, args, _ = recorded
    ctx = tr.Context(tracer, events, *args)
    if keep_event:
        window = [ev for st, ev in zip(tracer.steps, events)
                  if st["in_window"]]
        for s, ev in zip(ctx.steps, window):
            s["event"] = ev
    return ctx


def _read(ctx, names):
    return {name: tr.reader(name).read(ctx) for name in names}


def test_existing_readers_read_the_same_with_or_without_spans(recorded):
    tracer, events, _, _ = recorded
    bare = [{k: v for k, v in copy.deepcopy(ev).items()
             if k not in ("spans", "device_ms")} for ev in events]
    found = _context(recorded, events, keep_event=False)
    held = _context(recorded, events, keep_event=True)
    older = _context(recorded, bare, keep_event=True)
    want = _read(found, BEFORE)
    assert want["sched_host_ms"] and want["execute_ms.decode"] \
        and want["idle_share"] is not None
    assert _read(held, BEFORE) == want
    assert _read(older, BEFORE) == want
    assert set(_read(older, NEW).values()) == {None}
    got = _read(found, NEW)
    assert _read(held, NEW) == got
    assert got["idle_unnamed_share"] is None     # no device kernels
    assert all(got[m] is not None for m in NEW
               if m != "idle_unnamed_share"), got


def test_the_traced_run_reports_every_new_metric_but_device_ones():
    for loop, suffix, cells in (("closed", "", "smollm-135m.doc_turns"),
                                ("open", ".open", "smollm-135m.short_chat")):
        cell = tiny.cell(loop=loop)
        cell["per_layer"] = [m for m in BENCH["per_layer"]
                             if cells in m["workloads"]]
        out = run.run_cell(cell, seed=6, seconds=2.0, trace=True,
                           device="cpu")
        assert out["correct"], out["check"]
        listed = {m["name"] for m in cell["per_layer"]}
        new = {m + suffix for m in NEW} & listed
        assert {m + suffix for m in NEW} - listed <= {"chunk_wait_ms.open"}
        assert new - set(out["metrics"]) == {"idle_unnamed_share" + suffix}
        for name in new - {"idle_unnamed_share" + suffix}:
            assert out["metrics"][name]["value"] >= 0, name


def test_the_step_span_lies_in_the_profilers_step_range(recorded):
    tracer, events, _, _ = recorded
    ranges = sorted(tracer.ranges)
    profiled = [ev for st, ev in zip(tracer.steps, events)
                if st["profiled"]]
    assert ranges and len(ranges) == len(profiled)
    for (a, b), ev in zip(ranges, profiled):
        step = [r for r in ev["spans"] if r[0] == "engine.step"][0]
        # float seconds near 1.7e9 hold 0.24 us
        assert a <= step[1] * 1e9 + 1e3 and step[2] * 1e9 <= b + 1e3, \
            (a, b, step[1] * 1e9, step[2] * 1e9)


def test_idle_by_span_names_the_innermost_span():
    """One step of 10 ms in a profiled range of 11 ms with one kernel of
    3 ms: each idle moment goes to the innermost span over it (a gc span
    above all), the rest is unnamed; the runner's host time is its span
    less its sync spans at any depth."""
    rows = [["engine.step", 1.000, 1.010, None, None, None],
            ["scheduler.schedule", 1.000, 1.002, 0, None, None],
            ["runner.execute", 1.002, 1.008, 0, None, None],
            ["runner.stage", 1.0025, 1.003, 2, None, None],
            ["runner.sync", 1.0026, 1.0027, 3, None, None],
            ["runner.replay", 1.003, 1.004, 2, None, None],
            ["runner.sync", 1.004, 1.007, 2, None, None],
            ["scheduler.commit", 1.008, 1.009, 0, None, None],
            ["request.wait", 0.900, 1.002, None, 7, None],
            ["gc", 1.0085, 1.0095, None, None, 2]]
    ms = 1_000_000
    kernels = [("k", 1003 * ms + ms // 2, 1006 * ms + ms // 2)]
    step = {"profiled": True, "ts": 1.009, "kind": "decode",
            "event": {"spans": rows, "device_ms": {}}}
    ctx = types.SimpleNamespace(
        steps=[step], profiled=True, kernels=kernels,
        busy=tr.union((a, b) for _, a, b in kernels),
        step_idle_ns=11 * ms - 3 * ms)
    by = spans.idle_by_span(ctx)
    assert by == {"scheduler.schedule": 2 * ms,
                  "runner.execute": ms // 2 + ms,
                  "runner.stage": ms // 2 - ms // 10,
                  "runner.sync": ms // 10 + ms // 2,
                  "runner.replay": ms // 2,
                  "scheduler.commit": ms // 2, "gc": ms,
                  spans.UNNAMED: 8 * ms - 6 * ms - ms // 2}
    assert tr.reader("idle_unnamed_share").read(ctx) == \
        pytest.approx(100 * 1.5 / 8)
    assert spans.host_less_sync(rows, "runner.execute") == \
        pytest.approx([0.006 - 0.0001 - 0.003])


def test_graph_runs_label_their_kernels_by_position():
    """Each run of a graph's operations in the profile, other operations
    in between, is one replay whose kernels take the map's regions in
    order; a run the profile holds only in part is no replay; a copy
    kernel stands for a device-to-device copy."""
    maps = {"decode": [["e", "embed"], ["a", "attn"], ["a", "attn"],
                       ["Memcpy DtoD (Device -> Device)", "attn"],
                       ["m", "mlp"], ["h", "head"]],
            "prefill": [["e", "embed"], ["p", "attn"], ["h", "head"]]}
    decode = ["e", "a", "a", "memcpy32_post", "m", "h"]
    names = (["copy"] + decode + ["copy", "e", "p", "h", "e", "p", "h"]
             + decode + ["copy"] + decode[:-1] + ["copy"] + decode)
    kernels = [(n, 10_000 * i, 10_000 * i + 1000 * (i + 1))
               for i, n in enumerate(names)]
    ctx = types.SimpleNamespace(
        steps=[], profiled=True, kernels=kernels,
        _span_hub=types.SimpleNamespace(kernel_regions=maps))
    assert spans.graph_runs(ctx) == {"decode": [1, 14, 27],
                                     "prefill": [8, 11]}

    def ms(*i):
        return sum(kernels[j][2] - kernels[j][1] for j in i) / 1e6

    assert spans.labelled(ctx, "decode", ("attn",)) == [
        pytest.approx(ms(2, 3, 4)), pytest.approx(ms(15, 16, 17)),
        pytest.approx(ms(28, 29, 30))]
    assert tr.reader("ffn_device_ms.decode").read(ctx) == \
        pytest.approx((ms(5) + ms(18) + ms(31)) / 3)
    assert spans.labelled(ctx, "prefill", ("attn", "embed")) == [
        pytest.approx(ms(8, 9)), pytest.approx(ms(11, 12))]
