"""Pipelined and asyncio serving in the port (Engine.step_pipelined,
serve/async_engine.py), and the rest of the Engine and launcher surface.

Inside the port, bit for bit: the sync engine == the pipelined engine ==
the asyncio engine, on the JAX tests' sampled workload (temperature 0.8,
top-k 8), binary and fp, over an overcommitted pool that preempts by swap;
the two step graphs stay two; mixing `step()` and `step_pipelined()` loses
nothing; `execute_async` hands the decode logits to the runner's host
buffer. Against the JAX Engine: the lockstep `prefill()` / `decode()`
logits (allclose). Also: lockstep logits are copies, a lockstep reset
keeps the graphs, `dump_trace` / `reset_stats`, and the launcher's serving
flags. On the card (`cuda` marker): pipelined == sync and the asyncio
engine from its first step, both step graphs captured in its worker.
"""
import asyncio
import json
import time

import numpy as np
import pytest
import torch

from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.serve import (AsyncEngine, Engine, SamplingParams,
                               ServeConfig, SLORejected, Telemetry)
from repro_torch.serve.telemetry import load_trace

from test_torch_serve import LOGIT_TOL, ARCH, _cfgs, _model, _params

OVERCOMMIT = dict(paged=True, page_size=4, n_pages=9, prefix_cache=True,
                  swap_pages=32)
PATHS = {"binary-dense": dict(paged=False),
         "binary-overcommit": OVERCOMMIT,
         "fp-overcommit": dict(OVERCOMMIT, binary=False),
         "binary-page_topn-overcommit": dict(OVERCOMMIT, page_topn=2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


def _scfg(**kw):
    return ServeConfig(batch_slots=2, max_len=48, prefill_chunk=8, topn=6,
                       **kw)


def _engine(kw, device="cpu", model=None, telemetry=None):
    _, tcfg = _cfgs()
    model = _model() if model is None else model
    return Engine(tcfg, model, _scfg(**kw), telemetry=telemetry,
                  device=device)


def _workload():
    """The JAX pipelined tests' workload: six prompts, sampled decoding."""
    rng = np.random.default_rng(42)
    return [(rng.integers(1, 64, n).astype(np.int32), 6 + k % 3,
             SamplingParams(temperature=0.8, top_k=8, seed=k))
            for k, n in enumerate((11, 7, 19, 5, 13, 9))]


def _submit_workload(eng):
    return [eng.submit(p, max_new_tokens=g, sampling=sp)
            for p, g, sp in _workload()]


def _sync_vs_pipelined(kw, device="cpu", model=None):
    ref_eng = _engine(kw, device, model)
    ids = _submit_workload(ref_eng)
    ref = ref_eng.run()
    eng = _engine(kw, device, model)
    assert _submit_workload(eng) == ids
    out = eng.run_pipelined()
    assert set(out) == set(ref)
    for rid in ref:
        np.testing.assert_array_equal(out[rid], ref[rid])
    eng.check()
    assert eng.stats["pipelined_steps"] > 0 and eng._inflight is None
    assert eng.runner.graph_count() == 2
    if kw.get("swap_pages"):
        assert eng.stats["preemptions"] > 0      # overcommit saw pressure
        assert eng.stats["replayed_tokens"] == 0
        assert eng.allocator.in_use == 0 and eng.swap.in_use == 0
    return eng


@pytest.mark.parametrize("path", list(PATHS))
def test_pipelined_outputs_bit_identical_to_sync(path):
    _sync_vs_pipelined(PATHS[path])


def test_overlap_fraction_and_step_events():
    """Pipelined step events carry overlap timings and the `pipelined`
    flag; sync events keep exactly the four original keys;
    `overlap_stats()` reports its four keys. The overlap is measured on
    the engine thread's CPU clock: on the wall clock, a worker that the
    OS takes off the CPU during the first `schedule()` (which no step can
    overlap) for a few ms fails the bound at once (8 of 40 runs beside six
    busy processes, first schedule 8-46 ms of wall time for 0.2-0.5 ms of
    CPU time; 0 of 40 on this clock)."""
    tel = Telemetry(clock=time.thread_time)
    eng = _engine(OVERCOMMIT, telemetry=tel)
    _submit_workload(eng)
    eng.run_pipelined()
    ov = eng.overlap_stats()
    assert set(ov) == {"schedule_s", "overlap_s", "pipelined_steps",
                       "overlap_frac"}
    assert ov["pipelined_steps"] == eng.stats["pipelined_steps"] > 0
    assert 0.5 < ov["overlap_frac"] <= 1.0, ov
    events = [e for e in tel.recorder.events() if e["kind"] == "step"]
    assert len(events) == ov["pipelined_steps"]
    assert all(e["timings"]["pipelined"] and e["timings"]["overlap"] >= 0
               for e in events)
    tel2 = Telemetry()
    eng2 = _engine(OVERCOMMIT, telemetry=tel2)
    _submit_workload(eng2)
    eng2.run()
    for e in tel2.recorder.events():
        if e["kind"] == "step":
            assert set(e["timings"]) == {"schedule", "execute", "commit",
                                         "fenced"}


def test_pipelined_spans_follow_its_phases():
    """Pipelined step events carry the same runner spans under the
    pipelined phases: `scheduler.schedule`, `engine.launch` (the
    dispatch, `runner.execute` and the structural commit) and
    `engine.land` (the runner's sync and sample, the token commit), then
    `telemetry.read`; each event holds the spans closed since the one
    before, and every request's `request.wait` ends where the
    `runner.execute` of its first chunk starts."""
    runner = {"runner.swap", "runner.state", "runner.stage",
              "runner.replay", "runner.account", "runner.sync",
              "runner.sample"}
    children = {None: {"scheduler.schedule", "engine.launch", "engine.land",
                       "telemetry.read", "gc", "request.wait"},
                "engine.launch": {"runner.execute", "scheduler.commit"},
                "engine.land": {"runner.sync", "runner.sample",
                                "scheduler.commit"},
                "runner.execute": runner, "runner.stage": {"runner.sync"},
                "scheduler.commit": {"scheduler.sink"}}
    tel = Telemetry()
    eng = _engine(OVERCOMMIT, telemetry=tel)
    eng.scheduler.token_sink = lambda rid, tok: None
    ids = _submit_workload(eng)
    eng.run_pipelined()
    events = [e for e in tel.recorder.events() if e["kind"] == "step"]
    names, waits, last = set(), set(), -1.0
    for ev in events:
        rows = ev["spans"]
        for r in rows:
            parent = None if r[3] is None else rows[r[3]][0]
            assert r[0] in children[parent], (parent, r[0])
            if r[3] is not None:
                assert rows[r[3]][1] <= r[1] and r[2] <= rows[r[3]][2]
            if r[0] == "request.wait":
                waits.add(r[4])
                assert r[2] in [x[1] for x in rows
                                if x[0] == "runner.execute"]
            elif r[0] != "gc":
                assert r[1] > last     # closed since the previous event
        last = max(r[2] for r in rows if r[0] not in ("gc", "request.wait"))
        names |= {r[0] for r in rows}
        assert [r[0] for r in rows].count("engine.land") == 1
        assert set(ev["device_ms"]) == ({"prefill"} if ev["prefill"]
                                        else set()) | ({"decode"} if
                                                       ev["decode"] else set())
    assert {"scheduler.schedule", "engine.launch", "engine.land",
            "runner.execute", "runner.replay", "runner.sample",
            "scheduler.sink", "telemetry.read"} <= names
    assert waits == set(ids)


def test_sync_step_flushes_inflight_work():
    """Pipelined steps followed by sync `step()`s lose nothing: the
    in-flight step lands first and the tokens equal the pure-sync run."""
    ref_eng = _engine(OVERCOMMIT)
    _submit_workload(ref_eng)
    ref = ref_eng.run()
    eng = _engine(OVERCOMMIT)
    _submit_workload(eng)
    out = {}
    for _ in range(5):
        for fr in eng.step_pipelined():
            out[fr.request_id] = fr.tokens
    assert eng._inflight is not None
    out.update(eng.run())              # sync run() flushes and finishes
    assert set(out) == set(ref)
    for rid in ref:
        np.testing.assert_array_equal(out[rid], ref[rid])


def test_execute_async_hands_decode_logits_to_the_host_buffer():
    """The pending step holds the runner's host buffer, not the step's
    output: a later step cannot change what wait() samples."""
    eng = _engine(dict(paged=True, page_size=4))
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
    runner = eng.runner
    plan = eng.scheduler.schedule()
    pending = runner.execute_async(plan)
    assert pending.logits is runner._host_logits
    assert pending.logits.shape == (2, eng.cfg.padded_vocab)
    want = pending.logits[0, :eng.cfg.vocab_size].numpy().copy()
    runner._host_logits.zero_()      # what wait() reads is the buffer
    runner._host_logits[0, 7] = 1.0
    results = runner.wait(pending)
    assert pending.logits is None
    assert len(results[0]) == 2 and results[0][1] == 7 != want.argmax()


# ---------------------------------------------------------------------------
# the asyncio front end
# ---------------------------------------------------------------------------

def _serve_async(kw, device="cpu", model=None):
    """The workload through an AsyncEngine that drives a fresh engine from
    its first step; returns (request ids, streamed, callback and result
    tokens) and the AsyncEngine."""
    async def main():
        eng = _engine(kw, device, model, telemetry=Telemetry())
        aeng = AsyncEngine(eng)
        callback: dict[int, list[int]] = {}

        async def client(prompt, gen, sp):
            got: list[int] = []
            h = await aeng.submit(prompt, max_new_tokens=gen, sampling=sp,
                                  on_token=got.append)
            streamed = [t async for t in h]
            callback[h.request_id] = got
            return h.request_id, streamed, await h.result()

        runner = asyncio.ensure_future(aeng.run())
        outs = await asyncio.gather(*[client(*w) for w in _workload()])
        aeng.stop()
        await runner
        return outs, callback, aeng

    return asyncio.run(main())


def _check_async(kw, device="cpu", model=None):
    ref_eng = _engine(kw, device, model)
    ids = _submit_workload(ref_eng)
    ref = ref_eng.run()
    outs, callback, aeng = _serve_async(kw, device, model)
    assert [rid for rid, _, _ in outs] == ids
    for rid, streamed, result in outs:
        # streamed == callback == result == the sync run
        np.testing.assert_array_equal(np.asarray(streamed, np.int32), result)
        assert callback[rid] == streamed
        np.testing.assert_array_equal(result, ref[rid])
    assert len(aeng.finished_metrics) == len(ids)
    assert aeng.queue_delay_estimate() >= 0.0
    assert aeng.engine.runner.graph_count() == 2
    return aeng


def test_async_engine_streams_and_matches_sync():
    _check_async(OVERCOMMIT)


def test_async_engine_slo_admission_rejects():
    async def main():
        eng = _engine({}, telemetry=Telemetry())
        aeng = AsyncEngine(eng, slo_ttft_s=0.05)
        # no history: optimistic admission
        h = await aeng.submit(np.arange(1, 6, dtype=np.int32),
                              max_new_tokens=2)
        # a queue-time record far past the deadline: shed at the door
        aeng._queue_times.extend([0.4, 0.6])
        with pytest.raises(SLORejected):
            await aeng.submit(np.arange(1, 6, dtype=np.int32),
                              max_new_tokens=2)
        runner = asyncio.ensure_future(aeng.run())
        tokens = await h.result()
        aeng.stop()
        await runner
        return tokens, eng.stats["slo_rejected"]

    tokens, rejected = asyncio.run(main())
    assert tokens.size == 2
    assert rejected == 1


# ---------------------------------------------------------------------------
# the lockstep API, dump_trace and reset_stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_lockstep_prefill_decode_match_jax(paged):
    """Uniform prefill of every slot (two chunks), then two decode steps:
    logits allclose to the JAX Engine's lockstep API; lengths equal."""
    jcfg, tcfg = _cfgs()
    pj, _ = _params()
    kw = dict(max_len=24, batch_slots=2, binary=True, topn=6,
              prefill_chunk=8, paged=paged, page_size=8)
    jeng = JEngine(jcfg, pj, JServeConfig(**kw))
    teng = Engine(tcfg, _model(), ServeConfig(**kw), device="cpu")
    prompts = np.random.default_rng(12).integers(0, 256, (2, 13)) \
        .astype(np.int32)
    jl, tl = np.asarray(jeng.prefill(prompts)), teng.prefill(prompts)
    assert tl.shape == (2, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), jl, **LOGIT_TOL)
    for _ in range(2):
        tok = jl.argmax(-1).astype(np.int32)
        jl, tl = np.asarray(jeng.decode(tok)), teng.decode(tok)
        np.testing.assert_allclose(tl.numpy(), jl, **LOGIT_TOL)
    np.testing.assert_array_equal(teng.lengths, jeng.lengths)
    np.testing.assert_array_equal(teng.lengths, [15, 15])


def test_lockstep_logits_are_copies_and_reset_keeps_the_graphs():
    """Each lockstep call returns its own logits (the step's output is
    overwritten by the next step). A lockstep prefill after serving zeroes
    the caches in place and keeps both step kinds; it refuses to orphan
    queued requests."""
    eng = _engine(dict(paged=True, page_size=8))
    eng.submit(np.arange(1, 12, dtype=np.int32), max_new_tokens=3)
    eng.run()
    assert eng.runner.graph_count() == 2
    ptrs = [v.data_ptr() for c in eng.caches for v in c.values()]
    prompts = np.random.default_rng(3).integers(0, 256, (2, 9))
    first = eng.prefill(prompts)
    assert [v.data_ptr() for c in eng.caches for v in c.values()] == ptrs
    assert eng.runner.graph_count() == 2
    kept = first.clone()
    a = eng.decode(first.argmax(-1).numpy())
    a_kept = a.clone()
    b = eng.decode(a.argmax(-1).numpy())
    assert torch.equal(first, kept) and torch.equal(a, a_kept)
    assert not torch.equal(a, b)
    assert eng.runner.graph_count() == 2
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
    with pytest.raises(RuntimeError, match="queued"):
        eng.prefill(prompts)


def test_dump_trace_writes_jsonl_and_reset_stats_zeroes(tmp_path):
    path = tmp_path / "t.jsonl"
    tel = Telemetry(trace_file=str(path))
    eng = _engine(OVERCOMMIT, telemetry=tel)
    _submit_workload(eng)
    eng.run_pipelined()
    mets = eng.pop_finished_metrics()
    n = eng.dump_trace(requests=mets)
    events = load_trace(str(path))
    assert len(events) == n
    assert {e["kind"] for e in events} == {"meta", "step", "request",
                                           "check"}
    assert sum(e["kind"] == "request" for e in events) == 6
    assert all(e["ok"] for e in events if e["kind"] == "check")
    assert json.loads(path.read_text().splitlines()[0])["kind"] == "meta"
    assert eng.stats["decode_steps"] > 0 and eng._pipe["steps"] > 0
    eng.reset_stats()
    assert all(v == 0 for k, v in eng.stats.items()
               if isinstance(v, (int, float)) and k != "max_residents")
    assert eng.overlap_stats() == {"schedule_s": 0.0, "overlap_s": 0.0,
                                   "pipelined_steps": 0, "overlap_frac": 0.0}
    with pytest.raises(RuntimeError, match="telemetry"):
        _engine({}).dump_trace()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--swap-pages", "16", "--n-pages", "10", "--page-size", "8"],
    ["--async", "--stream", "--paged"],
    ["--trace-file", "TRACE", "--slo-ttft-ms", "5000", "--slo-itl-ms",
     "1000"],
    ["--fence", "--metrics", "--async"]],
    ids=["swap", "async-stream", "trace-slo", "fence-metrics"])
def test_launcher_serving_flags(flags, capsys, tmp_path):
    """Each flag serves the same tokens as the plain launcher and prints
    its summary: --swap-pages (implies --paged) swaps with nothing
    recomputed, --async --stream pipelines and streams every token,
    --trace-file writes the trace, --fence / --metrics time and render."""
    from repro_torch.launch import serve as launch
    trace = str(tmp_path / "trace.jsonl")
    flags = [trace if f == "TRACE" else f for f in flags]
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--prompt-len",
            "40", "--gen", "8", "--slots", "2", "--requests", "3",
            "--prefill-chunk", "16"]
    plain = launch.main(argv)
    capsys.readouterr()
    got = launch.main(argv + flags)
    text = capsys.readouterr().out
    assert {k: v.tolist() for k, v in got.items()} == \
        {k: v.tolist() for k, v in plain.items()}
    assert "step graphs: 2" in text
    if "--swap-pages" in flags:
        line = next(x for x in text.splitlines() if x.startswith("swap pool"))
        outs = int(line.split()[2])
        assert outs > 0 and " 0 recomputed" in line, line
    if "--async" in flags:
        assert "double-buffered steps" in text
    if "--stream" in flags:
        assert sum(x.startswith("  + req") for x in text.splitlines()) \
            == 3 * 8
    if "--trace-file" in flags:
        assert "SLO (TTFT<=5000ms, ITL<=1000ms)" in text
        assert f"trace events -> {trace}" in text
        events = load_trace(trace)
        assert {e["kind"] for e in events} >= {"meta", "step"}
        steps = [e for e in events if e["kind"] == "step"]
        assert all(e["device_ms"] for e in steps)
        names = {r[0] for e in steps for r in e["spans"]}
        assert {"engine.step", "runner.execute", "runner.replay",
                "request.wait", "telemetry.read"} <= names
    if "--fence" in flags:
        assert "latency (p50/p95/p99): queue" in text
        assert "# TYPE repro_serve_step_execute_seconds histogram" in text
        assert "repro_serve_step_overlap_seconds_count" in text


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("path", ["binary-dense", "binary-overcommit",
                                  "fp-overcommit"])
def test_pipelined_equals_sync_on_card(cuda, path):
    """Under CUDA graphs, with the decode logits copied to pinned memory
    while the host schedules the next plan: the same tokens as sync."""
    eng = _sync_vs_pipelined(PATHS[path], cuda, _model().to(cuda))
    assert eng.runner._host_logits.is_pinned()
    if PATHS[path].get("swap_pages"):
        assert eng.stats["swap_outs"] > 0


@pytest.mark.cuda
def test_async_engine_from_first_step_on_card(cuda):
    """The AsyncEngine drives a fresh engine, so both graph captures run
    in its worker thread while the loop thread serves the clients."""
    aeng = _check_async(OVERCOMMIT, cuda, _model().to(cuda))
    assert aeng.engine.stats["swap_outs"] > 0
