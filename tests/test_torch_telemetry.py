"""The port's telemetry spans and region times (``serve/telemetry.py``).

A hub on the engine records spans at the serving path's layer boundaries
and hands them, with the step's region times (`device_ms`), to the step's
flight-recorder event: they nest as the module docstring lists them, a
request's `request.wait` shares its id with its first chunk's spans and
ends where that chunk's `runner.execute` starts, the regions follow the
model's layer kinds, and the hub changes no token (on the card, nor the
captured graphs). Without a hub nothing
is recorded and no `gc` callback is registered; a dropped hub leaves none
behind. Trace schema 2 round-trips. (Pipelined spans:
test_torch_pipelined.py.)
"""
import gc
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serve import Engine, ServeConfig, Telemetry
from repro_torch.serve import telemetry as TM

from test_torch_pipelined import (OVERCOMMIT, _engine,  # noqa: F401
                                  _submit_workload, cuda)

RUNNER = {"runner.swap", "runner.state", "runner.stage", "runner.replay",
          "runner.account", "runner.sync", "runner.sample"}
CHILDREN = {None: {"engine.step", "gc", "request.wait"},
            "engine.step": {"scheduler.schedule", "runner.execute",
                            "scheduler.commit", "telemetry.read"},
            "runner.execute": RUNNER,
            "runner.stage": {"runner.sync"},
            "scheduler.commit": {"scheduler.sink"}}


def _parent_name(rows, row):
    return None if row[3] is None else rows[row[3]][0]


def _check_nesting(rows, children):
    for row in rows:
        parent = _parent_name(rows, row)
        assert row[0] in children.get(parent, ()), (parent, row[0])
        assert row[1] <= row[2]
        if row[3] is not None:
            outer = rows[row[3]]
            assert outer[1] <= row[1] and row[2] <= outer[2], (outer, row)


def _served(hub, kw=OVERCOMMIT):
    eng = _engine(kw, telemetry=hub)
    got = {}
    eng.scheduler.token_sink = lambda rid, tok: got.setdefault(
        rid, []).append(int(tok))
    ids = _submit_workload(eng)
    return eng, ids, eng.run(), got


def test_spans_nest_as_listed_and_leaves_lie_in_their_step():
    hub = Telemetry()
    eng, _, _, _ = _served(hub)
    steps = [e for e in hub.recorder.events() if e["kind"] == "step"]
    assert steps
    names = set()
    for ev in steps:
        rows = ev["spans"]
        assert [len(r) for r in rows] == [len(TM.SPAN_FIELDS)] * len(rows)
        _check_nesting(rows, CHILDREN)
        top = [r for r in rows if r[0] == "engine.step"]
        assert len(top) == 1
        step = top[0]
        sched = [r for r in rows if r[0] == "scheduler.schedule"][0]
        t = ev["timings"]
        assert ev["ts"] <= step[2]
        assert t["schedule"] + t["execute"] + t["commit"] == \
            pytest.approx(ev["ts"] - sched[1], abs=1e-9)
        for r in rows:
            if r[0] not in CHILDREN[None]:
                assert step[1] <= r[1] and r[2] <= step[2], r
        names |= {r[0] for r in rows}
    # the overcommitted workload swaps, samples from chunks and streams
    assert RUNNER - {"runner.state"} <= names
    assert {"scheduler.sink", "request.wait", "telemetry.read"} <= names


def test_request_wait_carries_the_first_chunks_request_id():
    hub = Telemetry()
    eng, ids, _, _ = _served(hub)
    recs = {m.request_id: m for m in eng.pop_finished_metrics()}
    waits = {}
    for ev in hub.recorder.events():
        rows = ev["spans"]
        for r in rows:
            if r[0] != "request.wait":
                continue
            assert r[4] not in waits
            waits[r[4]] = r
            execute = [x for x in rows if x[0] == "runner.execute"]
            assert [x[1] for x in execute] == [r[2]]
            chunk = [x for x in rows if x[4] == r[4] and x[0] in RUNNER]
            assert {"runner.stage", "runner.replay"} <= {x[0] for x in chunk}
            assert all(_parent_name(rows, x) in ("runner.execute",
                                                 "runner.stage")
                       for x in chunk)
    assert set(waits) == set(ids) == set(recs)
    for rid, r in waits.items():
        assert (r[1], r[2]) == (recs[rid].submit_ts, recs[rid].first_chunk_ts)
        assert recs[rid].first_chunk_ts <= recs[rid].first_token_ts


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "dbrx-132b",
                                  "smollm-135m"])
def test_device_ms_regions_follow_the_layer_kinds(arch):
    cfg = get_config(arch, reduced=True)
    model = T.init_params(cfg, torch.Generator().manual_seed(0))
    hub = Telemetry()
    eng = Engine(cfg, model, ServeConfig(batch_slots=2, max_len=48,
                                         prefill_chunk=8, paged=True,
                                         page_size=4),
                 telemetry=hub, device="cpu")
    rng = np.random.default_rng(1)
    for n in (11, 5):
        eng.submit(rng.integers(1, 64, n).astype(np.int32), 3)
    eng.run()
    kinds = T.layer_kinds(cfg)
    want = {"embed", "head"} | {T.MIXER_REGIONS[k] for k in kinds}
    if cfg.d_ff > 0:
        want |= {"moe" if T.layer_uses_moe(cfg, i) else "mlp"
                 for i in range(len(kinds))}
    seen = set()
    for ev in hub.recorder.events():
        chunks, decode = ev["prefill"], ev["decode"]
        assert set(ev["device_ms"]) == ({"prefill"} if chunks else set()) \
            | ({"decode"} if decode else set())
        for kind, regions in ev["device_ms"].items():
            assert set(regions) == want, (kind, regions)
            assert all(v >= 0 for v in regions.values())
            seen.add(kind)
    assert seen == {"prefill", "decode"}
    assert ("moe" in want) == (cfg.n_experts > 0)


def test_telemetry_is_a_pure_observer():
    """The hub is a pure observer: the sampled workload (temperature 0.8,
    top-k 8) over the overcommitted pool gives the same tokens, streamed
    and returned, with and without one, and the same two step kinds."""
    eng_a, ids_a, out_a, sink_a = _served(None)
    eng_b, ids_b, out_b, sink_b = _served(Telemetry())
    assert ids_a == ids_b
    for rid in ids_a:
        np.testing.assert_array_equal(out_a[rid], out_b[rid])
    assert sink_a == sink_b
    assert eng_a.runner.graph_count() == eng_b.runner.graph_count() == 2
    assert dict(eng_a.stats) == dict(eng_b.stats)


def test_no_hub_records_nothing_and_watches_no_gc():
    gc.collect()
    before = list(gc.callbacks)
    eng, _, _, _ = _served(None)
    assert [cb for cb in gc.callbacks if cb not in before] == []
    assert eng.telemetry is None and eng.runner._regions == {}
    assert eng.runner.region_ms() == {}


def test_a_dropped_hub_leaves_no_gc_callback():
    gc.collect()
    before = len(gc.callbacks)
    hub = Telemetry()
    assert len(gc.callbacks) == before + 1
    gc.collect(1)
    rows = list(hub._gc_rows)
    assert rows and all(r[0] == "gc" and r[5] == 1 and r[1] <= r[2]
                        for r in rows)
    del hub
    assert len(gc.callbacks) == before
    # and through an engine, as the benchmark drops it
    eng, _, _, _ = _served(Telemetry())
    assert len(gc.callbacks) == before + 1
    del eng
    gc.collect()
    assert len(gc.callbacks) == before


def test_gc_spans_reach_the_next_step_event():
    hub = Telemetry(clock=time.time)
    eng = _engine(OVERCOMMIT, telemetry=hub)
    _submit_workload(eng)
    eng.step()
    gc.collect()
    eng.step()
    rows = hub.recorder.events()[-1]["spans"]
    full = [r for r in rows if r[0] == "gc" and r[5] == 2]
    assert full and all(r[3] is None for r in full)
    step = [r for r in rows if r[0] == "engine.step"][0]
    assert full[0][2] <= step[1]


def test_schema_v2_round_trips(tmp_path):
    assert TM.TRACE_SCHEMA_VERSION == 2
    assert {"spans", "device_ms"} <= set(TM.EVENT_SCHEMA["step"])
    hub = Telemetry(trace_file=str(tmp_path / "t.jsonl"))
    eng, _, _, _ = _served(hub)
    events = hub.recorder.events()
    for ev in events:
        assert TM.event_from_json(TM.event_to_json(ev)) == \
            json.loads(json.dumps(ev))
    n = eng.dump_trace(requests=eng.pop_finished_metrics())
    loaded = TM.load_trace(str(tmp_path / "t.jsonl"))
    assert len(loaded) == n and loaded[0]["schema"] == 2
    assert [e for e in loaded if e["kind"] == "step"] == \
        json.loads(json.dumps(events))
    old = {k: v for k, v in events[0].items() if k != "spans"}
    with pytest.raises(ValueError, match="spans"):
        TM.validate_event(old)


def test_lockstep_calls_leave_no_spans_pending():
    """The lockstep API records runner spans but writes no step event:
    each of its calls drops the spans and gc spans pending."""
    hub = Telemetry()
    eng = _engine({}, telemetry=hub)
    prompts = np.arange(1, 13, dtype=np.int32).reshape(2, 6)
    eng.prefill(prompts)
    assert hub._spans == [] and hub._top is None
    for _ in range(3):
        gc.collect()
        eng.decode(np.array([1, 2], np.int32))
        assert hub._spans == [] and not hub._gc_rows


def test_a_multi_chunk_step_blocks_only_to_sample():
    """Chunks that do not sample are queued back to back: inside
    `runner.execute` the host blocks (`runner.sync`, outside staging) once
    for each chunk that samples and once for the decode logits, no
    more."""
    hub = Telemetry()
    eng = _engine({}, telemetry=hub)
    rng = np.random.default_rng(3)
    for n in (27, 30):
        eng.submit(rng.integers(1, 64, n).astype(np.int32), 2)
    eng.run()
    multi = 0
    for ev in hub.recorder.events():
        rows = ev["spans"]
        syncs = [r for r in rows if r[0] == "runner.sync"
                 and _parent_name(rows, r) == "runner.execute"]
        sampling = sum(ch["samples"] for ch in ev["prefill"])
        assert len(syncs) <= sampling + bool(ev["decode"]), ev["step"]
        multi += sum(not ch["samples"] for ch in ev["prefill"]) >= 2
    assert multi


def _op(name):
    """A device operation's name, a device-to-device copy being reported
    as a copy or as the copy kernel it may run as inside a graph."""
    low = name.lower()
    return "memcpy dtod" if low.startswith(("memcpy dtod", "memcpy32",
                                            "memcpy64")) else name


def _first_diff(want, names):
    """Where the profile's best run of `want` first departs from it."""
    import difflib
    sm = difflib.SequenceMatcher(None, want, names, autojunk=False)
    return [(tag, want[i1:i2][:2], names[j1:j2][:2])
            for tag, i1, i2, j1, j2 in sm.get_opcodes()
            if tag != "equal" and j2 - j1 < len(want) // 2][:6]


@pytest.mark.cuda
def test_kernel_regions_label_the_unchanged_graphs_on_card(cuda):
    """On the card the hub gets, at capture, the region of each device
    operation of the two graphs. The graphs hold the same operations with
    and without a hub (no event nodes): in a profile of either engine
    serving the same requests, each replay runs the hub's map's
    operations in its order (a device-to-device copy of the eager run may
    run as a copy kernel in the graph), and the tokens equal."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config("dbrx-132b", reduced=True)
    model = T.init_params(cfg, torch.Generator().manual_seed(0))
    outs, profiles = [], []
    for hub in (None, Telemetry()):
        eng = Engine(cfg, model, ServeConfig(batch_slots=2, max_len=48,
                                             prefill_chunk=8, paged=True,
                                             page_size=4),
                     telemetry=hub, device=cuda)
        rng = np.random.default_rng(1)
        for n in (9, 13):                  # captures both graphs
            eng.submit(rng.integers(1, 64, n).astype(np.int32), 2)
        eng.run()
        assert eng.runner.graph_count() == 2
        ids = [eng.submit(rng.integers(1, 64, n).astype(np.int32), 4)
               for n in (11, 5, 19)]
        k0 = 0 if hub is None else hub.recorder.recorded
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = eng.run()
            torch.cuda.synchronize()
        outs.append([out[i].tolist() for i in ids])
        profiles.append([_op(e.name()) for e in sorted(
            prof.profiler.kineto_results.events(), key=lambda e: e.start_ns())
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation() and e.duration_ns() > 0])
    assert outs[0] == outs[1]
    maps = hub.kernel_regions
    assert set(maps) == {"prefill", "decode"}
    for kind, rows in maps.items():
        assert {r[1] for r in rows} == {"embed", "attn", "moe", "head"}
        want = [_op(r[0]) for r in rows]
        calls = sum(r[0] == "runner.replay" and r[5] == kind
                    for ev in hub.recorder.events()[k0:]
                    for r in ev["spans"])
        for names in profiles:
            hits = sum(names[i:i + len(want)] == want
                       for i in range(len(names)))
            assert hits == calls > 0, (kind, hits, calls, _first_diff(
                want, names))
