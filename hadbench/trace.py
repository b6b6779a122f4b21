"""The traced run: the flight recorder's step events, a `torch.profiler`
sub-window, and what the per-layer metric readers read from them.

`Tracer` steps the engine for the window (each step inside a
``hadbench.step`` range), keeps each step's per-slot lengths from before
it, and profiles the steps from `start_s` into the window for
`length_s` from the profiler's start (which itself takes time),
synchronizing the device at both ends. `Context` joins
the steps with their flight-recorder events and the profiler's kernels.
"""
from __future__ import annotations

import importlib.util
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
STEP_RANGE = "hadbench.step"


def warm_profiler() -> None:
    """Start the profiler (and its device tracing, CUPTI) once during
    set-up: its first start takes seconds, which would eat the traced
    window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    with profile(activities=acts):
        torch.ones(1, device="cuda" if cuda else "cpu").add_(1)
        if cuda:
            torch.cuda.synchronize()


class Tracer:
    def __init__(self, start_s: float, length_s: float):
        self.start_s, self.length_s = start_s, length_s
        self.prof = None
        self.done = False
        self.steps: list[dict] = []
        self.kernels: list[tuple[str, int, int]] = []
        self.ranges: list[tuple[int, int]] = []
        self.window_ns: tuple[int, int] | None = None

    def step(self, eng, t_rel: float, in_window: bool):
        import torch
        if self.prof is None and not self.done and in_window \
                and t_rel >= self.start_s:
            self._start()
        elif self.prof is not None and (
                not in_window
                or time.perf_counter() - self._t_start >= self.length_s):
            self._stop()
        lens = eng.scheduler.lengths
        with torch.profiler.record_function(STEP_RANGE):
            fin = eng.step()
        self.steps.append({"lens": lens, "profiled": self.prof is not None,
                           "in_window": in_window})
        return fin

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._w0 = time.time_ns()
        self._t_start = time.perf_counter()

    def _stop(self) -> None:
        import torch
        from torch.autograd import DeviceType
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        w1 = time.time_ns()
        self.prof.__exit__(None, None, None)
        self.window_ns = (self._w0, w1)
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                # the device-side mirror of a host range is no operation
                if e.duration_ns() > 0 and not e.is_user_annotation() \
                        and e.name() != STEP_RANGE:
                    self.kernels.append((e.name(), e.start_ns(),
                                         e.start_ns() + e.duration_ns()))
            elif e.name() == STEP_RANGE:
                self.ranges.append((e.start_ns(),
                                    e.start_ns() + e.duration_ns()))
        self.prof = None
        self.done = True

    def close(self) -> None:
        if self.prof is not None:
            self._stop()


def union(intervals) -> list[tuple[int, int]]:
    """Sorted, merged intervals."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(merged, a: int, b: int) -> int:
    """Length of [a, b) that the merged intervals cover."""
    return sum(max(0, min(b, y) - max(a, x)) for x, y in merged)


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = name.split("(")[0]
    if name.startswith("void "):
        name = name[5:]
    return name.split("<")[0][:120] or "(unnamed)"


def load(kind: str, name: str):
    """hadbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"hadbench.{kind}._{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The reader of per-layer metric `name`: ``metrics/<name>.py``, or,
    for a name with no file of its own (`k1_roofline.open`, the quantity
    reported for a family of cells), that of the name less its last
    dotted part, repeatedly."""
    while not (HERE / "metrics" / f"{name}.py").exists() and "." in name:
        name = name.rsplit(".", 1)[0]
    return load("metrics", name)


class Context:
    """What a per-layer metric reader reads: `steps` (the window's steps:
    kind, host timings in seconds, prefill chunks (lo, hi), the live
    decode rows' key counts, whether profiled), `port` and `shapes` of
    the cell, `n` (top-N), `module` (the cell's model module,
    ``hadbench.reference``), and, when the profiler ran,
    `kernel_s(names)`, `busy_ns`, `window_ns`, `step_ns` and
    `step_idle_ns`."""

    def __init__(self, tracer: Tracer, events: list[dict], port: dict,
                 shapes: dict, n: int, module):
        self.port, self.shapes, self.n = port, shapes, n
        self.module = module
        self.steps = []
        for st, ev in zip(tracer.steps, events):
            if not st["in_window"]:
                continue
            hi = {c["slot"]: c["hi"] for c in ev["prefill"]}
            chunks = [(c["lo"], c["hi"]) for c in ev["prefill"]]
            dec = [int(hi.get(s, st["lens"][s])) + 1 for s in ev["decode"]]
            kind = "prefill" if chunks else "decode" if dec else "idle"
            t = ev["timings"]
            self.steps.append({
                "kind": kind, "chunks": chunks, "decode_lens": dec,
                "profiled": st["profiled"], "schedule": t["schedule"],
                "execute": t["execute"], "commit": t["commit"],
                "ts": ev["ts"]})
        self.profiled = tracer.window_ns is not None
        self.kernels = tracer.kernels
        self.window_ns = tracer.window_ns
        self.busy = union((a, b) for _, a, b in tracer.kernels)
        self.busy_ns = sum(b - a for a, b in self.busy)
        ranges = union(tracer.ranges)
        self.step_ns = sum(b - a for a, b in ranges)
        self.step_idle_ns = sum((b - a) - covered(self.busy, a, b)
                                for a, b in ranges)

    def kernel_s(self, names) -> float:
        """Device seconds of the profiled kernels matching any of
        `names`."""
        return sum(b - a for k, a, b in self.kernels
                   if any(n in k for n in names)) / 1e9

    def breakdown(self) -> dict:
        """The profiled sub-window's ten costliest device operations and
        ten longest idle gaps, each gap named by the host phase (of the
        flight recorder's schedule / execute / commit) it fell in."""
        by: dict[str, int] = {}
        for k, a, b in self.kernels:
            by[short_name(k)] = by.get(short_name(k), 0) + (b - a)
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        w0, w1 = self.window_ns
        edges = [w0] + [x for ab in self.busy for x in ab] + [w1]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n, v / 1e9] for n, v in ops],
                "idle_gaps": [[self._phase((a + b) / 2e9), (b - a) / 1e9]
                              for a, b in gaps]}

    def _phase(self, t: float) -> str:
        for s in self.steps:
            c = s["ts"] - s["commit"]
            e = c - s["execute"]
            if e - s["schedule"] <= t < e:
                return f"schedule ({s['kind']} step)"
            if e <= t < c:
                return f"execute ({s['kind']} step)"
            if c <= t <= s["ts"]:
                return f"commit ({s['kind']} step)"
        return "between steps (traffic loop)"
