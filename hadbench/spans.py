"""The program's own spans and region times in a traced run, for the
readers in ``metrics/``.

A step event of the program's flight recorder (trace schema 2) carries
``spans``, rows ``[name, start, end, parent, request_id, detail]`` on
the hub's clock (the run's hub stamps `time.time`, the profiler's epoch
clock), `parent` the index of the enclosing span's row in the same list
and `detail` a ``runner.replay`` span's step kind, and ``device_ms``,
``{step kind: {region: ms}}`` of eager forwards on the CPU. On the card
the steps are graph replays: the hub's ``kernel_regions`` gives the
region of each device operation of a kind's graph in launch order, and
`labelled` labels the kernels of each profiled replay by position with
it.

`trace.Context` keeps each window step's timings and stamp, not its
event. A step dict holding its event under ``"event"`` is read as it is;
otherwise the event is found by its stamp (``ts``) in the flight recorder
of the live hub (`Telemetry`) that recorded the window: the run's hub
lives until its readers have read. Where no event carries spans (a
program that records none), every function here returns None, and so
does each reader: the metric is left out of the line.
"""
from __future__ import annotations

import bisect
import gc

UNNAMED = "(unnamed)"
# spans that name no host work of their own: the step itself, and a
# request's wait for its first chunk (time, not work)
NOT_WORK = ("engine.step", "request.wait")


def hub(ctx):
    """The live hub whose flight recorder holds every stamp of
    `ctx.steps`, or None. Found once a `Context`."""
    if "_span_hub" not in ctx.__dict__:
        from repro_torch.serve.telemetry import Telemetry
        want = {s["ts"] for s in ctx.steps}
        ctx._span_hub = None
        for obj in gc.get_objects():
            # type(): an object's __class__ may warn when read
            if issubclass(type(obj), Telemetry) and want <= {
                    e["ts"] for e in obj.recorder.events()
                    if e["kind"] == "step"}:
                ctx._span_hub = obj
                break
    return ctx._span_hub


def _recorded(ctx) -> list[dict] | None:
    """Each of `ctx.steps`' events, from the step dicts or from the live
    hub's flight recorder."""
    if all("event" in s for s in ctx.steps):
        return [s["event"] for s in ctx.steps]
    h = hub(ctx)
    if h is None:
        return None
    by_ts = {e["ts"]: e for e in h.recorder.events() if e["kind"] == "step"}
    return [by_ts[s["ts"]] for s in ctx.steps]


def events(ctx) -> dict[int, dict] | None:
    """id(step dict) -> its flight-recorder event, for every step of the
    window, or None when the events carry no spans. Found once a
    `Context`."""
    if "_span_events" not in ctx.__dict__:
        evs = _recorded(ctx) if ctx.steps else None
        ok = evs is not None and all("spans" in e for e in evs)
        ctx._span_events = ({id(s): e for s, e in zip(ctx.steps, evs)}
                            if ok else None)
    return ctx._span_events


def paired(ctx, steps) -> list[tuple[dict, dict]] | None:
    """(step, event) for each of `steps` (some of `ctx.steps`)."""
    evs = events(ctx)
    if evs is None:
        return None
    return [(s, evs[id(s)]) for s in steps]


def duration(row) -> float:
    return row[2] - row[1]


def descendants(rows, i: int) -> list[int]:
    """The indices of the rows under row `i` (a parent precedes its
    children)."""
    inside = {i}
    out = []
    for j in range(i + 1, len(rows)):
        if rows[j][3] in inside:
            inside.add(j)
            out.append(j)
    return out


def host_less_sync(rows, name: str) -> list[float]:
    """Seconds of each `name` span less its ``runner.sync`` spans (the
    host blocking on the card) at any depth under it."""
    out = []
    for i, r in enumerate(rows):
        if r[0] == name:
            out.append(duration(r) - sum(
                duration(rows[j]) for j in descendants(rows, i)
                if rows[j][0] == "runner.sync"))
    return out


def device_ms(ctx, steps, kind: str, regions) -> list[float] | None:
    """The summed ms of `regions` in each step's ``device_ms[kind]``,
    over the steps whose event has that kind."""
    pairs = paired(ctx, steps)
    if pairs is None:
        return None
    return [sum(ev["device_ms"][kind].get(r, 0.0) for r in regions)
            for _, ev in pairs if kind in ev["device_ms"]]


def op_key(name: str) -> str:
    """A device operation's name for matching a graph's replays to its
    eager run: a device-to-device copy is reported as a copy in one and
    may run as a copy kernel (``memcpy32_post``) in the other."""
    low = name.lower()
    if low.startswith("memcpy dtod") or low.startswith("memcpy32") \
            or low.startswith("memcpy64"):
        return "memcpy dtod"
    return name


def _runs(names: list[str], want: list[str]) -> list[int]:
    """The start of each run of `want` in `names`, in order (runs do not
    overlap)."""
    out, q, n = [], 0, len(want)
    while True:
        try:
            q = names.index(want[0], q)
        except ValueError:
            return out
        if names[q:q + n] == want:
            out.append(q)
            q += n
        else:
            q += 1


def graph_runs(ctx) -> dict[str, list[int]] | None:
    """{step kind: the index of each run of its graph's operations in the
    profile's kernels, sorted by start} (the hub's ``kernel_regions``,
    names as `op_key` has them; other operations in between). One stream
    runs every replay whole and in turn, so each run is one replay; no
    clock is read: the profiler's device stamps drift against the host's
    by milliseconds over the sub-window (``PERF.md``). None without
    kernels or the regions. Found once a `Context`."""
    if "_span_runs" in ctx.__dict__:
        return ctx._span_runs
    ctx._span_runs = None
    maps = getattr(hub(ctx), "kernel_regions", None)
    if not ctx.profiled or not ctx.kernels or not maps:
        return None
    kernels = sorted(ctx.kernels, key=lambda k: k[1])
    names = [op_key(k[0]) for k in kernels]
    ctx._span_kernels = kernels
    ctx._span_runs = {kind: _runs(names, [op_key(r[0]) for r in rows])
                      for kind, rows in maps.items()}
    return ctx._span_runs


def labelled(ctx, kind: str, regions) -> list[float] | None:
    """The summed device ms of `regions` in each profiled replay of
    `kind`'s graph, its kernels labelled by position (`graph_runs`).
    None without them."""
    runs = graph_runs(ctx)
    if runs is None:
        return None
    rows = hub(ctx).kernel_regions[kind]
    return [sum((b - a) / 1e6 for (_, a, b), (_, r) in zip(
        ctx._span_kernels[q:q + len(rows)], rows) if r in regions)
        for q in runs[kind]]


def region_ms(ctx, steps, kind: str, regions) -> list[float] | None:
    """The summed ms of `regions` a replay of `kind`'s graph: on the card,
    each of the profiled sub-window's replays (`labelled`); where the
    profile has no kernels (the CPU), the ``device_ms`` of `steps`."""
    if ctx.kernels:
        return labelled(ctx, kind, regions)
    return device_ms(ctx, steps, kind, regions)


class _Busy:
    """Coverage of [a, b) by the merged, sorted busy intervals, by
    bisection."""

    def __init__(self, merged):
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]
        self.cum = [0]
        for a, b in merged:
            self.cum.append(self.cum[-1] + b - a)

    def within(self, a: int, b: int) -> int:
        i = bisect.bisect_right(self.ends, a)
        j = bisect.bisect_left(self.starts, b)
        if i >= j:
            return 0
        return (self.cum[j] - self.cum[i] - max(0, a - self.starts[i])
                - max(0, self.ends[j - 1] - b))


def _depth(rows, i: int) -> int:
    if rows[i][0] == "gc":
        return 1 << 20          # a collection interrupts whatever runs
    d = 0
    while rows[i][3] is not None:
        i = rows[i][3]
        d += 1
    return d


def idle_by_span(ctx) -> dict[str, int] | None:
    """Nanoseconds of in-step device idle time (the profiled steps'
    ``hadbench.step`` ranges, `ctx.step_idle_ns`) by the innermost span
    that covers it, each span clipped to its step's ``engine.step``;
    `UNNAMED` holds the rest, which no span below ``engine.step`` (nor a
    ``gc`` span) covers. None without device kernels or spans."""
    if not ctx.profiled or not ctx.kernels:
        return None
    pairs = paired(ctx, [s for s in ctx.steps if s["profiled"]])
    if pairs is None:
        return None
    busy = _Busy(ctx.busy)
    by: dict[str, int] = {}
    for _, ev in pairs:
        rows = ev["spans"]
        step = [r for r in rows if r[0] == "engine.step"]
        if not step:
            continue
        lo, hi = round(step[0][1] * 1e9), round(step[0][2] * 1e9)
        spans = []
        for i, r in enumerate(rows):
            a, b = max(lo, round(r[1] * 1e9)), min(hi, round(r[2] * 1e9))
            if r[0] not in NOT_WORK and b > a:
                spans.append((a, b, _depth(rows, i), r[0]))
        edges = sorted({x for a, b, _, _ in spans for x in (a, b)})
        for p, q in zip(edges, edges[1:]):
            over = [(d, n) for a, b, d, n in spans if a <= p and q <= b]
            if over:
                name = max(over)[1]
                by[name] = by.get(name, 0) + (q - p) - busy.within(p, q)
    by[UNNAMED] = ctx.step_idle_ns - sum(by.values())
    return by
