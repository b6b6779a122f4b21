"""Serving telemetry: metrics registry, request lifecycle, flight recorder.

Three layers, all host-side and jax-free (the Scheduler imports this
module, and the scheduler stays device-free):

  * :class:`MetricsRegistry` — the DECLARED schema of serving counters,
    gauges and log-bucketed histograms. It is dict-like on purpose: the
    scheduler/runner keep writing ``stats["decode_steps"] += 1`` exactly
    as before, but a key that was never declared raises ``KeyError``
    instead of silently minting a new counter (the failure mode of the
    old ``setdefault``-seeded plain dict). ``render()`` emits
    Prometheus text format; ``snapshot()`` a plain JSON-able dict.
  * :class:`RequestMetrics` — one per-request lifecycle record, created
    at ``submit()`` and finalized at finish: monotonic timestamps for
    submit/admit/first-chunk/first-token/finish, per-token ITL samples,
    and attribution counters (queue steps, prefill chunks, cached and
    replayed tokens, reclaims by kind, swap bytes, state restores).
    Finished records are drained via ``Engine.pop_finished_metrics()``.
  * :class:`FlightRecorder` — a bounded ring buffer of structured
    per-step events, one per executed :class:`SchedulePlan` (admissions,
    chunk assignment, decode set, reclaims with reasons, pool
    watermarks, and host-side schedule/execute/commit phase timings,
    optionally fenced with ``block_until_ready`` so host time is
    separable from device time). Dumpable as JSONL via
    ``Engine.dump_trace()`` — and automatically on invariant failure.

Spans and region times ride on the step events (schema version 2):

  * ``spans`` — every span closed since the previous step event, as
    compact rows ``[name, start, end, parent, request_id, detail]``
    (:data:`SPAN_FIELDS`) on the hub's clock; `parent` is the index of
    the enclosing span's row in the same list, or None; `detail` is a
    ``gc`` span's generation and a ``runner.replay`` span's step kind.
    A synchronous `Engine.step()` records, children indented::

        engine.step
          scheduler.schedule
          runner.execute
            runner.swap       swap-in scatters and swap-out gathers
            runner.state      state writes and copies outside the graphs
            runner.stage      host staging of a step's plan arrays
              runner.sync     its wait for the previous copy
            runner.replay     the graph replay (eager: the forward)
            runner.account    launch counts and decode-traffic counters
            runner.sync       every other host block on the card: a
                              chunk sample's copy, the decode logits,
                              swap-out bytes
            runner.sample     host token draws, chunk and decode
          scheduler.commit
            scheduler.sink    each `token_sink` call (the caller's code)
          telemetry.read      reading the step's region times

    `Engine.step_pipelined()` records the same runner spans under its
    own phases: ``scheduler.schedule``, ``engine.launch`` (runner.execute
    and the structural ``scheduler.commit``) and ``engine.land`` (the
    runner's sync and sample, the token ``scheduler.commit``), then
    ``telemetry.read``. Top-level spans besides: ``gc``, every
    interpreter collection while the hub lives, and ``request.wait``,
    from a request's `submit()` to the start of the ``runner.execute``
    span that runs its first prefill chunk (that chunk's spans carry the
    same request id). The lockstep API (`Engine.prefill` / `decode`)
    writes no step event: each of its calls drops the spans pending.
  * ``device_ms`` — ``{step kind: {region: ms}}`` for the step's eager
    forwards on the CPU, summed by region: ``embed``, each layer's mixer
    (``attn``, ``cross``, ``ssm``) and FFN (``mlp``, ``moe``), and
    ``head`` (last-row gather, final norm, unembedding), stamped on the
    host clock at the region boundaries. On the card the steps are
    captured graphs, which hold the step's kernels alone, with or
    without a hub: there the regions come as `Telemetry.kernel_regions`,
    the region of each device operation of a kind's graph in launch
    order (from a profiled eager run at capture), by which a profile of
    the replays is labelled position by position.

Everything hangs off one :class:`Telemetry` hub passed to the Engine;
``telemetry=None`` (the default) keeps every hook behind a single
``is not None`` check, so the disabled path costs nothing and the
1-prefill + 1-decode trace pin and all parity pins are untouched.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import time
import weakref
from typing import Any, Callable, Iterator, Mapping

# ---------------------------------------------------------------------------
# metric primitives
# ---------------------------------------------------------------------------

#: log-bucketed (powers of two) latency bounds, seconds: ~8us .. 64s.
TIME_BUCKETS = tuple(2.0 ** e for e in range(-17, 7))


class Counter:
    """Monotonic-by-convention scalar (reset_stats may zero it)."""
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: int | float = 0

    def inc(self, amount: int | float = 1) -> None:
        self.value += amount


class Gauge(Counter):
    """A scalar that goes up and down (watermarks, occupancy)."""
    kind = "gauge"

    def set(self, value: int | float) -> None:
        self.value = value


class Histogram:
    """Fixed-bound histogram (log-bucketed by default for latencies).

    ``bounds`` are ascending inclusive upper bounds; one implicit +Inf
    bucket catches the overflow. ``counts[i]`` is the NON-cumulative
    count of observations with ``value <= bounds[i]`` (and above
    ``bounds[i-1]``); Prometheus rendering cumulates on the fly.
    """
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 bounds: tuple = TIME_BUCKETS):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError(f"histogram bounds must be ascending: {bounds}")
        self.name = name
        self.help = help
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        lo, hi = 0, len(self.bounds)
        while lo < hi:                      # first bound >= value
            mid = (lo + hi) // 2
            if value <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.sum += value
        self.count += 1

    def snapshot(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0


# ---------------------------------------------------------------------------
# the registry: declared schema, dict-like counter access
# ---------------------------------------------------------------------------

#: The serving counter schema. Scheduler and ModelRunner both declare this
#: one shared set — the single source of truth that replaced the ad-hoc
#: ``stats.setdefault(key, 0)`` seeding in both modules (a typo'd key now
#: raises instead of silently creating a fresh counter).
SERVE_COUNTERS: dict[str, str] = {
    "decode_steps": "batched ragged decode steps executed",
    "prefill_chunks": "prefill chunks executed",
    "prefill_rows": "slot rows the prefill chunks carried, live or padding",
    "prefill_tokens": "prompt tokens actually prefilled (valid rows only)",
    "tokens_generated": "tokens sampled and committed across all requests",
    "preemptions": "residents evicted under pool pressure (swap or recompute)",
    "max_residents": "peak concurrently resident requests (watermark)",
    "cached_tokens": "prompt tokens served from the prefix cache",
    "swap_outs": "victims whose pages were gathered to the host swap pool",
    "swap_ins": "swapped requests restored to device pages",
    "swapped_tokens": "tokens restored from swap without re-prefill",
    "replayed_tokens": "tokens re-prefilled after recompute preemption",
    "swap_out_bytes": "bytes gathered device->host by swap-out evictions",
    "swap_in_bytes": "bytes scattered host->device by swap-in restores",
    "state_ckpts": "recurrent-state checkpoints registered at page boundaries",
    "state_restores": "warm admissions that restored a state checkpoint",
    "state_ckpt_bytes": "bytes copied capturing state checkpoints",
    "state_evictions": "state checkpoints evicted to free their entries",
    "state_misses": "prefix page matches cut short because no state "
                    "checkpoint survived at their end",
    "decode_pages_touched": "KV pages whose V was read by decode steps",
    "decode_hbm_bytes": "estimated decode K+V HBM traffic, bytes",
    "pipelined_steps": "double-buffered steps dispatched before the "
                       "previous step committed",
    "slo_rejected": "submissions refused by SLO-aware admission control",
}


class MetricsRegistry:
    """Declared metrics with dict-like access to the scalar ones.

    ``registry["decode_steps"] += 1`` works exactly like the legacy stats
    dict for every *declared* counter/gauge; an undeclared name raises
    ``KeyError`` on read and write alike. Histograms are declared and
    observed through their handle and are excluded from the dict view
    (so ``dict(registry)`` / ``reset`` loops over plain ints keep
    working), but participate in ``render()`` and ``snapshot()``.
    """

    def __init__(self):
        self._metrics: dict[str, Any] = {}

    # -- declaration ----------------------------------------------------
    def _declare(self, cls, name: str, help: str, **kw):
        metric = self._metrics.get(name)
        if metric is not None:
            if not isinstance(metric, cls):
                raise ValueError(
                    f"metric {name!r} already declared as {metric.kind}")
            return metric
        metric = cls(name, help, **kw)
        self._metrics[name] = metric
        return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._declare(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._declare(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  bounds: tuple = TIME_BUCKETS) -> Histogram:
        return self._declare(Histogram, name, help, bounds=bounds)

    def declare_counters(self, schema: Mapping[str, str]) -> None:
        for name, help in schema.items():
            self.counter(name, help)

    @classmethod
    def adopt(cls, stats) -> "MetricsRegistry":
        """Wrap legacy input: None -> fresh registry; an existing registry
        passes through (Scheduler and Runner share one); a plain mapping
        seeds same-named counters with its values."""
        if stats is None:
            return cls()
        if isinstance(stats, cls):
            return stats
        reg = cls()
        for key, value in stats.items():
            reg.counter(key).value = value
        return reg

    # -- dict-like scalar access ---------------------------------------
    def _scalar(self, name: str):
        metric = self._metrics.get(name)
        if metric is None or isinstance(metric, Histogram):
            declared = [k for k, m in self._metrics.items()
                        if not isinstance(m, Histogram)]
            raise KeyError(
                f"undeclared metric {name!r} — declare it in the schema "
                f"(known: {sorted(declared)})")
        return metric

    def __getitem__(self, name: str) -> int | float:
        return self._scalar(name).value

    def __setitem__(self, name: str, value: int | float) -> None:
        self._scalar(name).value = value

    def __contains__(self, name: str) -> bool:
        metric = self._metrics.get(name)
        return metric is not None and not isinstance(metric, Histogram)

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self.keys())

    def keys(self) -> list[str]:
        return [k for k, m in self._metrics.items()
                if not isinstance(m, Histogram)]

    def values(self) -> list:
        return [self._metrics[k].value for k in self.keys()]

    def items(self) -> list[tuple[str, Any]]:
        return [(k, self._metrics[k].value) for k in self.keys()]

    def get(self, name: str, default=None):
        return self[name] if name in self else default

    # -- maintenance / export ------------------------------------------
    def reset(self) -> None:
        """Zero every scalar and clear every histogram (warm-up reset)."""
        for metric in self._metrics.values():
            if isinstance(metric, Histogram):
                metric.reset()
            else:
                metric.value = 0

    def snapshot(self) -> dict:
        """Plain JSON-able dict of every metric's current state."""
        out: dict[str, Any] = {}
        for name, metric in self._metrics.items():
            out[name] = (metric.snapshot() if isinstance(metric, Histogram)
                         else metric.value)
        return out

    def render(self, namespace: str = "repro_serve") -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: list[str] = []
        for name, metric in self._metrics.items():
            full = f"{namespace}_{name}" if namespace else name
            if metric.help:
                lines.append(f"# HELP {full} {metric.help}")
            lines.append(f"# TYPE {full} {metric.kind}")
            if isinstance(metric, Histogram):
                cum = 0
                for bound, n in zip(metric.bounds, metric.counts):
                    cum += n
                    lines.append(f'{full}_bucket{{le="{bound:g}"}} {cum}')
                cum += metric.counts[-1]
                lines.append(f'{full}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{full}_sum {metric.sum:g}")
                lines.append(f"{full}_count {metric.count}")
            else:
                lines.append(f"{full} {metric.value:g}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# per-request lifecycle records
# ---------------------------------------------------------------------------

#: Reclaim kinds attributable to a request (matching Reclaim.kind):
#: "swap-out"/"recompute-preempt" count times the request itself was the
#: victim; "lru-evict" counts cached pages reclaimed on its behalf while
#: allocating ITS pages.
RECLAIM_KINDS = ("lru-evict", "swap-out", "recompute-preempt")


@dataclasses.dataclass
class RequestMetrics:
    """One request's full serving lifecycle (monotonic-clock seconds).

    Ordering invariant (tested): ``submit_ts <= admit_ts <=
    first_chunk_ts <= first_token_ts <= finish_ts`` for every field that
    was stamped (a fully prefix-cached admission may sample its first
    token from its only chunk, but the chunk still precedes the token).
    """
    request_id: int
    prompt_len: int
    submit_ts: float
    admit_ts: float | None = None          # first admission into a slot
    first_chunk_ts: float | None = None    # first prefill chunk executed
    first_token_ts: float | None = None
    finish_ts: float | None = None
    itl: list = dataclasses.field(default_factory=list)  # inter-token, s
    n_generated: int = 0
    queue_steps: int = 0       # scheduler steps spent waiting in the queue
    admissions: int = 0        # slot bindings (1 + one per re-admission)
    prefill_chunks: int = 0
    cached_tokens: int = 0     # prompt tokens served by the prefix cache
    replayed_tokens: int = 0   # tokens re-prefilled after recompute evict
    swapped_tokens: int = 0    # tokens restored from swap, no re-prefill
    preemptions: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in RECLAIM_KINDS})
    swap_out_bytes: int = 0
    swap_in_bytes: int = 0
    state_restores: int = 0

    # -- derived latencies ---------------------------------------------
    @property
    def queue_time(self) -> float | None:
        return None if self.admit_ts is None else self.admit_ts - self.submit_ts

    @property
    def ttft(self) -> float | None:
        return (None if self.first_token_ts is None
                else self.first_token_ts - self.submit_ts)

    @property
    def e2e(self) -> float | None:
        return None if self.finish_ts is None else self.finish_ts - self.submit_ts

    def to_event(self) -> dict:
        ev = {"kind": "request"}
        for f in dataclasses.fields(self):
            ev[f.name] = getattr(self, f.name)
        ev["itl"] = list(self.itl)
        ev["preemptions"] = dict(self.preemptions)
        return ev

    @classmethod
    def from_event(cls, ev: Mapping) -> "RequestMetrics":
        kw = {f.name: ev[f.name] for f in dataclasses.fields(cls)}
        return cls(**kw)


# ---------------------------------------------------------------------------
# flight-recorder event schema + JSONL serialization
# ---------------------------------------------------------------------------

TRACE_SCHEMA_VERSION = 2

#: the columns of a step event's span rows
SPAN_FIELDS = ("name", "start", "end", "parent", "request_id", "detail")

#: kind -> {field: allowed types}. Validation is strict on the top level:
#: unknown kinds and unknown or missing fields raise, so a producer typo
#: cannot silently emit unparseable traces.
_NUM = (int, float)
EVENT_SCHEMA: dict[str, dict[str, tuple]] = {
    "meta": {"schema": (int,), "ts": _NUM, "note": (str,)},
    "step": {"step": (int,), "ts": _NUM,
             "admissions": (list,),   # {slot,request_id,resume,cached_tokens,
                                      #  state_restore}
             "prefill": (list,),      # {slot,request_id,lo,hi,samples}
             "decode": (list,),       # slot ids
             "reclaims": (list,),     # {kind,slot,request_id,n_pages}
             "swap_ins": (list,),     # {slot,request_id,n_pages,length}
             "timings": (dict,),      # {schedule,execute,commit,fenced}
             "pool": (dict,),         # allocator/swap/state watermarks
             "spans": (list,),        # SPAN_FIELDS rows
             "device_ms": (dict,)},   # {kind: {region: ms}}
    "request": {f.name: object for f in dataclasses.fields(RequestMetrics)},
    "check": {"ts": _NUM, "ok": (bool,), "error": (str,)},
}
for _f in EVENT_SCHEMA["request"]:
    EVENT_SCHEMA["request"][_f] = (object,)


def validate_event(event: Mapping) -> None:
    """Raise ValueError unless `event` matches its kind's schema exactly
    (top-level fields; nested lists/dicts are free-form JSON)."""
    kind = event.get("kind")
    schema = EVENT_SCHEMA.get(kind)
    if schema is None:
        raise ValueError(f"unknown trace event kind {kind!r} "
                         f"(known: {sorted(EVENT_SCHEMA)})")
    fields = set(event) - {"kind"}
    missing, extra = set(schema) - fields, fields - set(schema)
    if missing or extra:
        raise ValueError(
            f"{kind} event fields mismatch: missing={sorted(missing)} "
            f"extra={sorted(extra)}")
    for name, types in schema.items():
        val = event[name]
        if object in types or val is None:
            continue
        if not isinstance(val, types) or isinstance(val, bool) != (
                bool in types):
            raise ValueError(
                f"{kind}.{name} has type {type(val).__name__}, "
                f"expected one of {[t.__name__ for t in types]}")


def event_to_json(event: Mapping) -> str:
    return json.dumps(event, sort_keys=True, separators=(",", ":"))


def event_from_json(line: str) -> dict:
    event = json.loads(line)
    validate_event(event)
    return event


def load_trace(path: str) -> list[dict]:
    """Parse + schema-validate a JSONL trace dump."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(event_from_json(line))
    return events


def slo_attainment(metrics, *, ttft_s: float | None = None,
                   itl_s: float | None = None) -> dict:
    """Goodput numerator over finished :class:`RequestMetrics`: how many
    requests met their latency deadlines — TTFT <= ttft_s AND every
    inter-token gap <= itl_s (a None deadline disables that leg). A
    request with no recorded first token counts as missed when a TTFT
    deadline is set. Returns {"total", "attained", "attainment"} with
    attainment in [0, 1]; goodput is attained / wall-clock at the call
    site."""
    total = attained = 0
    for m in metrics:
        total += 1
        ok = True
        if ttft_s is not None and (m.ttft is None or m.ttft > ttft_s):
            ok = False
        if ok and itl_s is not None and any(g > itl_s for g in m.itl):
            ok = False
        attained += ok
    return {"total": total, "attained": attained,
            "attainment": attained / max(total, 1)}


def _plan_rows(entries, fields) -> list[dict]:
    out = []
    for e in entries:
        row = {}
        for name, path in fields.items():
            val = e
            for part in path.split("."):
                val = getattr(val, part)
            row[name] = val if not hasattr(val, "item") else val.item()
        out.append(row)
    return out


def plan_event(plan, *, step: int, ts: float, timings: Mapping,
               pool: Mapping, spans: list | None = None,
               device_ms: Mapping | None = None) -> dict:
    """Build the per-step flight-recorder event from a frozen
    SchedulePlan. Duck-typed field access keeps this module import-free
    of the scheduler (which imports us); plain JSON values only."""
    return {
        "kind": "step", "step": int(step), "ts": float(ts),
        "admissions": _plan_rows(plan.admissions, {
            "slot": "slot", "request_id": "request.request_id",
            "resume": "resume", "cached_tokens": "cached_tokens",
            "state_restore": "state_restore"}),
        "prefill": [{"slot": ch.slot,
                     "request_id": ch.request.request_id,
                     "lo": ch.lo, "hi": ch.hi, "samples": ch.samples}
                    for ch in plan.prefill],
        "decode": [e.slot for e in plan.decode],
        "reclaims": [{"kind": rc.kind, "slot": rc.slot,
                      "request_id": rc.request_id,
                      "n_pages": len(rc.pages)}
                     for rc in plan.reclaims],
        "swap_ins": [{"slot": si.slot, "request_id": si.request_id,
                      "n_pages": len(si.pages), "length": si.length}
                     for si in plan.swap_ins],
        "timings": dict(timings),
        "pool": dict(pool),
        "spans": [] if spans is None else spans,
        "device_ms": {} if device_ms is None else dict(device_ms),
    }


class FlightRecorder:
    """Bounded ring buffer of schema-validated trace events."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self.recorded = 0
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, event: Mapping) -> None:
        validate_event(event)
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(dict(event))
        self.recorded += 1

    def events(self) -> list[dict]:
        return list(self._ring)

    def dump(self, path: str, *, extra_events=(), note: str = "",
             append: bool = True, clock: Callable[[], float] = time.monotonic
             ) -> int:
        """Write a meta header + the buffered events (+ extras) as JSONL.
        Returns the number of events written."""
        events = [{"kind": "meta", "schema": TRACE_SCHEMA_VERSION,
                   "ts": float(clock()), "note": note or
                   f"flight recorder dump ({self.recorded} recorded, "
                   f"{self.dropped} dropped)"}]
        events += self.events()
        events += [dict(e) for e in extra_events]
        with open(path, "a" if append else "w") as f:
            for ev in events:
                validate_event(ev)
                f.write(event_to_json(ev) + "\n")
        return len(events)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

#: what `span` returns without a hub
NO_SPAN = contextlib.nullcontext()


def span(telemetry: "Telemetry | None", name: str,
         request_id: int | None = None, detail=None):
    """``telemetry.span(name, request_id, detail)``, or a no-op context
    without a hub (the one test a hook pays on the disabled path)."""
    return NO_SPAN if telemetry is None else telemetry.span(
        name, request_id, detail)


class _Span:
    """One span as a context: opened on entry, closed on exit; the row is
    what ``with ... as row`` binds (``row[1]`` its start, ``row[2]`` its
    end once closed)."""
    __slots__ = ("hub", "name", "request_id", "detail", "row")

    def __init__(self, hub: "Telemetry", name: str, request_id, detail):
        self.hub, self.name = hub, name
        self.request_id, self.detail = request_id, detail

    def __enter__(self) -> list:
        self.row = self.hub._open_span(self.name, self.request_id,
                                       self.detail)
        return self.row

    def __exit__(self, *exc) -> bool:
        self.hub._close_span(self.row)
        return False


def _drop_gc_callback(callback) -> None:
    try:
        gc.callbacks.remove(callback)
    except ValueError:
        pass


def _watch_gc(hub: "Telemetry") -> None:
    """Record a ``gc`` span for every collection while `hub` lives: the
    callback holds it through a weak reference, and a finalizer takes the
    callback off ``gc.callbacks`` once the hub is dropped."""
    ref = weakref.ref(hub)

    def on_gc(phase: str, info: dict) -> None:
        h = ref()
        if h is None:
            return
        now = h.clock()
        if phase == "start":
            h._gc_start = now
        elif h._gc_start is not None:
            h._gc_rows.append(["gc", h._gc_start, now, None, None,
                               info.get("generation")])
            h._gc_start = None

    gc.callbacks.append(on_gc)
    weakref.finalize(hub, _drop_gc_callback, on_gc)


# ---------------------------------------------------------------------------
# the hub
# ---------------------------------------------------------------------------

class Telemetry:
    """Observability hub wired through Engine -> Scheduler/ModelRunner.

    Owns the metrics registry (shared with the scheduler's ``stats``),
    the live/finished :class:`RequestMetrics` tables, and the step
    flight recorder. Every scheduler/runner hook sits behind a single
    ``telemetry is not None`` check at the call site, so a disabled
    engine pays one pointer test per event at most.

    ``fence=True`` makes the Engine call ``runner.sync()`` (a
    ``block_until_ready`` over the cache pools) before stamping the
    execute->commit boundary, so the recorded execute time is device
    time, not dispatch time — the baseline an async double-buffered
    engine must beat. Off by default: fencing serializes the pipeline.

    Spans (`span`) are kept in memory, stamped with `clock`,
    and handed to the next step event `record_step` writes; from its
    creation until it is dropped the hub also records a ``gc`` span for
    each interpreter collection. `kernel_regions` (set by the runner at
    capture, on the card): ``{step kind: [[device op name, region],
    ...]}`` in the kind's graph's launch order.
    """

    def __init__(self, *, registry: MetricsRegistry | None = None,
                 trace_capacity: int = 256, trace_file: str | None = None,
                 fence: bool = False,
                 clock: Callable[[], float] = time.monotonic):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.recorder = FlightRecorder(trace_capacity)
        self.trace_file = trace_file
        self.fence = fence
        self.clock = clock
        self.step_idx = 0
        self._live: dict[int, RequestMetrics] = {}
        self._finished: list[RequestMetrics] = []
        self._last_token_ts: dict[int, float] = {}
        self._enqueue_step: dict[int, int] = {}
        h = self.registry.histogram
        self._h_queue = h("request_queue_seconds",
                          "submit -> first slot admission")
        self._h_ttft = h("request_ttft_seconds",
                         "submit -> first generated token")
        self._h_itl = h("request_itl_seconds", "inter-token latency")
        self._h_sched = h("step_schedule_seconds",
                          "host time planning one SchedulePlan")
        self._h_exec = h("step_execute_seconds",
                         "time executing one plan (device time iff fenced)")
        self._h_commit = h("step_commit_seconds",
                           "host time folding sampled tokens back")
        self._h_overlap = h("step_overlap_seconds",
                            "host schedule time hidden under the previous "
                            "step's device window (pipelined mode)")
        self._spans: list[list] = []      # rows awaiting a step event
        self._top: list | None = None     # the innermost open span
        self._gc_rows: collections.deque = collections.deque()
        self._gc_start: float | None = None
        self.kernel_regions: dict[str, list[list[str]]] = {}
        _watch_gc(self)

    # -- spans -----------------------------------------------------------
    def span(self, name: str, request_id: int | None = None,
             detail=None) -> _Span:
        """A context that records span `name` around its body, inside the
        innermost span open when it is entered."""
        return _Span(self, name, request_id, detail)

    def _open_span(self, name: str, request_id: int | None = None,
                   detail=None) -> list:
        row = [name, self.clock(), None, self._top, request_id, detail]
        self._spans.append(row)
        self._top = row
        return row

    def _close_span(self, row: list) -> None:
        row[2] = self.clock()
        self._top = row[3]

    def _add_span(self, name: str, start: float, end: float,
                 request_id: int | None = None) -> None:
        """A top-level span whose bounds were stamped already."""
        self._spans.append([name, start, end, None, request_id, None])

    def drop_spans(self) -> None:
        """Forget the closed spans and gc spans no step event has taken
        (the lockstep API, which writes none, calls this each step)."""
        self._spans = [r for r in self._spans if r[2] is None]
        self._gc_rows.clear()

    def _take_spans(self) -> list[list]:
        """The closed spans and gc spans since the last call, as event
        rows; a parent is its row's index, or None when it is not among
        them. Open spans wait for the next call."""
        closed = [r for r in self._spans if r[2] is not None]
        self._spans = [r for r in self._spans if r[2] is None]
        while self._gc_rows:
            closed.append(self._gc_rows.popleft())
        index = {id(r): i for i, r in enumerate(closed)}
        return [[r[0], r[1], r[2],
                 None if r[3] is None else index.get(id(r[3])), r[4], r[5]]
                for r in closed]

    # -- request lifecycle (scheduler side) -----------------------------
    def on_submit(self, request_id: int, prompt_len: int) -> None:
        self._live[request_id] = RequestMetrics(
            request_id=request_id, prompt_len=int(prompt_len),
            submit_ts=self.clock())
        self._enqueue_step[request_id] = self.step_idx

    def on_admit(self, request_id: int, resume: str, *,
                 cached_tokens: int = 0, replayed_tokens: int = 0) -> None:
        rec = self._live.get(request_id)
        if rec is None:
            return
        now = self.clock()
        if rec.admit_ts is None:
            rec.admit_ts = now
            self._h_queue.observe(now - rec.submit_ts)
        rec.admissions += 1
        rec.queue_steps += self.step_idx - self._enqueue_step.pop(
            request_id, self.step_idx)
        rec.cached_tokens += int(cached_tokens)
        rec.replayed_tokens += int(replayed_tokens)

    def on_requeue(self, request_id: int) -> None:
        """The request went back to the queue (preemption of any kind)."""
        self._enqueue_step[request_id] = self.step_idx

    def on_reclaim(self, request_id: int, kind: str) -> None:
        rec = self._live.get(request_id)
        if rec is not None:
            rec.preemptions[kind] = rec.preemptions.get(kind, 0) + 1

    def on_token(self, request_id: int) -> None:
        rec = self._live.get(request_id)
        if rec is None:
            return
        now = self.clock()
        if rec.first_token_ts is None:
            rec.first_token_ts = now
            self._h_ttft.observe(now - rec.submit_ts)
        else:
            itl = now - self._last_token_ts[request_id]
            rec.itl.append(itl)
            self._h_itl.observe(itl)
        self._last_token_ts[request_id] = now
        rec.n_generated += 1

    def on_swapped_tokens(self, request_id: int, n: int) -> None:
        rec = self._live.get(request_id)
        if rec is not None:
            rec.swapped_tokens += int(n)

    def on_state_restore(self, request_id: int) -> None:
        rec = self._live.get(request_id)
        if rec is not None:
            rec.state_restores += 1

    def on_finish(self, request_id: int) -> None:
        rec = self._live.pop(request_id, None)
        if rec is None:
            return
        rec.finish_ts = self.clock()
        self._last_token_ts.pop(request_id, None)
        self._enqueue_step.pop(request_id, None)
        self._finished.append(rec)

    # -- request lifecycle (runner side) --------------------------------
    def on_chunk(self, request_id: int, ts: float) -> None:
        """A prefill chunk of the request runs in the step whose
        ``runner.execute`` span starts at `ts`: its first chunk stamps
        `first_chunk_ts` there and records the ``request.wait`` span from
        `submit()`."""
        rec = self._live.get(request_id)
        if rec is None:
            return
        if rec.first_chunk_ts is None:
            rec.first_chunk_ts = ts
            self._add_span("request.wait", rec.submit_ts, ts, request_id)
        rec.prefill_chunks += 1

    def on_swap_bytes(self, request_id: int, *, out: int = 0,
                      in_: int = 0) -> None:
        rec = self._live.get(request_id)
        if rec is not None:
            rec.swap_out_bytes += int(out)
            rec.swap_in_bytes += int(in_)

    # -- draining --------------------------------------------------------
    def pop_finished(self) -> list[RequestMetrics]:
        out, self._finished = self._finished, []
        return out

    @property
    def live_requests(self) -> list[RequestMetrics]:
        return list(self._live.values())

    # -- flight recorder -------------------------------------------------
    def record_step(self, plan, *, timings: Mapping, pool: Mapping,
                    ts: float | None = None,
                    device_ms: Mapping | None = None) -> None:
        """Record the step event of `plan`, stamped `ts` (default now),
        with the spans closed since the previous event and the step's
        region times."""
        ev = plan_event(plan, step=self.step_idx,
                        ts=self.clock() if ts is None else ts,
                        timings=timings, pool=pool,
                        spans=self._take_spans(), device_ms=device_ms)
        self.recorder.record(ev)
        self._h_sched.observe(timings["schedule"])
        self._h_exec.observe(timings["execute"])
        self._h_commit.observe(timings["commit"])
        if "overlap" in timings:
            self._h_overlap.observe(timings["overlap"])
        self.step_idx += 1
