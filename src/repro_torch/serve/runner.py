"""Serving execution layer: the ModelRunner (torch twin of
``repro.serve.runner``).

The runner owns the model, the KV page pools, sampling and the host-side
contents of swapped-out pages, and nothing else. Each step it executes
exactly the frozen SchedulePlan the Scheduler handed it and returns the
per-slot sampled tokens; all bookkeeping driven by those tokens happens
back in `Scheduler.commit`.

Execution order within one plan (as in the JAX runner; the order that
makes page recycling safe):

  1. swap-in scatters: restore swapped requests' page contents (and, for
     models with SSM or cross layers, their pooled state entry) into
     their freshly allocated device pages and entry, in place;
  2. swap-out gathers: copy each victim's pages and state entry on the
     device, before any planned write can recycle them, and start their
     copy to pinned host memory;
  3. admission state restores: copy a prefix-matched checkpoint entry
     into the admission's live state entry;
  4. prefill chunks, in plan order: just before a request's first
     chunk's replay (a fresh or recompute admission: the chunk at
     position 0), its SSM state (dense row or state entry) is zeroed in
     place, and its image embeddings fill its cross caches, or, without
     an image, they are zeroed too (a refilled slot never inherits the
     previous occupant's state or image); each completed prompt's first
     token is sampled from the chunk's last-valid logits; a chunk with a
     planned `state_ckpt` is followed by a live-entry -> checkpoint-entry
     copy;
  5. one batched ragged decode over the plan's decode set (minus slots
     whose just-sampled first token hit eos).

Everything runs on the current stream, so stream order alone keeps the
swap gathers ahead of the step that recycles their pages. The swap
transfers, the state entry ops and the image fills are indexed copies
outside the captured graphs, so the two-graph pin holds.

`execute(plan)` is `wait(execute_async(plan))`. `execute_async` returns
once the step is enqueued: the decode logits are on their way to a pinned
host buffer, and `wait()` is the one host sync point, where they are
sampled and pending swap-out bytes land. A pipelined engine schedules the
next plan between the two.

Each step runs as a replay of one of at most two CUDA graphs per runner,
one for a prefill chunk and one for the decode step (the counterpart of
the JAX runner's one jit trace each): every plan array of a step sits in
one static device buffer, filled from a host staging buffer by one copy,
and the graph is captured at the kind's first use. A prefill chunk
carries its own slot's row only ([1, chunk] tokens, its block table row
and state entry; a dense engine's caches are read and written through
the `slot` input), so a chunk computes no dead rows; the decode step
carries every slot.
The graphs hold the addresses of the cache tensors, so every write
outside them (swap-in, `reset_caches`) is in place, never a rebinding.
`ModelRunner(eager=True)` runs the same step op by op instead, to compare
the two; nothing falls back to it.

Tensor-parallel serving (`ServeConfig.mesh`, a ``launch.mesh.HostMesh``
whose model axis is > 1; JAX ``_build_sharded_step``): every rank of the
model axis builds a runner over the same full model. Each keeps its shard
(``checkpoint.bridge.shard_model``: its heads of wq / wk / wv, its
vocabulary slice of the lm_head, the rest whole) and its kv heads of
every k_bits / k / v cache leaf, pools and cross caches alike (its own
trash page, position and entry); tables and plan arrays are the same on
every rank. The step gathers the attention context over heads before
wo, and the logits at the end (``distributed.collectives``), so every
rank holds the full logits, equal bit for bit to one device's. The mesh's
first rank is the one the engine drives: each call it gets from outside
(`execute_async`, the lockstep steps, `reset_caches`) is first sent to
the other ranks, plan and all, and they make it too (`serve_worker`,
until `close()`), so the plan stays the only channel from the scheduler
to execution. Every rank samples the same tokens from the same logits.
Swapped pages are gathered over the ranks' heads, so a stored blob is
the full logical page, byte-equal to one device's, and each rank
restores its heads from it. Counters stay logical. On the CPU the step
kinds still warm up on the static buffers (2 graphs counted, as JAX's
trace pin); on the card the gloo collectives cannot be captured in a
CUDA graph, so a tensor-parallel runner there runs eager (eager=True) or
raises.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.bridge import shard_model
from repro_torch.core import hamming
from repro_torch.distributed import collectives, sharding
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serve.paged import pages_needed
from repro_torch.serve.scheduler import SamplingParams, SchedulePlan, ServeConfig
from repro_torch.serve.telemetry import (SERVE_COUNTERS, MetricsRegistry,
                                         span)
from repro_torch.serve.validate import (STATE_LAYER_CHARS,
                                        mesh_model_size,
                                        resolve_state_pages,
                                        validate_serve_features,
                                        validate_serve_mesh)


def resolve_device(device) -> torch.device:
    """The device to serve or train on; "cuda" without a card raises (no
    fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: repro_torch runs on the GPU by "
            "default; pass device='cpu' (CLI: --device cpu) to run the "
            "kernels' plain versions on the CPU")
    return dev


def check_serve_supported(cfg: ModelConfig, scfg: ServeConfig) -> None:
    """Refuse an encoder (ValueError, the JAX launcher's reason: it has no
    decode loop), and a mesh whose model axis does not divide the kv
    heads (``validate_serve_mesh``)."""
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name} is encoder-only — no decode loop")
    validate_serve_mesh(cfg, scfg)


def _mirrored(fn):
    """A runner call the engine makes from outside: on the first rank of
    a tensor-parallel mesh it is sent to the other ranks before it runs
    (calls it makes itself are not sent again)."""
    @functools.wraps(fn)
    def call(self, *args, **kw):
        if self._send is None or self._sending:
            return fn(self, *args, **kw)
        self._sending = True
        try:
            self._send(fn.__name__, args, kw)
            return fn(self, *args, **kw)
        finally:
            self._sending = False
    return call


def _wire_plan(plan: SchedulePlan) -> SchedulePlan:
    """A plan as the other ranks need it: admissions and decode entries
    without their request (execution reads only their slots, entries,
    tokens and rngs); prefill chunks keep theirs, whose prompt tokens and
    `extra` arrays the chunk reads."""
    return dataclasses.replace(
        plan,
        admissions=tuple(dataclasses.replace(a, request=None)
                         for a in plan.admissions),
        decode=tuple(dataclasses.replace(e, request=None)
                     for e in plan.decode))


def _chunk_extra(extra: dict | None, s: int, lo: int, hi: int,
                 chunk: int) -> dict:
    """Route extra model inputs into the padded [lo, hi) prefill chunk
    (JAX ``_chunk_extra``, without its in-slot scatter: the runner passes
    a request's arrays with its slot instead).

    `image_embeds` fills the (static, persisted) cross cache: first chunk
    only. Sequence-aligned arrays (axis 1 == prompt length, e.g. `frames`)
    are sliced to the chunk and zero-padded to `chunk`. Anything else
    rides with the first chunk. Returns numpy arrays.
    """
    out: dict[str, Any] = {}
    for key, val in (extra or {}).items():
        arr = np.asarray(val)
        if key != "image_embeds" and arr.ndim >= 2 and arr.shape[1] == s:
            arr = arr[:, lo:hi]
            if hi - lo < chunk:
                widths = [(0, 0)] * arr.ndim
                widths[1] = (0, chunk - (hi - lo))
                arr = np.pad(arr, widths)
        elif lo != 0:
            continue
        out[key] = arr
    return out


def _sample_token(logits: np.ndarray, sp: SamplingParams, rng) -> int:
    if sp.temperature <= 0.0:
        return int(np.argmax(logits))
    l = logits.astype(np.float64) / sp.temperature
    if 0 < sp.top_k < l.size:
        # exactly top_k survive; ties at the k-th value break by lowest
        # index (a plain `l >= kth` keeps every tied logit, sampling from
        # outside the requested top-k). O(V) partition — no full-vocab
        # sort on the per-token host path.
        kth = np.partition(l, -sp.top_k)[-sp.top_k]
        above = l > kth
        ties = np.flatnonzero(l == kth)[:sp.top_k - int(above.sum())]
        masked = np.full_like(l, -np.inf)
        masked[above] = l[above]
        masked[ties] = kth
        l = masked
    l -= l.max()
    p = np.exp(l)
    p /= p.sum()
    return int(rng.choice(l.size, p=p))


@dataclasses.dataclass
class _PendingStep:
    """An `execute_async` dispatch awaiting its host sync: prefill-sampled
    tokens are final; the decode logits are being copied to the runner's
    host buffer, so the next replay may overwrite the graph's output."""
    results: dict[int, list[int]]
    entries: list                      # decode entries pending sampling
    # host decode logits [B, padded_vocab] (the runner's one buffer: wait()
    # before the next dispatch), or None; `ready` is the CUDA event that
    # completes when they have landed (None on the CPU, where they have)
    logits: torch.Tensor | None = None
    ready: Any = None


class _StepInputs:
    """The static inputs of one step kind: every plan array of the step
    (tokens [R, S], pos, active and n_valid [R], block tables [R, nb],
    state tables [R], a dense engine's `slot` [1]; R rows: every slot in
    a decode step, the chunk's one slot in a prefill chunk) in one int32
    device buffer, filled from one host staging buffer (pinned on the
    card) by one copy a step. The step reads views of the device buffer,
    so a captured graph sees each new plan at the same addresses."""

    def __init__(self, shapes: dict[str, tuple[int, ...]], device):
        sizes = [math.prod(shape) for shape in shapes.values()]
        cuda = device.type == "cuda"
        self.host = torch.zeros(sum(sizes), dtype=torch.int32,
                                pin_memory=cuda)
        self.dev = torch.zeros(sum(sizes), dtype=torch.int32, device=device)
        # recorded after each copy: the staging buffer may be rewritten
        # once the copy that reads it has run
        self._copied = torch.cuda.Event() if cuda else None
        self.host_views, self.views = {}, {}
        off = 0
        for (name, shape), size in zip(shapes.items(), sizes):
            self.host_views[name] = self.host[off:off + size].numpy() \
                .reshape(shape)
            self.views[name] = self.dev[off:off + size].view(shape)
            off += size

    def wait(self) -> None:
        """Block until the last copy has read the staging buffer: the
        host may rewrite it after this."""
        if self._copied is not None:
            self._copied.synchronize()

    def stage(self, **arrays) -> None:
        """Copy one step's plan arrays (numpy, by field name) to the
        device buffer, after `wait()`."""
        for name, arr in arrays.items():
            self.host_views[name][...] = arr
        self.dev.copy_(self.host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()

    def stage_null(self) -> None:
        """The null plan: every row inactive, n_valid 0, every table entry
        -1 (a dense engine's slot 0), so every cache write of a step lands
        in the trash page, position or entry."""
        self.wait()
        self.stage(**{name: -1 if name in ("tables", "state") else 0
                      for name in self.views})


#: the profiler range at each region boundary of `_kernel_regions`' run
REGION_MARK = "serve.region."


class _Regions:
    """The region times of one step kind's eager forwards on the CPU:
    serve_step's marker (`marks`: the step's start, then the end of the
    embedding, of each layer's mixer and FFN, and of the head), stamped
    on the host clock; `take` returns the region ms summed since its last
    call."""

    def __init__(self, clock):
        self.clock = clock
        self.sums: dict[str, float] = {}
        self._last = 0.0

    def __call__(self, name: str) -> None:
        """serve_step's marker: `name` is the region that ends here."""
        now = self.clock()
        if name != "start":
            self.sums[name] = self.sums.get(name, 0.0) \
                + 1e3 * (now - self._last)
        self._last = now

    def take(self) -> dict[str, float]:
        out, self.sums = self.sums, {}
        return out


@dataclasses.dataclass
class _Graph:
    """A step kind's captured graph: its static logits output, and the
    kernel launches (by kernel name) that one replay makes. On the CPU,
    which has no graphs, `graph` is None and the step runs eagerly on the
    static buffers."""
    graph: Any
    logits: torch.Tensor | None
    launches: dict[str, int]


class ModelRunner:
    """Device-state owner and plan executor for one serving engine."""

    def __init__(self, cfg: ModelConfig, model: T.Transformer,
                 scfg: ServeConfig, stats: dict, *, device="cuda",
                 eager: bool = False):
        """eager=True runs every step op by op on the static buffers,
        capturing no graph: the comparison that pins graphs == eager.
        `model` is the full model, also under a mesh (each rank cuts its
        own shard)."""
        self.device = resolve_device(device)
        self.eager = eager
        validate_serve_features(cfg.layer_pattern, scfg)
        check_serve_supported(cfg, scfg)
        self.mesh = scfg.mesh
        self._tp = mesh_model_size(scfg)
        self.group = self.mesh.group if self._tp > 1 else None
        if self._tp > 1 and self.device.type == "cuda" and not eager:
            raise ValueError(
                "tensor-parallel serving on the card runs the eager step "
                "(eager=True): gloo's collectives cannot be captured in a "
                "CUDA graph, and capturing over NCCL waits for a machine "
                "with one card per rank (ROADMAP.md item 2a)")
        self.cfg = cfg
        if self._tp > 1:
            model = shard_model(model, self.mesh)
        self.model = model.to(self.device)
        local = self.model.cfg          # this rank's heads; cfg under no mesh
        # on the mesh's first rank: send each outside call to the others
        self._send = None
        self._sending = False
        if self._tp > 1 and self.mesh.model_rank == 0:
            self._send = self._broadcast_call
        self.scfg = scfg
        self.stats = MetricsRegistry.adopt(stats)
        self.stats.declare_counters(SERVE_COUNTERS)
        self.telemetry = None
        # the request whose prefill chunk is running, for its spans
        self._rid: int | None = None
        # CPU region times by step kind, made while a hub is attached
        self._regions: dict[str, _Regions] = {}
        self.n = scfg.topn if scfg.topn is not None else cfg.had.topn(scfg.max_len)
        self.chunk = max(1, min(scfg.prefill_chunk, scfg.max_len))
        self.page = scfg.page_size
        self.n_pages = 0
        kinds = T.layer_kinds(cfg)
        # layers whose caches are page pools (swapped page by page), and
        # the SSM and cross layers, whose per-slot state is a pooled state
        # allocation in a paged engine (JAX `_state_positions`; swapped,
        # checkpointed and restored entry by entry)
        self._pool_layers = ([i for i, k in enumerate(kinds) if k == "A"]
                             if scfg.paged else [])
        self._cross_layers = [i for i, k in enumerate(kinds) if k == "C"]
        self._ssm_layers = [i for i, k in enumerate(kinds) if k == "M"]
        self._state_layers = ([i for i, k in enumerate(kinds)
                               if k in STATE_LAYER_CHARS]
                              if scfg.paged else [])
        self.n_state_pages = (resolve_state_pages(scfg)
                              if self._state_layers else 0)
        if scfg.paged:
            self.n_pages = (scfg.n_pages if scfg.n_pages is not None
                            else scfg.batch_slots
                            * pages_needed(scfg.max_len, self.page))
            # decode HBM traffic model (host-side, per attention layer x
            # kv-head): bytes of one page of packed K bit-planes and of V
            # (packed bit-planes on the binary path, fp otherwise)
            elem = torch.empty((), dtype=cfg.dtype).element_size()
            self._page_v_bytes = self.page * cfg.dh * elem
            self._page_k_bytes = (hamming.packed_words(cfg.dh) * 4 * self.page
                                  if scfg.binary else self._page_v_bytes)
            self._attn_rows = kinds.count("A") * cfg.n_kv_heads
        self.caches = T.init_caches(
            local, paged=scfg.paged, batch=scfg.batch_slots,
            max_len=scfg.max_len, n_pages=self.n_pages, page_size=self.page,
            binary=scfg.binary, state_pages=self.n_state_pages or None,
            device=self.device)
        b = scfg.batch_slots
        nb = pages_needed(scfg.max_len, self.page)

        def tables(rows: int) -> dict:
            out = {"tables": (rows, nb)} if scfg.paged else {}
            if self._state_layers:
                out["state"] = (rows,)
            return out

        # a prefill chunk carries its slot's row only: its block table row
        # and state entry address the pools; a dense cache's row is
        # addressed by the `slot` input
        slot = {} if scfg.paged else {"slot": (1,)}
        # a model with a frontend embeds `frames` prefill chunks through
        # it: the chunk's frames land in this static buffer, and the
        # prefill input's `frames` flag picks them over the tokens
        self._frames = (torch.zeros((1, self.chunk, cfg.frontend_dim),
                                    dtype=cfg.dtype, device=self.device)
                        if cfg.frontend_dim else None)
        frames = {"frames": (1,)} if cfg.frontend_dim else {}
        self._inputs = {
            "prefill": _StepInputs(dict(tokens=(1, self.chunk), pos=(1,),
                                        active=(1,), n_valid=(1,),
                                        **tables(1), **slot, **frames),
                                   self.device),
            "decode": _StepInputs(dict(tokens=(b, 1), pos=(b,), active=(b,),
                                       **tables(b)), self.device)}
        self._graphs: dict[str, _Graph] = {}
        self._pool = None               # the graphs' shared memory pool
        cuda = self.device.type == "cuda"
        # decode logits land here, by a non-blocking copy on the card
        self._host_logits = torch.empty((b, cfg.padded_vocab),
                                        dtype=torch.float32, pin_memory=cuda)
        # swapped-out contents, request_id -> one {leaf name -> [k_pages,
        # ...] host tensor (pinned on the card)} per page-pool layer, then,
        # when the victim held a state entry, one {leaf name -> [1, ...]}
        # per state layer (accounting lives in the scheduler's SwapPool;
        # this is the data half)
        self._swap_store: dict[int, list[dict[str, torch.Tensor]]] = {}
        # recorded after the last swap-out's copies to the host; waited on
        # at wait() / sync()
        self._swaps_landed = None

    def cache_device_bytes(self) -> tuple[int, int]:
        """(logical total, per rank) bytes of every layer's cache; equal on
        one device. Under a mesh a head-sharded leaf (k_bits / k / v)
        counts tp times its shard in the total, a replicated one (SSM
        state) once, so per rank x tp == total when every leaf is
        head-sharded. Unlike the JAX runner's count, which holds the
        self-attention caches only, it counts the cross caches and the SSM
        state (dense, or the state pool) too. The port's pools and dense
        caches each hold one trash page, position or entry per leaf beyond
        the JAX package's, where dropped writes land, and they are
        counted."""
        total = per = 0
        for cache in self.caches:
            for name, leaf in cache.items():
                nbytes = leaf.numel() * leaf.element_size()
                per += nbytes
                total += nbytes * (self._tp if self._head_sharded(name)
                                   else 1)
        return total, per

    def _head_sharded(self, name: str) -> bool:
        """Whether cache leaf `name` holds this rank's kv heads only."""
        return self._tp > 1 and name in sharding.POOL_HEAD_LEAVES

    # ------------------------------------------------------------------
    # tensor parallelism: the first rank sends, the others follow
    # ------------------------------------------------------------------
    def _broadcast_call(self, op: str, args: tuple, kw: dict) -> None:
        if op == "execute_async":
            args = (_wire_plan(args[0]),) + tuple(args[1:])
        collectives.broadcast_object((op, args, kw), self.mesh.ctrl,
                                     self.mesh.ranks[0])

    def serve_worker(self) -> int:
        """On a rank other than the mesh's first: make every call the
        first rank's runner sends (a plan's `execute_async` as a whole
        `execute`), until its `close()`. Returns the calls made."""
        if self._tp <= 1 or self.mesh.model_rank == 0:
            raise RuntimeError("serve_worker runs on the mesh's other "
                               "ranks; its first rank drives the engine")
        calls = 0
        while True:
            op, args, kw = collectives.broadcast_object(
                None, self.mesh.ctrl, self.mesh.ranks[0])
            if op == "close":
                return calls
            getattr(self, "execute" if op == "execute_async" else op)(
                *args, **kw)
            calls += 1

    def close(self) -> None:
        """On the mesh's first rank: release the other ranks from
        `serve_worker`. A no-op without a mesh."""
        if self._send is not None:
            self._send("close", (), {})
            self._send = None

    @_mirrored
    def reset_caches(self) -> None:
        """Zero every cache leaf in place, trash page or position included
        (the lockstep prefill contract), and drop swapped page contents:
        the pages they would restore into no longer exist. The tensors
        stay the ones the captured graphs read, so the graphs are kept."""
        for cache in self.caches:
            for leaf in cache.values():
                leaf.zero_()
        self._swap_store.clear()
        self._swaps_landed = None

    def sync(self) -> None:
        """Block until every queued device write has landed, pending
        swap-out bytes included (the fence behind
        `Telemetry(fence=True)`)."""
        self._finalize_swaps()
        if self.device.type == "cuda":
            with span(self.telemetry, "runner.sync", self._rid):
                torch.cuda.synchronize(self.device)

    def region_ms(self) -> dict[str, dict[str, float]]:
        """Host ms by serve_step region of each step kind's eager
        forwards on the CPU since the last call, while a hub is attached
        (no entry for a kind that did not run; none on the card, whose
        regions are the hub's `kernel_regions`)."""
        out = {}
        for kind, regions in self._regions.items():
            ms = regions.take()
            if ms:
                out[kind] = ms
        return out

    # ------------------------------------------------------------------
    # the step: static buffers, one graph per kind
    # ------------------------------------------------------------------
    def graph_count(self) -> int:
        """Step graphs captured so far: at most 2 (the one-row prefill
        chunk and the decode step), whatever the prompt lengths. On the CPU,
        which has no graphs, the step kinds warmed up on the static
        buffers; 0 with eager=True."""
        return len(self._graphs)

    def _forward(self, kind: str, marks=None) -> torch.Tensor:
        """serve_step on the static inputs of `kind`, calling `marks` at
        its region boundaries; logits [R, 1, V] (R rows: 1 in a prefill
        chunk)."""
        v = self._inputs[kind].views
        frames = "frames" in v
        return T.serve_step(
            self.model, v["tokens"], self.caches, pos=v["pos"], n=self.n,
            block_tables=v.get("tables"), active=v["active"] != 0,
            n_valid=v.get("n_valid"),
            page_topn=self.scfg.page_topn if kind == "decode" else None,
            binary=self.scfg.binary, state_tables=v.get("state"),
            zero_fresh=False, logits_mode="last",
            frames=self._frames if frames else None,
            frames_rows=v["frames"] != 0 if frames else None,
            slots=v.get("slot"), group=self.group, marks=marks)

    def _marks(self, kind: str) -> _Regions | None:
        """The region times of `kind`'s eager forwards on the CPU while a
        hub is attached."""
        if self.telemetry is None or self.device.type != "cpu":
            return None
        if kind not in self._regions:
            self._regions[kind] = _Regions(self.telemetry.clock)
        return self._regions[kind]

    def _kernel_regions(self, kind: str) -> list[list[str]] | None:
        """[device op name, region] for each device operation that one
        eager forward of `kind` launches, in launch order (the graph's
        order): the profiler keeps a host range (`REGION_MARK` + region)
        at each region boundary, and an operation belongs to the region
        of the first boundary after its launch call. None when a profiler
        is running already (they do not nest)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function

        def mark(name: str) -> None:
            with record_function(REGION_MARK + name):
                pass

        if torch.autograd._profiler_enabled():
            return None
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            self._forward(kind, mark)
            torch.cuda.synchronize(self.device)
        bounds, launch, device = [], {}, []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation() and e.duration_ns() > 0:
                    device.append(e)
            elif name.startswith(REGION_MARK):
                bounds.append((e.start_ns(), name[len(REGION_MARK):]))
            elif name.startswith("cu"):      # a runtime or driver call
                launch[e.correlation_id()] = e.start_ns()
        bounds.sort()
        at = [t for t, _ in bounds]
        out = []
        for e in sorted(device, key=lambda e: e.start_ns()):
            t = launch.get(e.correlation_id())
            if t is None:         # its call unrecorded: its predecessor's
                region = out[-1][1] if out else bounds[1][1]
            else:
                k = min(bisect.bisect_right(at, t), len(bounds) - 1)
                region = bounds[max(k, 1)][1]
            out.append([e.name(), region])
        return out

    def _capture(self, kind: str) -> _Graph:
        """A kind's first use: one warm-up run (on a side stream, as
        capture requires), then the capture, both on the null plan so that
        pages [0, n_pages) and positions [0, max_len) stay untouched. Their
        kernel launches are not counted; each replay adds the capture's.
        With a hub attached, a second, profiled warm-up run gives the
        hub the region of each of the graph's device operations
        (`_kernel_regions`); the graph itself is the same with or without
        a hub. On the CPU only the warm-up runs. A failure raises."""
        inp = self._inputs[kind]
        inp.stage_null()
        counts = ops.launch_counts(splits=True)
        if self.device.type != "cuda":
            self._forward(kind)
            return _Graph(None, None, {})
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._forward(kind)
            if self.telemetry is not None:
                regions = self._kernel_regions(kind)
                if regions is not None:
                    self.telemetry.kernel_regions[kind] = regions
        stream.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts(splits=True)
        with torch.cuda.graph(graph, pool=self._pool):
            logits = self._forward(kind)
        after = ops.launch_counts(splits=True)
        ops.reset_launch_counts(counts)
        return _Graph(graph, logits,
                      {k: after[k] - before[k] for k in after})

    def _step(self, kind: str, **arrays) -> torch.Tensor:
        """Stage one step's plan arrays and run it: a replay of the kind's
        graph (captured at first use), or serve_step itself when eager or
        on the CPU. Returns logits [R, 1, V]."""
        if not self.eager and kind not in self._graphs:
            self._graphs[kind] = self._capture(kind)
        inp, tel, rid = self._inputs[kind], self.telemetry, self._rid
        with span(tel, "runner.stage", rid):
            with span(tel, "runner.sync", rid):
                inp.wait()
            inp.stage(**arrays)
        g = self._graphs.get(kind)
        if g is None or g.graph is None:
            with span(tel, "runner.replay", rid, kind):
                return self._forward(kind, self._marks(kind))
        with span(tel, "runner.replay", rid, kind):
            g.graph.replay()
        with span(tel, "runner.account", rid):
            ops.add_launch_counts(g.launches)
        return g.logits

    # ------------------------------------------------------------------
    # low-level steps
    # ------------------------------------------------------------------
    def _tables(self, block_tables, state_tables) -> dict:
        """A step's table arrays, by static input name."""
        out = {} if block_tables is None else {"tables": block_tables}
        if self._state_layers:
            out["state"] = (np.full(self.scfg.batch_slots, -1, np.int32)
                            if state_tables is None else state_tables)
        return out

    def _write_state(self, emb, slot: int, pos: int, entry: int) -> None:
        """Write the state a prefill chunk of `slot` reads, in place and
        outside the step graph (the graph zeroes none of it): a chunk that
        starts a request (pos 0) has its SSM state zeroed, and its cross
        caches too, unless image embeddings (`emb` [1, T_img,
        frontend_dim], or None) fill them. So a refilled slot never reads
        the previous occupant's state or image (JAX zeroes a fresh
        admission's entry, and a fresh dense row inside its step). The
        slot's state is its dense row, or its pooled `entry` (-1 when it
        holds none: nothing is written)."""
        pooled = bool(self._state_layers)
        idx = entry if pooled else slot
        filled = emb is not None and bool(self._cross_layers)
        if filled:
            dev = self.device
            T.fill_cross_caches(
                self.model, self.caches, torch.from_numpy(
                    np.asarray(emb)).to(dev),
                torch.tensor([idx], dtype=torch.int64, device=dev),
                torch.tensor([idx >= 0], device=dev), pooled=pooled,
                binary=self.scfg.binary)
        if pos != 0 or idx < 0:
            return
        layers = self._ssm_layers + ([] if filled else self._cross_layers)
        if layers:
            self._state_zero(np.array([idx]), layers)

    @_mirrored
    def prefill_step(self, slot: int, tokens: np.ndarray, pos: int,
                     table: np.ndarray | None = None, entry: int = -1,
                     extra: dict | None = None) -> torch.Tensor:
        """One prefill chunk of one slot: its tokens ([n_valid], n_valid
        <= chunk; zero-padded to the chunk) at cache position `pos`, the
        slot's block table row ([nb], a paged engine) and its state entry
        (a pooled-state engine; -1: none), and the chunk's extra inputs
        (`_chunk_extra`, one row). Before the replay a fresh slot's SSM
        state is zeroed, and image embeddings fill its cross caches, or
        they are zeroed (`_write_state`). `frames` ([1, chunk,
        frontend_dim]) go to the static frames buffer, and the chunk is
        embedded through ``frontend_proj`` instead of the token table.
        Returns last-valid logits [1, 1, V], valid until the next step."""
        extra = extra or {}
        nv = len(tokens)
        row = np.zeros((1, self.chunk), np.int32)
        row[0, :nv] = tokens
        arrays = dict(tokens=row, pos=[pos], active=[1], n_valid=[nv])
        if self.scfg.paged:
            arrays["tables"] = table[None]
        else:
            arrays["slot"] = [slot]
        if self._state_layers:
            arrays["state"] = [entry]
        if self._frames is not None:
            if "frames" in extra:
                self._frames.copy_(torch.from_numpy(
                    np.asarray(extra["frames"], np.float32)))
            arrays["frames"] = [int("frames" in extra)]
        elif "frames" in extra:
            raise ValueError(f"{self.cfg.name} has no frontend "
                             f"(frontend_dim 0) to embed frames")
        if self._ssm_layers or self._cross_layers:  # else images are ignored
            with span(self.telemetry, "runner.state", self._rid):
                self._write_state(extra.get("image_embeds"), slot, pos,
                                  entry)
        logits = self._step("prefill", **arrays)
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_rows"] += row.shape[0]
        self.stats["prefill_tokens"] += nv
        return logits

    @_mirrored
    def decode_step(self, tokens: np.ndarray, pos: np.ndarray,
                    active: np.ndarray,
                    block_tables: np.ndarray | None,
                    state_tables: np.ndarray | None = None) -> torch.Tensor:
        """One batched ragged decode step; returns logits [B, 1, V], valid
        until the next step."""
        logits = self._step("decode", tokens=np.asarray(tokens)[:, None],
                            pos=pos, active=active,
                            **self._tables(block_tables, state_tables))
        if self.scfg.paged:
            with span(self.telemetry, "runner.account", self._rid):
                self._count_decode_traffic(pos, active)
        return logits

    def _count_decode_traffic(self, pos: np.ndarray,
                              active: np.ndarray) -> None:
        """Host-side pages-touched / HBM-byte accounting for one paged
        decode step, as the JAX runner counts it.

        `decode_pages_touched` counts pages whose V is read, summed over
        active slots (not multiplied by layers or kv heads).
        `decode_hbm_bytes` is the K+V traffic over all attention layers and
        kv heads: the dense walk reads every resident page's k_bits and V;
        page-sparse phase 1 reads every resident page's k_bits and phase 2
        only the min(page_topn, resident) selected pages' k_bits and V.
        """
        res = (np.asarray(pos, np.int64)[np.asarray(active, bool)]
               + self.page) // self.page          # ceil((pos+1)/page)
        ptn = self.scfg.page_topn
        sel = res if ptn is None else np.minimum(res, ptn)
        self.stats["decode_pages_touched"] += int(sel.sum())
        kb, vb = self._page_k_bytes, self._page_v_bytes
        if ptn is None:
            step_bytes = int((res * (kb + vb)).sum())
        else:
            step_bytes = int((res * kb + sel * (kb + vb)).sum())
        self.stats["decode_hbm_bytes"] += step_bytes * self._attn_rows

    # ------------------------------------------------------------------
    # plan execution
    # ------------------------------------------------------------------
    def execute(self, plan: SchedulePlan) -> dict[int, list[int]]:
        """Run one SchedulePlan verbatim; returns per-slot sampled tokens
        in emission order."""
        return self.wait(self.execute_async(plan))

    @_mirrored
    def execute_async(self, plan: SchedulePlan) -> _PendingStep:
        """Enqueue one plan without the final host sync: swap transfers,
        prefill chunks (whose completion samples are drawn here: the
        same-step decode needs them on the host) and the decode step, whose
        logits are copied to the host buffer by a non-blocking copy. The
        returned `_PendingStep` is redeemed by `wait()`, which must come
        before the next dispatch; between the two the host is free."""
        if plan.swap_ins or plan.reclaims:
            with span(self.telemetry, "runner.swap", self._rid):
                for swap_in in plan.swap_ins:       # 1. restores
                    self._swap_in_pages(swap_in.request_id, swap_in.pages,
                                        swap_in.state_page)
                for rc in plan.reclaims:            # 2. gathers
                    if rc.kind == "swap-out":
                        self._swap_out_pages(rc.request_id, rc.pages,
                                             rc.state_page)
        for adm in plan.admissions:                 # 3. state restores
            if (adm.state_page >= 0 and adm.resume != "swap"
                    and adm.state_restore >= 0):
                self._state_copy(adm.state_restore, adm.state_page,
                                 count=False)
        results: dict[int, list[int]] = collections.defaultdict(list)
        b = self.scfg.batch_slots
        vocab = self.cfg.vocab_size
        sampled: dict[int, int] = {}
        eos_hit: set[int] = set()
        for ch in plan.prefill:                     # 4. prefill chunks
            req = ch.request
            self._rid = req.request_id
            logits = self.prefill_step(
                ch.slot, req.tokens[ch.lo:ch.hi], int(ch.pos[ch.slot]),
                None if plan.block_tables is None
                else plan.block_tables[ch.slot],
                -1 if plan.state_tables is None
                else int(plan.state_tables[ch.slot]),
                _chunk_extra(req.extra, int(req.tokens.size), ch.lo, ch.hi,
                             self.chunk))
            if ch.state_ckpt >= 0:
                # checkpoint the state at this chunk's page-aligned
                # frontier, for later prefix restores
                self._state_copy(int(plan.state_tables[ch.slot]),
                                 ch.state_ckpt)
            if ch.samples:
                with span(self.telemetry, "runner.sync", self._rid):
                    row = logits[0, 0, :vocab].cpu().numpy()
                with span(self.telemetry, "runner.sample", self._rid):
                    tok = _sample_token(row, req.sampling, ch.rng)
                sampled[ch.slot] = tok
                results[ch.slot].append(tok)
                if ch.eos_token is not None and tok == ch.eos_token:
                    eos_hit.add(ch.slot)
            self._rid = None
        entries = [e for e in plan.decode if e.slot not in eos_hit]
        host = ready = None
        if entries:                                 # 5. batched decode
            tokens = np.zeros((b,), np.int32)
            active = np.zeros((b,), bool)
            for e in entries:
                tokens[e.slot] = (sampled[e.slot] if e.token is None
                                  else e.token)
                active[e.slot] = True
            logits = self.decode_step(tokens,
                                      np.asarray(plan.decode_pos, np.int32),
                                      active, plan.block_tables,
                                      plan.state_tables)
            self.stats["decode_steps"] += 1
            host = self._host_logits
            if self.device.type == "cuda":
                host.copy_(logits[:, 0], non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
            else:
                host.copy_(logits[:, 0])
        return _PendingStep(results=dict(results), entries=entries,
                            logits=host, ready=ready)

    def wait(self, pending: _PendingStep) -> dict[int, list[int]]:
        """The host sync for one dispatched step: land pending swap-out
        bytes and the decode logits, and draw the decode tokens in plan
        entry order (the rng stream of the synchronous path)."""
        self._finalize_swaps()
        if pending.logits is not None:
            if pending.ready is not None:
                with span(self.telemetry, "runner.sync", self._rid):
                    pending.ready.synchronize()
            with span(self.telemetry, "runner.sample", self._rid):
                rows = pending.logits[:, :self.cfg.vocab_size].numpy()
                for e in pending.entries:
                    tok = _sample_token(rows[e.slot], e.sampling, e.rng)
                    pending.results.setdefault(e.slot, []).append(tok)
            pending.logits = None
        return pending.results

    # ------------------------------------------------------------------
    # page swap transfers (the data half of swap-out preemption)
    # ------------------------------------------------------------------
    def _page_index(self, pages) -> torch.Tensor:
        """Page (or entry) ids as an int64 tensor on the device, sent from
        pinned memory on the card so that the copy does not wait for the
        queue."""
        idx = torch.from_numpy(np.asarray(pages, np.int64))
        if self.device.type == "cuda":
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        return idx

    def _gather_to_host(self, layers, idx: torch.Tensor, stored: list
                        ) -> int:
        """Append, per layer, each leaf's rows `idx` (an `index_select`:
        stream order snapshots them before any later write), sent on the
        card to pinned host memory by a non-blocking copy. Under a mesh a
        head-sharded leaf's rows are gathered over the ranks' heads first,
        so every rank stores the full logical rows. Returns the bytes."""
        cuda = self.device.type == "cuda"
        nbytes = 0
        for i in layers:
            taken = {}
            for name, leaf in self.caches[i].items():
                part = leaf.index_select(0, idx)
                if self._head_sharded(name):
                    part = collectives.all_gather_heads(part, self.group)
                if cuda:
                    host = torch.empty(part.shape, dtype=part.dtype,
                                       pin_memory=True)
                    host.copy_(part, non_blocking=True)
                    part = host
                taken[name] = part
                nbytes += part.numel() * part.element_size()
            stored.append(taken)
        return nbytes

    def _scatter_from_host(self, layers, idx: torch.Tensor,
                           stored: list) -> int:
        """The inverse of `_gather_to_host`: `index_copy_` each layer's
        stored rows (under a mesh, this rank's heads of them) back into
        rows `idx`, in place. Returns the bytes."""
        nbytes = 0
        for i, taken in zip(layers, stored):
            for name, blob in taken.items():
                part = blob
                if self._head_sharded(name):
                    part = sharding.shard_tensor(
                        blob, sharding.serve_cache_spec(
                            name, blob.shape, self.mesh, head_axis=1),
                        self.mesh, self.mesh.rank)
                self.caches[i][name].index_copy_(
                    0, idx, part.to(self.device, non_blocking=True))
                nbytes += blob.numel() * blob.element_size()
        return nbytes

    def _swap_out_pages(self, request_id: int, pages: tuple,
                        state_page: int = -1) -> None:
        """Gather a victim's pages from every page-pool leaf (k_bits + v,
        or the fp k + v) and, when it holds one, its state entry from
        every state layer (SSM h and conv, the pooled cross caches), one
        `index_select`
        each, on the current stream ahead of the plan's replays: stream
        order snapshots the pre-recycle contents. On the card each gather
        then goes to pinned host memory by a non-blocking copy; the host
        waits for the bytes at the next `wait()` / `sync()`."""
        stored: list[dict[str, torch.Tensor]] = []
        nbytes = self._gather_to_host(self._pool_layers,
                                      self._page_index(pages), stored)
        if state_page >= 0:
            nbytes += self._gather_to_host(
                self._state_layers, self._page_index([state_page]), stored)
        if self.device.type == "cuda":
            self._swaps_landed = torch.cuda.Event()
            self._swaps_landed.record()
        self._swap_store[request_id] = stored
        self.stats["swap_out_bytes"] += nbytes
        if self.telemetry is not None:
            self.telemetry.on_swap_bytes(request_id, out=nbytes)

    def _finalize_swaps(self) -> None:
        """The blocking half of the swap-out copies, deferred to the
        step's sync point: the host enqueues the whole step before it
        waits for them."""
        if self._swaps_landed is not None:
            with span(self.telemetry, "runner.sync", self._rid):
                self._swaps_landed.synchronize()
            self._swaps_landed = None

    def _swap_in_pages(self, request_id: int, pages: tuple,
                       state_page: int = -1) -> None:
        """Scatter a swapped request's stored pages into its freshly
        allocated device pages, and its state entry into its new entry,
        with `index_copy_`, in place (the captured graphs read these
        tensors): the exact inverse of the gather, so the request resumes
        bit for bit with nothing re-prefilled."""
        stored = self._swap_store.pop(request_id)
        n_pool = len(self._pool_layers)
        nbytes = self._scatter_from_host(self._pool_layers,
                                         self._page_index(pages),
                                         stored[:n_pool])
        if state_page >= 0 and len(stored) > n_pool:
            nbytes += self._scatter_from_host(
                self._state_layers, self._page_index([state_page]),
                stored[n_pool:])
        self.stats["swap_in_bytes"] += nbytes
        if self.telemetry is not None:
            self.telemetry.on_swap_bytes(request_id, in_=nbytes)

    # ------------------------------------------------------------------
    # pooled state entry ops (in place, outside the captured graphs)
    # ------------------------------------------------------------------
    def _state_zero(self, entries: np.ndarray, layers) -> None:
        """Zero rows `entries` of the state of `layers` (SSM or cross
        layers): a dense engine's slots, or a pooled engine's state
        entries."""
        idx = torch.from_numpy(np.asarray(entries, np.int64)).to(self.device)
        for i in layers:
            for leaf in self.caches[i].values():
                leaf.index_fill_(0, idx, 0)

    def _state_copy(self, src: int, dst: int, count: bool = True) -> None:
        """Copy pooled state entry src -> dst in every state layer
        (checkpoint capture when `count`, counted in state_ckpt_bytes;
        checkpoint restore otherwise, counted by the scheduler)."""
        nbytes = 0
        with span(self.telemetry, "runner.state", self._rid):
            for i in self._state_layers:
                for leaf in self.caches[i].values():
                    leaf[dst].copy_(leaf[src])
                    nbytes += leaf[0].numel() * leaf.element_size()
        if count:
            self.stats["state_ckpt_bytes"] += nbytes
