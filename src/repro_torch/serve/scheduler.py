"""Serving policy layer: the Scheduler and its SchedulePlan contract.

This module is the *control plane* of the serving stack and is completely
device-free: it imports numpy and `serve.paged` only — no jax, no params,
no caches. All admission policy, prefill budgeting, page/prefix-cache
bookkeeping, victim selection and reclaim ordering live here, and every
decision is emitted as a frozen :class:`SchedulePlan` that the
:class:`repro_torch.serve.runner.ModelRunner` executes verbatim. The plan is the
ONLY channel from policy to execution; the only channel back is the
per-slot sampled tokens the runner returns, which `commit()` folds into
the scheduler's metadata (stop conditions, page registration, finishes).

Split responsibilities (vLLM-style scheduler/executor separation):

  * `Scheduler` owns: the request queue, per-slot metadata (`_Slot`),
    the `BlockAllocator` / `PrefixCache` / `SwapPool`, the host-side
    block tables, per-request sampling rng handles (opaque host objects),
    and recompute/swap resume state.
  * `ModelRunner` owns: the jitted step, cache pools, sampling execution,
    and the swapped pages' actual contents.
  * `Engine` is a compatibility facade wiring the two together.

Reclaim ordering under pool pressure (each `schedule()` records every
action it takes as a tagged `Reclaim` in the plan):

  1. ``lru-evict``   — reclaim cached-but-unreferenced prefix pages; no
     resident loses work, no device work needed.
  2. ``swap-out``    — gather the victim's device pages to the bounded
     host swap pool (`ServeConfig.swap_pages`) and free them; the
     request re-enters the queue and re-admission restores the pages
     verbatim at its preserved position — zero tokens re-prefilled.
  3. ``recompute-preempt`` — the fallback when the swap pool is full,
     disabled, or the victim carries sequence-aligned extra inputs:
     generated tokens fold into the prompt and are re-prefilled on
     re-admission (the rng rides along so the continuation is exact).

Victim selection is `ServeConfig.victim_policy`: ``"youngest"`` (highest
request id — preserves FCFS progress) or ``"longest-idle"`` (most
scheduler steps since the slot last emitted a token, ties to youngest).
"""
from __future__ import annotations

import collections
import copy
import dataclasses
from typing import Any

import numpy as np

from repro_torch.serve.paged import (BlockAllocator, PrefixCache, SwapPool,
                               chain_hash, pages_needed)
from repro_torch.serve.statepool import StatePool
from repro_torch.serve.telemetry import (SERVE_COUNTERS, MetricsRegistry,
                                         span)
from repro_torch.serve.validate import resolve_state_pages


@dataclasses.dataclass
class ServeConfig:
    max_len: int
    batch_slots: int
    binary: bool = True            # HAD path vs full-precision baseline
    topn: int | None = None        # None -> cfg.had.topn(max_len)
    # `step()` prefill token budget: each scheduler step spends at most one
    # prefill chunk of this many tokens on the slot being admitted before
    # running the batched decode. Smaller -> lower decode tail latency
    # (ITL) during admissions; larger -> faster TTFT for the admitted
    # request. Tail chunks are padded to this size (one jit trace).
    # When NO slot is decoding the budget is lifted: an otherwise-idle
    # batch spends as many chunks as it takes for a slot to reach decode.
    prefill_chunk: int = 512
    # Paged KV cache (serve/paged.py): self-attention caches become one
    # shared pool of `n_pages` pages of `page_size` tokens, allocated
    # lazily per prefill chunk / decode token and freed when a request
    # finishes — HBM scales with tokens resident, not slots x max_len.
    # n_pages=None reserves dense-equivalent capacity (never preempts);
    # smaller pools overcommit, and on exhaustion the scheduler reclaims
    # (LRU pages, then swap-out or recompute preemption of a victim).
    paged: bool = False
    page_size: int = 16
    n_pages: int | None = None
    # Automatic prefix caching (requires paged): fully-written pages are
    # published in a content-addressed index (chained page hashes), and
    # admission maps the longest cached page-aligned prefix of a prompt
    # straight into the slot's block table — those tokens are never
    # prefilled again (shared-system-prompt TTFT becomes O(suffix)). A
    # finished request's pages are downgraded to an LRU instead of freed;
    # pool pressure reclaims LRU pages BEFORE preempting any resident.
    # Models with SSM/cross-attention layers participate through pooled
    # state checkpoints (see `state_pages`): a warm match restores the
    # checkpoint of the matched page-aligned prefix.
    prefix_cache: bool = False
    # Admission policy: which queued request a freed slot takes next.
    # "fcfs" -> submission order; "shortest-prompt" -> fewest prompt
    # tokens first (ties by submission order). Pure host-side reordering.
    policy: str = "fcfs"
    # Page-aligned swap-out preemption (requires paged): a bounded
    # host-side pool of this many pages receives an evicted victim's
    # device pages (k_bits/v and fp twins, gathered at page granularity),
    # so re-admission restores them verbatim and resumes at the preserved
    # position — no re-prefill, generated tokens and sampling rng intact.
    # 0 disables swapping (recompute preemption only). Recompute remains
    # the fallback whenever the pool is full or the victim carries
    # sequence-aligned extra inputs. Models with SSM/cross-attention
    # layers gather/restore their pooled state entry atomically with
    # their KV pages (see `state_pages`).
    swap_pages: int = 0
    # Victim selection under slot/page pressure: "youngest" evicts the
    # highest request id (FCFS progress, the historical behavior);
    # "longest-idle" evicts the slot with the most scheduler steps since
    # it last emitted a token (ties to youngest) — a fairness policy that
    # protects actively-streaming residents.
    victim_policy: str = "youngest"
    # Top-N page-sparse decode (requires paged): each decode step scores
    # every resident page per (slot, kv-head) from the stored k_bits
    # bit-planes (popcount upper bound on any key's Hamming score) and
    # attends only the best `page_topn` pages — the frontier page always
    # among them — through a compacted block table, so per-step V reads
    # are O(page_topn * page_size) instead of O(context). STATIC: baked
    # into the (single) decode trace. None disables; values at or above
    # a slot's resident page count are bit-identical to dense paged
    # decode. Prefill chunks are unaffected.
    page_topn: int | None = None
    # Pooled recurrent/cross state (models with SSM or cross-attention
    # layers, paged only): per-slot `h`/`conv`/cross-cache state lives in
    # a shared pool of this many entries (serve/statepool.py) addressed
    # through a traced entry table, mirroring the KV page pools. Spare
    # entries beyond one-per-slot hold prefix-cache CHECKPOINTS: at each
    # KV-page boundary of a cacheable chunked prefill the live entry is
    # copied into a checkpoint keyed by the page's chained hash, so a
    # warm prefix hit restores the recurrent state of the matched
    # boundary. None auto-sizes (batch_slots, x4 with prefix_cache);
    # must be >= batch_slots (>= 2x with prefix_cache).
    state_pages: int | None = None
    # Where a cacheable prefill takes its state checkpoints (pooled state
    # with prefix_cache): "chunks", the JAX package's, at every chunk end
    # that falls on a KV-page boundary; or "documents", only for prompts
    # submitted to fill the cache (max_new_tokens 0), one at the prompt's
    # last full-page boundary (its chunk is cut there), so a prompt that
    # extends such a document restores at most page_size - 1 tokens short
    # of its end, and no other prefill's checkpoint evicts it.
    state_checkpoints: str = "chunks"
    # Priority tiers on the victim-policy hook: when True, requests
    # submitted with priority="latency" are never swapped out or
    # recompute-preempted while any "batch"-tier resident is a viable
    # victim (multi-tenant SLO protection). Victim_policy then ranks
    # within the chosen tier.
    priority: bool = False
    # Tensor-parallel serving: a jax Mesh with a "model" axis (see
    # launch.mesh.make_host_mesh). The ModelRunner shard_maps its jitted
    # step over it — params head-sharded, page pools sharded over the
    # kv-head dim, block tables replicated. OPAQUE here: the scheduler
    # never touches it (and this module must keep importing no jax);
    # validation lives in serve/validate.py, execution in runner.py.
    mesh: Any = None


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 0.0       # 0 -> greedy argmax
    top_k: int = 0                 # 0 -> full vocab
    seed: int = 0


@dataclasses.dataclass
class Request:
    """One generation request. `tokens` is the [S] int prompt."""
    tokens: np.ndarray
    max_new_tokens: int = 16
    eos_token: int | None = None
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    extra: dict | None = None      # per-request model inputs, batch dim 1
    priority: str = "batch"        # "latency" | "batch" (ServeConfig.priority)
    request_id: int = -1           # assigned by submit


@dataclasses.dataclass
class FinishedRequest:
    request_id: int
    prompt_len: int
    tokens: np.ndarray             # generated tokens (includes eos if hit)


@dataclasses.dataclass
class _Slot:
    request: Request | None = None
    length: int = 0                # valid cache length (tokens written)
    prefill_pos: int = 0           # prompt tokens prefilled so far
    next_token: int = 0            # pending token to feed next decode
    generated: list[int] = dataclasses.field(default_factory=list)
    rng: Any = None
    prompt_len: int = 0            # ORIGINAL prompt length (resumed
                                   # requests carry re-prefilled tokens)
    # prefix caching: chained keys of the slot's COMPLETED (fully-written
    # or matched) pages so far; False for requests whose KV content is not
    # a pure function of their tokens (per-request extra inputs)
    page_keys: list = dataclasses.field(default_factory=list)
    cacheable: bool = False
    # physical pages backing this slot, in logical (block) order — the
    # incremental mirror of the block-table row, so page counts are O(1)
    # instead of an O(max_blocks) row scan per allocated token
    pages: list[int] = dataclasses.field(default_factory=list)
    # scheduler steps since this slot last emitted a token (resident
    # slots only) — the "longest-idle" victim policy's signal
    idle: int = 0
    # pooled recurrent/cross state (serve/statepool.py): the slot's live
    # entry id (-1 = none / model has no state layers), mirrored into
    # `state_tables`
    state_page: int = -1
    # transient: checkpoint entry a planned prefix-restore copies from
    # (-1 = zero-init); consumed into the PlannedAdmission
    state_src: int = -1

    @property
    def prefilling(self) -> bool:
        return (self.request is not None
                and self.prefill_pos < self.request.tokens.size)

    @property
    def decoding(self) -> bool:
        return self.request is not None and not self.prefilling


# ---------------------------------------------------------------------------
# the SchedulePlan: policy's only channel to execution
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Reclaim:
    """One pool-pressure action taken during planning, in plan order."""
    kind: str                      # "lru-evict" | "swap-out" | "recompute-preempt"
    slot: int = -1                 # victim slot (-1 for lru-evict)
    request_id: int = -1
    pages: tuple = ()              # swap-out: device pages to gather, in
                                   # logical (block) order
    state_page: int = -1           # swap-out: pooled state entry to gather
                                   # alongside the pages (-1 = stateless)


@dataclasses.dataclass(frozen=True)
class PlannedAdmission:
    slot: int
    request: Request
    resume: str                    # "fresh" | "recompute" | "swap"
    cached_tokens: int = 0         # prefix-cache tokens mapped at admission
    state_page: int = -1           # live pooled state entry (-1 = stateless)
    state_restore: int = -1        # checkpoint entry to copy into the live
                                   # entry (-1 = zero-init; "swap" resumes
                                   # restore from the swap payload instead)


@dataclasses.dataclass(frozen=True)
class SwapIn:
    """Restore a swapped request's pages into freshly allocated device
    pages (the runner scatters the stored host arrays into `pages`)."""
    slot: int
    request_id: int
    pages: tuple                   # NEW device pages, logical order
    length: int                    # preserved cache length (resume pos)
    state_page: int = -1           # NEW pooled state entry the stored
                                   # state payload scatters into


@dataclasses.dataclass(frozen=True)
class PrefillChunk:
    """One prefill chunk: request.tokens[lo:hi] into `slot`.

    `pos` is the full per-slot position vector at this chunk's point in
    the plan (the runner reads `slot`'s entry: a chunk carries its slot's
    row only).
    When `samples` is set the chunk completes the prompt and the runner
    samples the first generated token from the chunk's logits with `rng`;
    if that token equals `eos_token` the slot is dropped from this plan's
    decode batch (the one stop condition only execution can see)."""
    slot: int
    request: Request
    lo: int
    hi: int
    pos: tuple
    samples: bool
    rng: Any = None
    eos_token: int | None = None
    # pooled state checkpoint: after this chunk executes, copy the slot's
    # live state entry into this (held) entry — `hi` lands exactly on a
    # KV-page boundary, so the copy is the recurrent state matching the
    # chain of full pages [0, hi). -1 = no checkpoint. commit() registers
    # the entry under the page-chain key (or frees it on mismatch).
    state_ckpt: int = -1


@dataclasses.dataclass(frozen=True)
class DecodeSlot:
    """One slot of the batched ragged decode step. `token` is the input
    token; None means "the token this plan's prefill completion sampled"
    (same-step prefill->decode handoff). `request` identifies the slot's
    occupant at plan time so a pipelined engine can detect that the slot
    changed hands between planning and execution (`resolve_plan`)."""
    slot: int
    token: int | None
    sampling: SamplingParams
    rng: Any = None
    request: Any = None


@dataclasses.dataclass(frozen=True)
class SchedulePlan:
    """Everything one engine step executes, decided entirely at plan time.

    Execution order (ModelRunner.execute): swap-in scatters (KV pages +
    state entry), then reclaim gathers (swap-outs, KV + state), then
    admission state-entry init (zero or checkpoint restore), then prefill
    chunks in order (each followed by its planned checkpoint copy), then
    one batched decode over `decode` minus eos-dropped slots. That order
    is load-bearing for entry recycling: a swap-out victim's freed entry
    may be reallocated as a later chunk's checkpoint in the SAME plan —
    the gather must read it before the copy overwrites it.
    `block_tables`/`state_tables` are plan-time snapshots of the host
    tables (None when not paged / stateless); they are final for the
    whole step — every planned write lands in pages/entries the snapshots
    already map.
    """
    admissions: tuple = ()
    reclaims: tuple = ()
    swap_ins: tuple = ()
    prefill: tuple = ()
    decode: tuple = ()
    decode_pos: tuple = ()         # [batch_slots] per-slot positions
    block_tables: Any = None       # np.ndarray [batch_slots, max_blocks]
    state_tables: Any = None       # np.ndarray [batch_slots] pooled state
                                   # entry per slot (-1 = none); None for
                                   # stateless/dense models


class Scheduler:
    """Pure-policy serving scheduler over host-side metadata.

    Constructible from a `ServeConfig` alone — no params, no caches, no
    device arrays — so every policy (admission order, prefill budget,
    reclaim ordering, victim selection) is unit-testable on the
    `SchedulePlan` it emits. Drive it in tests by faking the runner:
    `commit(plan, {slot: [token, ...]})`.
    """

    def __init__(self, scfg: ServeConfig, stats: dict | None = None, *,
                 state_layers: int = 0):
        """`state_layers` is the count of recurrent/cross (SSM 'M' /
        cross-attention 'C') positions in the model's layer pattern —
        passed by the engine so the scheduler stays pattern-agnostic.
        Nonzero + paged turns on the pooled state accounting."""
        if scfg.policy not in ("fcfs", "shortest-prompt"):
            raise ValueError(f"unknown policy {scfg.policy!r}")
        if scfg.victim_policy not in ("youngest", "longest-idle"):
            raise ValueError(
                f"unknown victim_policy {scfg.victim_policy!r}")
        if scfg.state_checkpoints not in ("chunks", "documents"):
            raise ValueError(
                f"unknown state_checkpoints {scfg.state_checkpoints!r}")
        if scfg.prefix_cache and not scfg.paged:
            raise ValueError("prefix_cache requires paged=True (pages are "
                             "the unit of sharing)")
        if scfg.swap_pages and not scfg.paged:
            raise ValueError("swap_pages requires paged=True (pages are "
                             "the unit of swapping)")
        if scfg.page_topn is not None:
            if not scfg.paged:
                raise ValueError("page_topn requires paged=True (pages are "
                                 "the unit of selection)")
            if scfg.page_topn < 1:
                raise ValueError(f"page_topn must be >= 1, got "
                                 f"{scfg.page_topn} (the frontier page is "
                                 f"always attended)")
        self.scfg = scfg
        self.chunk = max(1, min(scfg.prefill_chunk, scfg.max_len))
        if scfg.paged:
            self.page = scfg.page_size
            self.max_blocks = pages_needed(scfg.max_len, self.page)
            self.n_pages = (scfg.n_pages if scfg.n_pages is not None
                            else scfg.batch_slots * self.max_blocks)
            self.allocator: BlockAllocator | None = BlockAllocator(
                self.n_pages, self.page)
            # host-side block tables, snapshotted into every plan and
            # mirrored to device as a TRACED argument (contents never
            # recompile); -1 = unallocated
            self.block_tables = np.full(
                (scfg.batch_slots, self.max_blocks), -1, np.int32)
        else:
            self.page = scfg.page_size
            self.max_blocks = 0
            self.n_pages = 0
            self.allocator = None
            self.block_tables = None
        self.prefix = (PrefixCache(self.allocator) if scfg.prefix_cache
                       else None)
        self.swap = (SwapPool(scfg.swap_pages, self.page)
                     if scfg.paged and scfg.swap_pages else None)
        self.state_layers = state_layers
        if scfg.paged and state_layers > 0:
            self.n_state_pages = resolve_state_pages(scfg)
            self.statepool: StatePool | None = StatePool(self.n_state_pages)
            # host-side pooled-state entry table, snapshotted into every
            # plan and mirrored to device as a TRACED argument; -1 = none
            self.state_tables: np.ndarray | None = np.full(
                (scfg.batch_slots,), -1, np.int32)
        else:
            self.n_state_pages = 0
            self.statepool = None
            self.state_tables = None
        self.slots = [_Slot() for _ in range(scfg.batch_slots)]
        self.queue: collections.deque[Request] = collections.deque()
        self._finished: list[FinishedRequest] = []
        self._resume: dict[int, dict] = {}     # recompute-preempted state
        self._swap_meta: dict[int, dict] = {}  # swapped-out request state
        self._next_id = 0
        # the declared metrics schema replaces ad-hoc setdefault seeding:
        # a typo'd counter key now raises KeyError instead of silently
        # minting a new counter. Registry access is dict-compatible, so
        # `stats["k"] += 1` / `dict(stats)` call sites are unchanged.
        self.stats = MetricsRegistry.adopt(stats)
        self.stats.declare_counters(SERVE_COUNTERS)
        # optional observability hub (set by the Engine); every hook is
        # behind one `is not None` test so the disabled path is free
        self.telemetry = None
        # optional per-token streaming sink: callable(request_id, token),
        # invoked the moment a sampled token is committed (or routed to a
        # preempted request) — the hook behind AsyncEngine streaming and
        # `launch.serve`'s live token printing
        self.token_sink = None
        # transient planning state (valid inside one schedule() call)
        self._plan_reclaims: list[Reclaim] = []
        self._plan_chunks: list[PrefillChunk] = []
        self._completed: set[int] = set()
        # checkpoint entries this plan's admissions restore FROM — pinned
        # against same-plan LRU eviction (the restore copy executes after
        # any would-be overwrite of a recycled entry)
        self._plan_state_pins: set[int] = set()

    def _state_alloc(self, **kw) -> int | None:
        """`StatePool.alloc`, counting the checkpoints it evicts."""
        before = self.statepool.evictions
        got = self.statepool.alloc(**kw)
        self.stats["state_evictions"] += self.statepool.evictions - before
        return got

    # ------------------------------------------------------------------
    # queue API
    # ------------------------------------------------------------------
    def submit(self, tokens: np.ndarray | Request, max_new_tokens: int = 16,
               *, eos_token: int | None = None,
               sampling: SamplingParams | None = None,
               extra: dict | None = None, priority: str = "batch") -> int:
        """Enqueue a request; returns its request_id. May be called at any
        time — admission happens at the next `schedule()` if a slot is
        free."""
        if isinstance(tokens, Request):
            # own copy: never alias caller. dataclasses.replace alone is
            # SHALLOW — `sampling` and `extra` (and the arrays inside
            # `extra`) would still alias the caller's objects, so a
            # mutate-after-submit would rewrite a queued request.
            req = dataclasses.replace(
                tokens, sampling=dataclasses.replace(tokens.sampling),
                extra=copy.deepcopy(tokens.extra))
        else:
            req = Request(tokens=np.asarray(tokens, np.int32),
                          max_new_tokens=max_new_tokens, eos_token=eos_token,
                          sampling=(dataclasses.replace(sampling) if sampling
                                    else SamplingParams()),
                          extra=copy.deepcopy(extra), priority=priority)
        if req.priority not in ("latency", "batch"):
            raise ValueError(f"unknown priority {req.priority!r}")
        # copy (np.array, not asarray): the queued prompt must not alias a
        # caller buffer that may be reused before admission
        req.tokens = np.array(req.tokens, np.int32).reshape(-1)
        if req.tokens.size < 1:
            raise ValueError("empty prompt")
        if req.tokens.size + req.max_new_tokens > self.scfg.max_len:
            raise ValueError(
                f"prompt ({req.tokens.size}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds max_len {self.scfg.max_len}")
        if (self.scfg.paged and
                pages_needed(req.tokens.size + req.max_new_tokens, self.page)
                > self.allocator.n_pages):
            raise ValueError(
                f"request needs more pages than the whole pool "
                f"({req.tokens.size + req.max_new_tokens} tokens, "
                f"{self.allocator.n_pages} x {self.page}-token pages)")
        req.request_id = self._next_id
        self._next_id += 1
        self.queue.append(req)
        if self.telemetry is not None:
            self.telemetry.on_submit(req.request_id, int(req.tokens.size))
        return req.request_id

    def _prompt_rank(self, req: Request) -> tuple[int, int]:
        """shortest-prompt sort key. Preempted (recompute OR swap) requests
        rank by their ORIGINAL prompt length (a recompute-resumed request's
        tokens grew by the folded-in generation replay — ranking on that
        would self-deprioritize a request a little more on every eviction,
        starving it under a stream of short submissions)."""
        entry = (self._resume.get(req.request_id)
                 or self._swap_meta.get(req.request_id))
        size = entry["prompt_len"] if entry else int(req.tokens.size)
        return (size, req.request_id)

    def _peek_next(self) -> Request:
        """The request `_pop_next` would take, without taking it."""
        if self.scfg.policy == "shortest-prompt":
            return min(self.queue, key=self._prompt_rank)
        return self.queue[0]

    def _pop_next(self) -> Request:
        """Take the next request per ServeConfig.policy (host-side only)."""
        if self.scfg.policy == "shortest-prompt":
            best = min(range(len(self.queue)),
                       key=lambda i: self._prompt_rank(self.queue[i]))
            self.queue.rotate(-best)
            req = self.queue.popleft()
            self.queue.rotate(best)
            return req
        return self.queue.popleft()

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------
    def schedule(self) -> SchedulePlan:
        """One scheduling decision: admit queued requests into free slots,
        assign the prefill budget (one chunk of the earliest admission —
        or as many chunks as it takes to reach a decodable slot when
        nothing is decoding), pick the decode slot set, and resolve every
        page allocation (reclaiming under pressure). Pure host-side
        policy; the returned frozen plan is executed verbatim by the
        ModelRunner and then folded back via `commit()`."""
        self._plan_reclaims = []
        self._plan_chunks = []
        self._completed = set()
        self._plan_state_pins = set()
        admissions: list[PlannedAdmission] = []
        swap_ins: list[SwapIn] = []
        for i, slot in enumerate(self.slots):
            if slot.request is not None or not self.queue:
                continue
            req = self._peek_next()
            if req.request_id in self._swap_meta:
                pages = self._alloc_swap_in(
                    self._swap_meta[req.request_id]["n_pages"],
                    rid=req.request_id)
                if pages is None:
                    # head-of-line: a swapped request re-admits only when
                    # its full page set is available without preempting
                    # anyone; it keeps queue seniority while it waits
                    break
                self._pop_next()
                swap_ins.append(self._admit_swapped(i, req, pages))
                admissions.append(PlannedAdmission(
                    i, req, "swap", state_page=slot.state_page))
                if self.telemetry is not None:
                    self.telemetry.on_admit(req.request_id, "swap")
            else:
                self._pop_next()
                resume = ("recompute" if req.request_id in self._resume
                          else "fresh")
                before = self.stats["cached_tokens"]
                replayed0 = self.stats["replayed_tokens"]
                self._admit(i, req)
                cached = self.stats["cached_tokens"] - before
                admissions.append(PlannedAdmission(
                    i, req, resume,
                    cached_tokens=cached,
                    state_page=slot.state_page,
                    state_restore=slot.state_src))
                slot.state_src = -1
                if self.telemetry is not None:
                    self.telemetry.on_admit(
                        req.request_id, resume, cached_tokens=cached,
                        replayed_tokens=(self.stats["replayed_tokens"]
                                         - replayed0))
        residents = sum(s.request is not None for s in self.slots)
        self.stats["max_residents"] = max(self.stats["max_residents"],
                                          residents)
        self._plan_prefill_budget()
        decode, decode_pos = self._plan_decode()
        plan = SchedulePlan(
            # an admission undone by a same-plan reclaim is dropped (the
            # reclaim entry records what happened) — but its SwapIn is
            # KEPT: the runner must still restore the pages' content
            # before a re-swap-out gathers them (and the restore is
            # harmless otherwise: any page recycled to another slot is
            # fully overwritten by that slot's planned writes)
            admissions=tuple(a for a in admissions
                             if self.slots[a.slot].request is a.request),
            reclaims=tuple(self._plan_reclaims),
            swap_ins=tuple(swap_ins),
            prefill=tuple(self._plan_chunks),
            decode=decode,
            decode_pos=decode_pos,
            block_tables=(None if self.block_tables is None
                          else self.block_tables.copy()),
            state_tables=(None if self.state_tables is None
                          else self.state_tables.copy()))
        return plan

    def _plan_prefill_budget(self) -> None:
        """Assign the step's prefill budget. With a decoding resident the
        budget is ONE chunk (interleaving bounds residents' ITL); on an
        otherwise-idle batch chunks keep flowing until a slot reaches
        decode (or nothing is left to prefill), so a lone long admission
        no longer costs one scheduler step per chunk."""
        spent = 0
        while True:
            prefilling = [i for i, s in enumerate(self.slots)
                          if s.prefilling]
            if not prefilling:
                return
            if spent >= 1 and any(s.decoding for s in self.slots):
                return
            i = min(prefilling,
                    key=lambda j: self.slots[j].request.request_id)
            self._plan_prefill_chunk(i)
            spent += 1

    def _plan_prefill_chunk(self, i: int) -> None:
        """Plan one padded prefill chunk for slot i (ensuring its pages —
        which may reclaim, including preempting slot i itself, in which
        case no chunk is planned)."""
        slot = self.slots[i]
        req = slot.request
        s = int(req.tokens.size)
        lo = slot.prefill_pos
        hi = min(lo + self.chunk, s)
        ckpts = (self.statepool is not None and self.prefix is not None
                 and slot.cacheable)
        if ckpts and self.scfg.state_checkpoints == "documents":
            # one checkpoint, at the last full page of a prompt that asks
            # for no token (it only fills the cache): its chunk ends there
            tail = s // self.page * self.page
            ckpts = req.max_new_tokens == 0 and lo < tail <= hi
            if ckpts:
                hi = tail
        if not self._ensure_pages(i, hi):
            return                      # slot itself reclaimed for pages
        pos = tuple(int(sl.length) for sl in self.slots)
        samples = hi == s and req.max_new_tokens > 0
        ckpt = -1
        if ckpts and hi % self.page == 0:
            # the chunk ends exactly on a KV-page boundary: capture the
            # recurrent state there so a prefix hit on the page chain
            # [0, hi) can restore it. Best-effort — alloc may come up
            # empty when every spare entry is a pinned restore source.
            got = self._state_alloc(evict_skip=self._plan_state_pins)
            ckpt = -1 if got is None else got
        self._plan_chunks.append(PrefillChunk(
            slot=i, request=req, lo=lo, hi=hi, pos=pos, samples=samples,
            rng=slot.rng, eos_token=req.eos_token, state_ckpt=ckpt))
        slot.prefill_pos = hi
        slot.length = hi
        if hi == s:
            self._completed.add(i)

    def _decode_ok(self, i: int) -> bool:
        """Whether slot i belongs in this plan's decode batch: decoding,
        and — if its prefill completes this very step — still needing a
        second token beyond the one the chunk's logits sample."""
        s = self.slots[i]
        if not s.decoding:
            return False
        if i in self._completed and (s.request.max_new_tokens
                                     - len(s.generated) < 2):
            return False
        return True

    def _plan_decode(self) -> tuple[tuple, tuple]:
        cands = [i for i in range(len(self.slots)) if self._decode_ok(i)]
        if self.scfg.paged and cands:
            # oldest slots claim pages first, so pool pressure lands on
            # the youngest (an ensure can only reclaim younger slots or
            # the requester itself)
            for i in sorted(cands,
                            key=lambda j: self.slots[j].request.request_id):
                if self.slots[i].decoding:
                    self._ensure_pages(i, self.slots[i].length + 1)
            cands = [i for i in cands if self._decode_ok(i)]
        decode_pos = tuple(int(s.length) for s in self.slots)
        entries = []
        for i in cands:
            slot = self.slots[i]
            entries.append(DecodeSlot(
                slot=i,
                token=None if i in self._completed else slot.next_token,
                sampling=slot.request.sampling, rng=slot.rng,
                request=slot.request))
            slot.length += 1
        return tuple(entries), decode_pos

    # ------------------------------------------------------------------
    # result feedback
    # ------------------------------------------------------------------
    def commit(self, plan: SchedulePlan, results: dict[int, list[int]]
               ) -> list[FinishedRequest]:
        """Fold the runner's sampled tokens back into scheduler state:
        append tokens, apply stop conditions, register newly completed
        prefix pages, free finished slots, and advance idle counters.
        Returns the requests that finished this step.

        Exactly `commit_structural(plan)` followed by
        `commit_tokens(plan, results)` — the two halves a pipelined
        engine calls separately so plan N+1 can be built while step N is
        still in flight on device."""
        self.commit_structural(plan)
        return self.commit_tokens(plan, results)

    def commit_structural(self, plan: SchedulePlan) -> None:
        """The token-independent half of `commit()`: every effect that is
        knowable from the plan alone — prefix-page registration at each
        chunk's frontier, state-checkpoint registration, returning
        checkpoint entries planned for since-evicted slots, and
        `max_new_tokens == 0` finishes. Safe to apply the moment the plan
        is dispatched, before any sampled token exists, so the next
        `schedule()` sees the structural state exactly as the synchronous
        path would."""
        for ch in plan.prefill:
            i = ch.slot
            slot = self.slots[i]
            if slot.request is not ch.request:
                # the slot changed hands between planning and commit; a
                # planned checkpoint entry must still be returned
                if ch.state_ckpt >= 0:
                    self.statepool.free(ch.state_ckpt)
                continue
            # register at the chunk's own frontier: `length` was advanced
            # for the whole plan (a same-step decode adds +1), but a page
            # completed by that decode token must be keyed AFTER the
            # token is pushed — commit_tokens' decode pass handles it
            post = slot.length
            slot.length = ch.hi
            self._register_full_pages(i, slot)
            slot.length = post
            if ch.state_ckpt >= 0:
                self._register_state_ckpt(ch, slot)
            if (ch.hi == int(ch.request.tokens.size)
                    and ch.request.max_new_tokens == 0):
                self._finish(i)

    def commit_tokens(self, plan: SchedulePlan,
                      results: dict[int, list[int]]
                      ) -> list[FinishedRequest]:
        """The sampled-token half of `commit()`: pushes tokens, applies
        eos/max_new_tokens stop conditions, registers pages completed by
        decode tokens, and advances idle counters. In pipelined mode a
        plan's slot may have been reclaimed (by the interleaved
        `schedule()`) while its step was in flight — its sampled token is
        then routed to the preempted request's resume record instead of
        dropped, so a swapped/recomputed victim resumes with the exact
        token stream of an unpreempted run."""
        remaining = {i: list(toks) for i, toks in results.items()}
        emitted: set[int] = set()
        for ch in plan.prefill:
            i = ch.slot
            slot = self.slots[i]
            if not ch.samples or not remaining.get(i):
                continue
            if slot.request is not ch.request:
                self._route_token(ch.request, remaining[i].pop(0))
                continue
            tok = remaining[i].pop(0)
            emitted.add(i)
            self._push_token(i, slot, tok)
        for entry in plan.decode:
            i = entry.slot
            slot = self.slots[i]
            if not remaining.get(i):
                continue               # finished at its prefill sample
            if slot.request is None or (entry.request is not None
                                        and slot.request is not entry.request):
                self._route_token(entry.request, remaining[i].pop(0))
                continue
            # register pages at the PLAN's post-decode frontier: in
            # pipelined mode `slot.length` may already include the next
            # plan's in-flight advance, whose token does not exist yet
            post = slot.length
            if plan.decode_pos:
                slot.length = plan.decode_pos[i] + 1
            self._register_full_pages(i, slot)
            slot.length = post
            tok = remaining[i].pop(0)
            emitted.add(i)
            self._push_token(i, slot, tok)
        for i, slot in enumerate(self.slots):
            if slot.request is not None:
                slot.idle = 0 if i in emitted else slot.idle + 1
        return self._drain_finished()

    def resolve_plan(self, plan: SchedulePlan) -> SchedulePlan:
        """Re-bind a plan built before the previous step's tokens were
        committed (the pipelined schedule/execute overlap): stale decode
        input tokens are replaced with the slot's now-current
        `next_token`, decode entries for slots that finished meanwhile
        are dropped, and swap-out gathers for requests that finished via
        token routing are cancelled. A no-op (returns `plan` unchanged)
        on the synchronous path, where nothing can go stale."""
        changed = False
        decode = []
        for e in plan.decode:
            slot = self.slots[e.slot]
            if slot.request is None or (e.request is not None
                                        and slot.request is not e.request):
                changed = True         # finished between plan and launch
                continue
            if e.token is not None and e.token != slot.next_token:
                e = dataclasses.replace(e, token=slot.next_token)
                changed = True
            decode.append(e)
        reclaims = plan.reclaims
        if any(rc.kind == "swap-out" and rc.request_id not in self._swap_meta
               for rc in reclaims):
            # the victim finished off-slot (a routed eos/max_new token):
            # its reservation is released and nothing will ever restore
            # the gather — cancel it so the runner's swap store stays
            # bounded by live reservations
            reclaims = tuple(
                rc for rc in reclaims
                if not (rc.kind == "swap-out"
                        and rc.request_id not in self._swap_meta))
            changed = True
        if not changed:
            return plan
        return dataclasses.replace(plan, decode=tuple(decode),
                                   reclaims=reclaims)

    def _push_token(self, i: int, slot: _Slot, tok: int) -> None:
        slot.generated.append(tok)
        slot.next_token = tok
        self.stats["tokens_generated"] += 1
        if self.telemetry is not None:
            self.telemetry.on_token(slot.request.request_id)
        if self.token_sink is not None:
            with span(self.telemetry, "scheduler.sink",
                      slot.request.request_id):
                self.token_sink(slot.request.request_id, tok)
        req = slot.request
        if (len(slot.generated) >= req.max_new_tokens
                or (req.eos_token is not None and tok == req.eos_token)):
            self._finish(i)

    def _route_token(self, req: Request | None, tok: int) -> None:
        """Credit a sampled token to a request whose slot was reclaimed
        while the step was in flight (pipelined mode only). The token is
        appended to the preempted request's resume record — its KV is
        already captured (swap gathers execute after the in-flight step's
        cache writes; recompute replays the extended prompt) — and the
        stop conditions are applied off-slot, finishing the request
        straight out of the queue when it is done."""
        if req is None:
            return
        rid = req.request_id
        meta = self._swap_meta.get(rid)
        entry = self._resume.get(rid) if meta is None else None
        if meta is not None:
            meta["generated"].append(tok)
            meta["next_token"] = tok
            generated, prompt_len = meta["generated"], meta["prompt_len"]
        elif entry is not None:
            entry["generated"].append(tok)
            # recompute resume replays generated tokens from the folded
            # prompt — the routed token must replay with them
            req.tokens = np.concatenate(
                [req.tokens, np.asarray([tok], np.int32)])
            generated, prompt_len = entry["generated"], entry["prompt_len"]
        else:
            return                     # already retired — drop
        self.stats["tokens_generated"] += 1
        if self.telemetry is not None:
            self.telemetry.on_token(rid)
        if self.token_sink is not None:
            with span(self.telemetry, "scheduler.sink", rid):
                self.token_sink(rid, tok)
        if (len(generated) >= req.max_new_tokens
                or (req.eos_token is not None and tok == req.eos_token)):
            try:
                self.queue.remove(req)
            except ValueError:
                pass
            if meta is not None:
                self._swap_meta.pop(rid, None)
                self.swap.release(rid)
            else:
                self._resume.pop(rid, None)
            self._finished.append(FinishedRequest(
                request_id=rid, prompt_len=prompt_len,
                tokens=np.asarray(generated, np.int32)))
            if self.telemetry is not None:
                self.telemetry.on_finish(rid)

    def _finish(self, i: int) -> None:
        slot = self.slots[i]
        self._finished.append(FinishedRequest(
            request_id=slot.request.request_id,
            prompt_len=slot.prompt_len,
            tokens=np.asarray(slot.generated, np.int32)))
        if self.telemetry is not None:
            self.telemetry.on_finish(slot.request.request_id)
        # free the slot AND reset its serving state: a stale `length` would
        # false-trip the lockstep decode() guard and feed garbage positions
        # for the inactive row. Paged: drop the slot's page refs the moment
        # the request finishes — unregistered pages return to the pool,
        # prefix-registered ones downgrade to the reclaimable LRU (that
        # downgrade-not-free is what keeps a finished request's prompt
        # pages matchable by its successors).
        if self.scfg.paged:
            self._free_slot_pages(i)
        self._free_slot_state(i)
        self._clear_slot(i)

    def _drain_finished(self) -> list[FinishedRequest]:
        out, self._finished = self._finished, []
        return out

    # ------------------------------------------------------------------
    # paged-pool internals
    # ------------------------------------------------------------------
    def _free_slot_pages(self, i: int) -> None:
        # highest block first: cached pages then park on the LRU leaf-
        # before-root, so pool pressure evicts a cached chain from its
        # TAIL — evicting the root first would unmatchably orphan every
        # descendant key while those pages still sat in the pool
        slot = self.slots[i]
        for page in reversed(slot.pages):
            self.allocator.free(int(page))
        slot.pages = []
        self.block_tables[i, :] = -1

    def _free_slot_state(self, i: int) -> None:
        """Return slot i's live pooled state entry (its contents are dead:
        finished, preempted, or already gathered to the swap store)."""
        slot = self.slots[i]
        if self.statepool is not None and slot.state_page >= 0:
            self.statepool.free(slot.state_page)
            slot.state_page = -1
            slot.state_src = -1
            self.state_tables[i] = -1

    def _clear_slot(self, i: int) -> None:
        slot = self.slots[i]
        slot.request = None
        slot.length = 0
        slot.prefill_pos = 0
        slot.next_token = 0
        slot.generated = []
        slot.page_keys = []
        slot.cacheable = False
        slot.pages = []
        slot.idle = 0
        slot.state_src = -1

    def _seq_extra_blocks_resume(self, slot: _Slot) -> bool:
        """Recompute-style resume replays prompt+generated tokens, but
        sequence-aligned extra inputs (e.g. `frames`, axis 1 == prompt
        length) have no values for generated positions — once a slot with
        such extras has generated tokens, it cannot be preempted
        faithfully."""
        req = slot.request
        if not slot.generated or not req.extra:
            return False
        return self._has_seq_extras(slot)

    def _has_seq_extras(self, slot: _Slot) -> bool:
        req = slot.request
        if not req.extra:
            return False
        return any(k != "image_embeds" and np.ndim(v) >= 2
                   and np.shape(v)[1] == slot.prompt_len
                   for k, v in req.extra.items())

    def _pick_victim(self) -> int:
        """Choose which resident pays for pool pressure. "youngest"
        (highest request id) keeps FCFS progress guarantees;
        "longest-idle" evicts the slot with the most scheduler steps
        since its last emitted token (ties to youngest). Slots whose
        recompute resume would be lossy (sequence-aligned extras +
        generated tokens) are never evicted; if no clean victim exists
        the pool is genuinely too small for the workload."""
        ok = [i for i, s in enumerate(self.slots)
              if s.request is not None
              and not self._seq_extra_blocks_resume(s)]
        if not ok:
            raise RuntimeError(
                "KV page pool exhausted and every resident carries "
                "sequence-aligned extra inputs that cannot be "
                "re-prefilled after eviction; increase n_pages")
        if self.scfg.priority:
            # priority tiers ride on the victim hook: a latency-tier
            # resident is never reclaimed while ANY batch-tier resident
            # is a viable victim; victim_policy ranks within the tier
            batch_tier = [i for i in ok
                          if self.slots[i].request.priority != "latency"]
            if batch_tier:
                ok = batch_tier
        if self.scfg.victim_policy == "longest-idle":
            return max(ok, key=lambda i: (self.slots[i].idle,
                                          self.slots[i].request.request_id))
        return max(ok, key=lambda i: self.slots[i].request.request_id)

    def _drop_planned_chunks(self, v: int) -> None:
        """Un-plan slot v's pending prefill chunks (its eviction precedes
        their execution): roll its write frontier back to the first
        dropped chunk so the resume state never claims KV content that
        was never computed."""
        dropped_lo = None
        kept = []
        for ch in self._plan_chunks:
            if ch.slot == v:
                if dropped_lo is None:
                    dropped_lo = ch.lo
                if ch.state_ckpt >= 0:
                    # the chunk (hence its post-chunk checkpoint copy)
                    # will never execute — return the held entry
                    self.statepool.free(ch.state_ckpt)
            else:
                kept.append(ch)
        self._plan_chunks = kept
        if dropped_lo is not None:
            self.slots[v].prefill_pos = dropped_lo
            self.slots[v].length = dropped_lo
        self._completed.discard(v)

    def _reclaim_victim(self, v: int) -> None:
        """Evict slot v, preferring page-aligned swap-out (nothing is
        recomputed) and falling back to recompute preemption when the
        swap pool is absent/full or the slot carries sequence-aligned
        extras."""
        self._drop_planned_chunks(v)
        slot = self.slots[v]
        n_swap = pages_needed(slot.length, self.page)
        if (self.swap is not None and n_swap > 0
                and not self._has_seq_extras(slot)
                and self.swap.can_reserve(n_swap)):
            self._swap_out(v, n_swap)
        else:
            self._preempt(v)

    def _swap_out(self, v: int, n_swap: int) -> None:
        """Evict slot v by moving its device pages to the host swap pool:
        the request re-queues at the front with ALL its state preserved
        (cache content, position, generated tokens, rng) — re-admission
        swaps the pages back and resumes with zero re-prefill."""
        slot = self.slots[v]
        req = slot.request
        self.stats["preemptions"] += 1
        self.stats["swap_outs"] += 1
        self.swap.reserve(req.request_id, n_swap)
        self._swap_meta[req.request_id] = {
            "prompt_len": slot.prompt_len,
            "generated": list(slot.generated),
            "rng": slot.rng,
            "next_token": slot.next_token,
            "length": slot.length,
            "prefill_pos": slot.prefill_pos,
            "n_pages": n_swap,
            "page_keys": list(slot.page_keys),
            "cacheable": slot.cacheable,
        }
        self._plan_reclaims.append(Reclaim(
            kind="swap-out", slot=v, request_id=req.request_id,
            pages=tuple(int(p) for p in slot.pages[:n_swap]),
            state_page=slot.state_page))
        self._free_slot_pages(v)
        # the entry is freed NOW (plan time) and may be recycled by a
        # later checkpoint alloc in this same plan — safe because the
        # runner gathers swap-out state before any checkpoint copy
        self._free_slot_state(v)
        self.queue.appendleft(req)
        self._clear_slot(v)
        if self.telemetry is not None:
            self.telemetry.on_reclaim(req.request_id, "swap-out")
            self.telemetry.on_requeue(req.request_id)

    def _preempt(self, i: int) -> None:
        """Evict slot i recompute-style: free its pages and re-queue its
        request at the front (it keeps its request_id, hence its age
        priority). Tokens generated so far are appended to the prompt and
        re-prefilled on re-admission; the slot's sampling rng rides along
        so the continuation draws the same stream."""
        slot = self.slots[i]
        req = slot.request
        self.stats["preemptions"] += 1
        # the slot (not self._resume — _admit pops entries) carries the
        # ORIGINAL prompt length across resumes; only generated tokens
        # not yet folded into the prompt by an earlier preemption are
        # appended (tokens[prompt_len:] already replays those)
        prompt_len = slot.prompt_len
        already = int(req.tokens.size) - prompt_len
        if len(slot.generated) > already:
            req.tokens = np.concatenate(
                [req.tokens,
                 np.asarray(slot.generated[already:], np.int32)])
        self._resume[req.request_id] = {
            "prompt_len": prompt_len,
            "generated": list(slot.generated),
            "rng": slot.rng,
            "length": slot.length,
        }
        self._plan_reclaims.append(Reclaim(
            kind="recompute-preempt", slot=i, request_id=req.request_id))
        self._free_slot_pages(i)
        self._free_slot_state(i)
        self.queue.appendleft(req)
        self._clear_slot(i)
        if self.telemetry is not None:
            self.telemetry.on_reclaim(req.request_id, "recompute-preempt")
            self.telemetry.on_requeue(req.request_id)

    def _ensure_pages(self, i: int, upto: int, *, preempt: bool = True
                      ) -> bool:
        """Grow slot i's block table to cover `upto` tokens, allocating
        lazily from the shared pool. On exhaustion, reclaim in order:
        first evict LRU-cached pages (no resident loses work), then
        swap-out or recompute-preempt a victim and retry. Returns False
        iff slot i itself was the victim (the caller skips its work this
        step; the request is back in the queue)."""
        if not self.scfg.paged:
            return True
        need = pages_needed(upto, self.page)
        slot = self.slots[i]
        row = self.block_tables[i]
        while len(slot.pages) < need:
            page = self.allocator.alloc()
            if page is None:
                if self.prefix is not None and self.prefix.evict_one():
                    self._plan_reclaims.append(Reclaim(kind="lru-evict"))
                    if self.telemetry is not None and slot.request is not None:
                        # attributed to the request whose allocation forced
                        # the cached page out (nobody *loses* work)
                        self.telemetry.on_reclaim(
                            slot.request.request_id, "lru-evict")
                    continue
                if not preempt:
                    raise RuntimeError(
                        f"KV page pool exhausted "
                        f"({self.allocator.n_pages} pages in use)")
                victim = self._pick_victim()
                self._reclaim_victim(victim)
                if victim == i:
                    return False
                continue
            slot.pages.append(page)
            row[len(slot.pages) - 1] = page
        return True

    def _alloc_swap_in(self, n: int, rid: int = -1) -> list[int] | None:
        """Allocate the full page set a swap-in needs, evicting LRU pages
        but never preempting a resident (a swapped request waits rather
        than cascading evictions). None iff the pool cannot supply them —
        checked up front, so a known-failing attempt never drains the
        prefix index for zero progress (each LRU eviction drops its key
        forever, and the head-of-line wait retries every step)."""
        free = self.allocator.n_free + (self.allocator.n_lru
                                        if self.prefix is not None else 0)
        if n > free:
            return None
        got: list[int] = []
        while len(got) < n:
            page = self.allocator.alloc()
            if page is None:
                if self.prefix is not None and self.prefix.evict_one():
                    self._plan_reclaims.append(Reclaim(kind="lru-evict"))
                    if self.telemetry is not None and rid >= 0:
                        self.telemetry.on_reclaim(rid, "lru-evict")
                    continue
                for p in reversed(got):
                    self.allocator.free(p)
                return None
            got.append(page)
        return got

    # ------------------------------------------------------------------
    # prefix-cache internals
    # ------------------------------------------------------------------
    def _chain_keys(self, tokens: np.ndarray, n_full: int,
                    prev: bytes = b""):
        """Yield chained content keys for `tokens`' first `n_full` full
        pages, continuing the chain from `prev`. Lazy: a consumer that
        stops at the first index miss never pays for hashing the rest of
        a long prompt."""
        for j in range(n_full):
            chunk = np.ascontiguousarray(
                tokens[j * self.page:(j + 1) * self.page], np.int32)
            prev = chain_hash(prev, chunk.tobytes())
            yield prev

    def _match_prefix(self, i: int, slot: _Slot, req: Request) -> None:
        """Map the longest cached page-aligned prefix of `req` into slot
        i's block table and start prefill at the matched boundary. Host-
        side metadata only (block table + refcounts) — the pages' KV
        content is already on device. At least one token is always left
        to prefill: sampling the first generated token needs real last-
        position logits, so a fully-cached prompt recomputes its tail."""
        n_full = (int(req.tokens.size) - 1) // self.page
        if n_full <= 0 or len(self.prefix) == 0:
            return
        pages, keys = [], []
        for key in self._chain_keys(req.tokens, n_full):
            page = self.prefix.lookup(key)
            if page is None:
                break
            pages.append(page)
            keys.append(key)
        if pages and self.statepool is not None:
            # a stateful model can only resume from a boundary whose
            # recurrent-state checkpoint survives: cap the match at the
            # DEEPEST checkpointed boundary of the matched chain (KV
            # pages beyond it are released — their state is gone)
            best, src = 0, -1
            for j in range(len(pages), 0, -1):
                entry = self.statepool.peek(keys[j - 1])
                if entry is not None:
                    best, src = j, entry
                    break
            if best < len(pages):
                self.stats["state_misses"] += 1
            for page in reversed(pages[best:]):
                self.allocator.free(int(page))
            pages, keys = pages[:best], keys[:best]
            if pages:
                self.statepool.lookup(keys[-1])   # stats + LRU recency
                slot.state_src = src
                self._plan_state_pins.add(src)
            else:
                self.statepool.misses += 1
        if not pages:
            return
        k = len(pages)
        self.block_tables[i, :k] = pages
        slot.pages = [int(p) for p in pages]
        slot.page_keys = keys
        slot.prefill_pos = slot.length = k * self.page
        self.stats["cached_tokens"] += k * self.page

    def _cache_tokens(self, slot: _Slot) -> np.ndarray:
        """The tokens actually written to slot's cache rows [0, length):
        the request's tokens then any generated tokens beyond them (a
        resumed request's `tokens` already contains the replayed ones)."""
        req = slot.request
        replayed = int(req.tokens.size) - slot.prompt_len
        seq = req.tokens
        new = slot.generated[replayed:]
        if new:
            seq = np.concatenate([seq, np.asarray(new, np.int32)])
        return seq[:slot.length]

    def _register_full_pages(self, i: int, slot: _Slot) -> None:
        """Publish every newly COMPLETED page of slot i in the prefix
        index. Only full pages are ever registered — the partially-filled
        tail page stays private, so no registered (shareable) page is ever
        scattered into again: immutability by construction, and the
        copy-on-write boundary is always page-aligned."""
        if self.prefix is None or not slot.cacheable:
            return
        n_full = slot.length // self.page
        done = len(slot.page_keys)
        if n_full <= done:
            return
        seq = self._cache_tokens(slot)
        row = self.block_tables[i]
        prev = slot.page_keys[-1] if slot.page_keys else b""
        keys = self._chain_keys(seq[done * self.page:], n_full - done, prev)
        for j, key in enumerate(keys, start=done):
            self.prefix.register(key, int(row[j]))
            slot.page_keys.append(key)

    def _register_state_ckpt(self, ch: PrefillChunk, slot: _Slot) -> None:
        """Publish a chunk's executed state checkpoint under the chained
        key of its page-aligned frontier (the runner already copied the
        live entry into `ch.state_ckpt`). First-writer-wins like the page
        index; a duplicate (or an uncacheable slot) frees the entry."""
        kidx = ch.hi // self.page - 1
        key = (slot.page_keys[kidx]
               if slot.cacheable and 0 <= kidx < len(slot.page_keys)
               else None)
        if key is not None and self.statepool.register(key, ch.state_ckpt):
            self.stats["state_ckpts"] += 1
        else:
            self.statepool.free(ch.state_ckpt)

    # ------------------------------------------------------------------
    # admission internals
    # ------------------------------------------------------------------
    def _admit(self, i: int, req: Request) -> None:
        """Bind `req` to slot i. Metadata only — prefill happens one chunk
        per step, written in place into the slot's rows of the shared
        cache (no per-admission cache allocation or copy-back). A
        recompute-preempted request restores its generation state (its
        re-extended prompt replays the tokens already emitted)."""
        slot = self.slots[i]
        slot.request = req
        slot.length = 0
        slot.prefill_pos = 0
        slot.idle = 0
        entry = self._resume.pop(req.request_id, None)
        if entry is not None:
            slot.prompt_len = entry["prompt_len"]
            slot.generated = list(entry["generated"])
            slot.rng = entry["rng"]
        else:
            slot.prompt_len = int(req.tokens.size)
            slot.generated = []
            slot.rng = np.random.default_rng(req.sampling.seed)
        slot.page_keys = []
        # KV pages are content-addressed by TOKENS alone; per-request extra
        # inputs (images, frames) also shape the KV, so such requests
        # neither publish nor consume shared pages
        slot.cacheable = self.prefix is not None and not req.extra
        if slot.cacheable:
            self._match_prefix(i, slot, req)
        if self.statepool is not None:
            # live entry AFTER the match (its alloc must not evict the
            # pinned restore source). Guaranteed to succeed: held entries
            # never exceed batch_slots live + this plan's pins, and
            # validate.py sizes the pool above that.
            slot.state_page = self._alloc_state_entry()
            self.state_tables[i] = slot.state_page
            if slot.state_src >= 0:
                self.stats["state_restores"] += 1
                if self.telemetry is not None:
                    self.telemetry.on_state_restore(req.request_id)
        if entry is not None:
            # the tokens this resume will prefill AGAIN (they were already
            # computed once, then thrown away by recompute preemption) —
            # the cost swap-out preemption exists to avoid
            self.stats["replayed_tokens"] += max(
                0, entry.get("length", 0) - slot.prefill_pos)

    def _admit_swapped(self, i: int, req: Request, pages: list[int]
                       ) -> SwapIn:
        """Bind a swapped-out request to slot i, mapping freshly allocated
        device pages into its block table; the runner restores the pages'
        content from the swap pool and the slot resumes at its preserved
        position — no token is ever re-prefilled. The restored pages are
        private copies: they are never re-registered in (and so never
        alias) the prefix index."""
        entry = self._swap_meta.pop(req.request_id)
        self.swap.release(req.request_id)
        slot = self.slots[i]
        slot.request = req
        slot.length = entry["length"]
        slot.prefill_pos = entry["prefill_pos"]
        slot.next_token = entry["next_token"]
        slot.generated = list(entry["generated"])
        slot.rng = entry["rng"]
        slot.prompt_len = entry["prompt_len"]
        slot.page_keys = list(entry["page_keys"])
        slot.cacheable = entry["cacheable"]
        slot.pages = list(pages)
        slot.idle = 0
        self.block_tables[i, :] = -1
        self.block_tables[i, :len(pages)] = pages
        if self.statepool is not None:
            slot.state_page = self._alloc_state_entry()
            self.state_tables[i] = slot.state_page
        self.stats["swap_ins"] += 1
        self.stats["swapped_tokens"] += entry["length"]
        if self.telemetry is not None:
            self.telemetry.on_swapped_tokens(req.request_id,
                                             entry["length"])
        return SwapIn(slot=i, request_id=req.request_id,
                      pages=tuple(int(p) for p in pages),
                      length=entry["length"], state_page=slot.state_page)

    def _alloc_state_entry(self) -> int:
        entry = self._state_alloc(evict_skip=self._plan_state_pins)
        if entry is None:
            raise RuntimeError(
                "state pool exhausted allocating a live entry — "
                "state_pages is undersized for batch_slots "
                "(validate.py should have rejected this config)")
        return entry

    # ------------------------------------------------------------------
    # lockstep / maintenance hooks (engine facade)
    # ------------------------------------------------------------------
    def lockstep_alloc(self, i: int, upto: int) -> None:
        """Strict allocation for the hand-driven lockstep API: all pages
        or RuntimeError — lockstep never preempts."""
        self._ensure_pages(i, upto, preempt=False)
        if self.statepool is not None and self.slots[i].state_page < 0:
            self.slots[i].state_page = self._alloc_state_entry()
            self.state_tables[i] = self.slots[i].state_page

    def reset_for_lockstep(self) -> None:
        """Drop every resident's scheduler state (the lockstep prefill
        contract): pool, prefix index, swap reservations and resume
        entries are all rebuilt/cleared — stale state must never leak
        into the next occupants."""
        if self.scfg.paged:
            self.allocator = BlockAllocator(self.n_pages, self.page)
            if self.prefix is not None:
                # the pool (and its contents) was just reset: every index
                # entry points at dead content
                self.prefix = PrefixCache(self.allocator)
            if self.swap is not None:
                self.swap.clear()
            self.block_tables[:] = -1
        if self.statepool is not None:
            # entry contents are dead with the rest of the caches
            self.statepool = StatePool(self.n_state_pages)
            self.state_tables[:] = -1
        self._resume.clear()
        self._swap_meta.clear()
        for slot in self.slots:
            slot.request = None
            slot.next_token = 0
            slot.generated = []
            slot.rng = None
            slot.prompt_len = 0
            slot.page_keys = []
            slot.cacheable = False
            slot.pages = []
            slot.idle = 0
            slot.state_page = -1
            slot.state_src = -1

    def reset_stats(self) -> None:
        """Zero the counters in place (the registry is shared with the
        runner and the engine facade); histograms clear alongside the
        scalars. `max_residents` is a watermark, not a counter: it
        restarts at the CURRENT resident count (mirroring
        `reset_watermark`'s in-use baseline) — zeroing it mid-flight
        under-reported until the next step."""
        self.stats.reset()
        self.stats["max_residents"] = sum(s.request is not None
                                          for s in self.slots)
        if self.allocator is not None:
            self.allocator.reset_watermark()
        if self.prefix is not None:
            self.prefix.reset_stats()
        if self.swap is not None:
            self.swap.reset_watermark()
        if self.statepool is not None:
            self.statepool.reset_stats()

    @property
    def lengths(self) -> np.ndarray:
        """Per-slot valid cache lengths, int32 (kernel dtype)."""
        return np.array([s.length for s in self.slots], np.int32)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def watermarks(self) -> dict:
        """Current pool occupancies as one flat JSON-able dict — the
        `pool` field of every flight-recorder step event."""
        out: dict[str, int] = {
            "residents": sum(s.request is not None for s in self.slots),
            "queued": len(self.queue),
        }
        if self.allocator is not None:
            out.update(pages_in_use=self.allocator.in_use,
                       pages_lru=self.allocator.n_lru,
                       pages_free=self.allocator.n_free)
        if self.prefix is not None:
            out["prefix_keys"] = len(self.prefix)
        if self.swap is not None:
            out.update(swap_in_use=self.swap.in_use,
                       swap_free=self.swap.n_free)
        if self.statepool is not None:
            out.update(state_held=self.statepool.n_held,
                       state_ckpt=self.statepool.n_ckpt,
                       state_free=self.statepool.n_free)
        return out

    def check(self) -> None:
        """Run every pool invariant check plus the slot <-> block-table
        cross-checks in one call (the Engine's debug probe; AssertionError
        on any accounting corruption)."""
        if self.allocator is not None:
            self.allocator.check()
        if self.swap is not None:
            self.swap.check()
        if self.statepool is not None:
            self.statepool.check()
        for i, slot in enumerate(self.slots):
            if self.block_tables is not None:
                row = self.block_tables[i]
                k = len(slot.pages)
                assert list(row[:k]) == [int(p) for p in slot.pages], (
                    f"slot {i}: block-table row {row[:k].tolist()} != "
                    f"pages {slot.pages}")
                assert (row[k:] == -1).all(), (
                    f"slot {i}: stale block-table entries past "
                    f"{k} pages: {row.tolist()}")
                for p in slot.pages:
                    assert self.allocator.refcount(int(p)) >= 1, (
                        f"slot {i}: mapped page {p} has refcount 0")
                if slot.request is not None:
                    assert len(slot.pages) >= pages_needed(
                        slot.length, self.page), (
                        f"slot {i}: {len(slot.pages)} pages cannot hold "
                        f"length {slot.length}")
            if self.state_tables is not None:
                assert int(self.state_tables[i]) == slot.state_page, (
                    f"slot {i}: state table {self.state_tables[i]} != "
                    f"slot entry {slot.state_page}")
        if self.swap is not None:
            for rid in self._swap_meta:
                assert self.swap.holds(rid), (
                    f"swapped request {rid} has no swap reservation")
