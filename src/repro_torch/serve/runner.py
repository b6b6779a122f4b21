"""Serving execution layer: the ModelRunner (torch twin of
``repro.serve.runner``).

The runner owns the model, the KV page pools and sampling, and nothing
else. Each step it executes exactly the frozen SchedulePlan the Scheduler
handed it and returns the per-slot sampled tokens; all bookkeeping driven
by those tokens happens back in `Scheduler.commit`.

Execution order within one plan (as in the JAX runner):

  1. swap-in scatters, 2. swap-out gathers, 3. admission state init --
     none of which this slice runs: swap preemption and pooled SSM/cross
     state are rejected when the engine is built;
  4. prefill chunks, in plan order, sampling each completed prompt's
     first token from the chunk's last-valid logits;
  5. one batched ragged decode over the plan's decode set (minus slots
     whose just-sampled first token hit eos).

`execute(plan)` is `wait(execute_async(plan))`: the decode logits stay on
the device until `wait()` copies them to the host and samples.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import hamming
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serve.paged import pages_needed
from repro_torch.serve.scheduler import SamplingParams, SchedulePlan, ServeConfig
from repro_torch.serve.telemetry import SERVE_COUNTERS, MetricsRegistry
from repro_torch.serve.validate import validate_serve_features


def resolve_device(device) -> torch.device:
    """The device to serve on; "cuda" without a card raises (no fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: repro_torch serves on the GPU by "
            "default; pass device='cpu' (CLI: --device cpu) to run the "
            "kernels' plain versions on the CPU")
    return dev


def check_serve_supported(cfg: ModelConfig, scfg: ServeConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for anything
    this slice of the port does not serve."""
    T.check_supported(cfg)
    missing = [
        (not scfg.binary, "the full-precision baseline (binary=False)"),
        (scfg.swap_pages > 0, "swap-out preemption (swap_pages > 0)"),
        (scfg.mesh is not None, "tensor-parallel serving (mesh)"),
    ]
    for hit, what in missing:
        if hit:
            raise NotImplementedError(
                f"repro_torch does not serve {what} yet: see ROADMAP.md "
                f"queue 1, 'Still to port'")


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
    tokens are final, decode logits are still on the device."""
    results: dict[int, list[int]]
    entries: list                      # decode entries pending sampling
    logits: Any = None                 # un-synced decode logits, or None


class ModelRunner:
    """Device-state owner and plan executor for one serving engine."""

    def __init__(self, cfg: ModelConfig, model: T.Transformer,
                 scfg: ServeConfig, stats: dict, *, device="cuda"):
        self.device = resolve_device(device)
        validate_serve_features(cfg.layer_pattern, scfg)
        check_serve_supported(cfg, scfg)
        self.cfg = cfg
        self.model = model.to(self.device)
        self.scfg = scfg
        self.stats = MetricsRegistry.adopt(stats)
        self.stats.declare_counters(SERVE_COUNTERS)
        self.telemetry = None
        self.n = scfg.topn if scfg.topn is not None else cfg.had.topn(scfg.max_len)
        self.chunk = max(1, min(scfg.prefill_chunk, scfg.max_len))
        self.page = scfg.page_size
        self.n_pages = 0
        if scfg.paged:
            self.n_pages = (scfg.n_pages if scfg.n_pages is not None
                            else scfg.batch_slots
                            * pages_needed(scfg.max_len, self.page))
            # decode HBM traffic model (host-side, per attention layer x
            # kv-head): bytes of one page of packed K bit-planes and of V
            elem = torch.empty((), dtype=cfg.dtype).element_size()
            self._page_v_bytes = self.page * cfg.dh * elem
            self._page_k_bytes = hamming.packed_words(cfg.dh) * 4 * self.page
            self._attn_rows = cfg.n_layers * cfg.n_kv_heads
        self.caches = T.init_caches(
            cfg, paged=scfg.paged, batch=scfg.batch_slots,
            max_len=scfg.max_len, n_pages=self.n_pages, page_size=self.page,
            device=self.device)

    def sync(self) -> None:
        """Block until every queued device write has landed (the fence
        behind `Telemetry(fence=True)`)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dev(self, arr, dtype) -> torch.Tensor | None:
        if arr is None:             # the dense cache's block tables
            return None
        return torch.from_numpy(np.asarray(arr, dtype)).to(self.device)

    # ------------------------------------------------------------------
    # low-level steps
    # ------------------------------------------------------------------
    def prefill_step(self, tokens: np.ndarray, pos: np.ndarray,
                     active: np.ndarray, n_valid: np.ndarray,
                     block_tables: np.ndarray | None) -> torch.Tensor:
        """One padded prefill chunk: tokens [B, chunk] zero-padded, per-row
        pos/active/n_valid masks. Returns last-valid logits [B, 1, V]."""
        logits = T.serve_step(
            self.model, self._dev(tokens, np.int64), self.caches,
            pos=self._dev(pos, np.int32), n=self.n,
            block_tables=self._dev(block_tables, np.int32),
            active=self._dev(active, bool),
            n_valid=self._dev(n_valid, np.int32), logits_mode="last")
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_tokens"] += int(np.asarray(n_valid).sum())
        return logits

    def decode_step(self, tokens: np.ndarray, pos: np.ndarray,
                    active: np.ndarray,
                    block_tables: np.ndarray | None) -> torch.Tensor:
        """One batched ragged decode step; returns logits [B, 1, V]."""
        logits = T.serve_step(
            self.model, self._dev(tokens, np.int64)[:, None], self.caches,
            pos=self._dev(pos, np.int32), n=self.n,
            block_tables=self._dev(block_tables, np.int32),
            active=self._dev(active, bool), page_topn=self.scfg.page_topn,
            logits_mode="last")
        if self.scfg.paged:
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

    def execute_async(self, plan: SchedulePlan) -> _PendingStep:
        """Dispatch one plan; the decode logits are not copied back."""
        if plan.swap_ins or any(rc.kind == "swap-out"
                                for rc in plan.reclaims):
            raise NotImplementedError("swap transfers are not ported")
        results: dict[int, list[int]] = collections.defaultdict(list)
        b = self.scfg.batch_slots
        vocab = self.cfg.vocab_size
        sampled: dict[int, int] = {}
        eos_hit: set[int] = set()
        for ch in plan.prefill:
            req = ch.request
            if req.extra:
                raise NotImplementedError(
                    "per-request extra model inputs (frontends) are not "
                    "ported: ROADMAP queue 1, 'Still to port'")
            nv = ch.hi - ch.lo
            tokens = np.zeros((b, self.chunk), np.int32)
            tokens[ch.slot, :nv] = req.tokens[ch.lo:ch.hi]
            active = np.zeros((b,), bool)
            active[ch.slot] = True
            n_valid = np.zeros((b,), np.int32)
            n_valid[ch.slot] = nv
            logits = self.prefill_step(tokens, np.asarray(ch.pos, np.int32),
                                       active, n_valid, plan.block_tables)
            if self.telemetry is not None:
                self.telemetry.on_chunk(req.request_id)
            if ch.samples:
                row = logits[ch.slot, 0, :vocab].cpu().numpy()
                tok = _sample_token(row, req.sampling, ch.rng)
                sampled[ch.slot] = tok
                results[ch.slot].append(tok)
                if ch.eos_token is not None and tok == ch.eos_token:
                    eos_hit.add(ch.slot)
        entries = [e for e in plan.decode if e.slot not in eos_hit]
        logits = None
        if entries:
            tokens = np.zeros((b,), np.int32)
            active = np.zeros((b,), bool)
            for e in entries:
                tokens[e.slot] = (sampled[e.slot] if e.token is None
                                  else e.token)
                active[e.slot] = True
            logits = self.decode_step(tokens,
                                      np.asarray(plan.decode_pos, np.int32),
                                      active, plan.block_tables)
            self.stats["decode_steps"] += 1
        return _PendingStep(results=dict(results), entries=entries,
                            logits=logits)

    def wait(self, pending: _PendingStep) -> dict[int, list[int]]:
        """The host sync for one dispatched step: copy the decode logits
        to the host and draw the decode tokens in plan entry order."""
        if pending.logits is not None:
            vocab = self.cfg.vocab_size
            rows = pending.logits[:, 0, :vocab].cpu().numpy()
            for e in pending.entries:
                tok = _sample_token(rows[e.slot], e.sampling, e.rng)
                pending.results.setdefault(e.slot, []).append(tok)
            pending.logits = None
        return pending.results
