#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the repository root, one GPU

Builds the hand-written CUDA kernels from the sources in this checkout and
runs twelve phases; any failure exits non-zero before the result line.

1. The card (nvidia-smi name and power limit), torch/CUDA versions, and
   the kernel build time (one nvcc per source, started together).
2. Each of the five kernels against its plain PyTorch version on the
   card, at the shapes the serving path gives it (smollm-135m: d = 64 ->
   2 words, 9 heads, 3 kv heads, 16-token pages, bf16 V, 4 slots,
   4096-token tables and caches, 512-token prefill chunks; the score
   matrix at q [3, 1536, 2] x k [3, 4096, 2]), with ragged lengths, a
   partially valid query tile, idle rows (q_length 0), -1 table entries,
   shuffled pages and count-0 blocks. Float outputs allclose at atol
   1e-5, rtol 1e-4 (the kernels sum in another order); integers (page
   bounds, scores) exactly; the dense-cache decode equal bit for bit to
   the paged decode of the same tokens. Prints error, kernel and plain
   times (CUDA events), the bound (least time the card could take for the
   same work) and, where one PyTorch call computes the same function, its
   time, and the host time of one call (the wrapper's enqueue on an idle
   stream). K1 is also timed at 4- and 8-tile splits, K2 and K4 at 2, 4
   and 8 (K4 must give the same bits at 1, 2, 4 and 8); K5's two methods
   get a record each. K3 (fused page bounds + selection + compaction:
   bounds, tables, counts and logical ids exact, on four length and key
   sets at n_sel 64, 255 and 256) and K5, whose device time is near the
   host time of a call, are timed by device time, 200 calls replayed from
   one CUDA graph (back-to-back event time beside it); K3 also beside the
   design it replaced, the bounds-only kernel and then ops.select_pages on
   the card. Each bound prices a kind of operation at its own
   peak: integer and float32 work on the CUDA cores, K1's E.V (three bf16
   products a multiply-add) at the bf16 tensor-core rate, K5 int8 at the
   int8 tensor-core rate. One more line times the full-precision
   baseline's attention (``core.attention.standard_attention``, no
   kernel of its own) against ``F.scaled_dot_product_attention`` at a
   decode step and a 512-query prefill chunk; it is not a kernel record.
   Then six more records at llama-3.2-vision-11b's serving shapes (d =
   128 -> 4 words, 32 heads over 8 kv heads, bf16 V of width 128, top-N
   479; phase 6's path): K1 causal over a 4096-position table, K1
   non-causal over the 1601 image keys of a cross layer (every query of
   every slot live), K2 at ~2k-token rows, K3 on K2's pools (exact at
   n_sel 64 and 255), K4 over the 1601-key cross cache and K4 over a
   dense engine's 4097-position self-attention cache at K2's lengths;
   the two cross kernels are also checked at nsel 2000 > T. Then four at
   dbrx-132b's (48 heads over 8 kv heads: G 6; phase 8's path): K1
   causal, K2, K3 (exact at n_sel 64 and 255) and K4 over the dense
   self-attention cache, the same cases as vision's.
3. Cross-device: smollm-135m widths at 2 layers in float32, the same
   seeded weights on the CPU (plain versions) and on the card (kernels):
   first-step logits allclose (atol 2e-3, rtol 2e-3: float32 sums in
   another order through two layers, where a key's sign bit can flip)
   and equal greedy tokens, on the paged cache, the dense cache and with
   page-sparse decode, and on the full-precision paged and dense caches.
   Then, on the card, the CUDA-graph step against the eager step
   (``Engine(eager=True)``): logits of a prefill + decode sequence and
   greedy tokens equal bit for bit, binary and full precision, paged,
   dense and page-sparse. Then the same at llama-3.2-vision-11b's widths:
   one AAAAC group, float32, the vocabulary cut to 16384, one image
   request and one text-only request; binary paths compared on the
   card's packed bits (`bits_tape`: float32 rounding flips a few sign
   bits of near-zero values between the devices at these widths, which
   alone moves logits far past the tolerance), paged with pooled cross
   state and dense, binary and fp, graph == eager bit for bit. Then the
   same on reduced jamba-1.5-large-398b (one MMMMAMMM group, MoE FFNs at
   every second position, d 64, float32, text only): SSM state pooled or
   in dense rows.
4. The slice at full size: smollm-135m, all 30 layers, bf16, seeded
   random weights, prefill chunks of 512, 4 slots, 8 staggered requests
   with 512-3072-token prompts and 32 new tokens each, max_len 4096
   (top-N = 479), run four times: paged (16-token pages, 256-entry
   tables), dense cache, page-sparse with page_topn 255 (every resident
   page kept) and page_topn 64; the same four on the full-precision
   baseline (``binary=False``); then `ops.hamming_scores` at the phase-2
   shapes, each method on its own. Every step of a run replays one of
   its engine's two CUDA graphs (prefill chunk, decode step), and each
   engine must hold exactly 2. Launch counts are zeroed just before each
   run and read just after, replays counted; every kernel of a run's path
   must run 30 times a step (a chunk for the prefill kernel, a decode step
   for the decode and page-score kernels; an op call counts once, whatever
   CUDA launches it makes), and the full-precision runs launch none. The
   dense and page_topn-255 tokens must equal the paged run's, on each
   path; page_topn 64 must attend fewer pages. Two more binary runs are
   not counted: page_topn 64 with the unfused selection must attend the
   same pages and give the same tokens, and paged with the eager step
   must give the same tokens as the graphed one.
5. The serving surface at full size, phase 4's weights and workload, each
   run under phase 4's launch rule and graph count, its tokens equal to
   phase 4's paged (or full-precision paged) run: (a) swap-out preemption
   over an overcommitted pool (384 pages, a 1024-page host pool), binary
   and full precision, which must swap, recompute nothing and drain both
   pools, with the host ms of steps that swap against those that do not
   and the transfer time of a 171-page victim, then recompute
   preemption on that pool (tokens reported, not checked); (b) sync against
   pipelined stepping (`step_pipelined`) on one engine, S P P S, with
   tok/s, ITL, TTFT and the overlap fraction; (c) the asyncio front end
   (`AsyncEngine`) from a fresh engine's first step, streamed tokens equal
   to the results, then warm beside the pipelined and the sync step.
6. llama-3.2-vision-11b as published (40 layers, 8 of them cross
   attention, bf16, 9.78 B parameters drawn on the card from seed 0),
   4 slots, 512-token chunks, 16-token pages, max_len 4096, 8 requests
   of 512-2048 tokens arriving as in phase 4, images [1, 1601, 1280] on
   requests 0, 2, 4 and 6, 16 new tokens each: paged (cross caches in a
   pooled state allocation), dense, page_topn 255, fp paged and a
   200-page pool with a host pool (swap-out preemption). Each engine
   holds 2 graphs; K1 runs 40 times a chunk (8 of them non-causal), a
   paged decode step K2 32 and K4 8 times (K3 32 with page_topn), a
   dense step K4 40 (8 tagged cross), fp none, as the wrappers count;
   dense, page_topn-255 and swap tokens equal paged's bit for bit; every
   swap moves the victim's state entry; every pool drains.
7. mamba2-130m as published (24 SSM layers, d 768, state 128, bf16,
   seeded weights drawn on the card), phase 4's workload, HAD off (no
   attention): paged (pooled SSM state), dense, a 384-page pool with a
   host pool (each swap-out moves the victim's state entry), the same
   pool without one (recompute), each with 2 graphs and no kernel
   launch, tokens equal paged's; then 4 requests sharing a 1024-token
   prefix one at a time, warm (pages and a state checkpoint restored,
   state_restores > 0) equal to cold.
8. dbrx-132b at full width and 8 of its 40 layers (16 experts top-4,
   27.3 B parameters drawn on the card after phase 6's model is freed),
   phase 6's prompts without images: paged (K1 + K2), dense (K1 + K4),
   page_topn 255 (K3 + K2) and fp paged, each with 2 graphs and the
   launch rule; dense and page_topn-255 tokens equal paged's.
9. HAD distillation and training (no kernel of its own: the JAX package
   trains through no Pallas kernel), after phase 8's model is freed:
   (a) reduced smollm-135m widths in float32, CPU against card: one
   pretrain step and one distill step in each of the four stages from
   the same seeded teacher and batch, metrics and every updated leaf
   allclose; (b) bert-base-had as published (12 layers, context 256, N
   30): a teacher fitted to `classification_task`, Eq. 12 sigmas, then
   `tiny_schedule(5)` through all four stages at batch 16 (stage, c and
   the attention-KL switch checked at each step; step ms, tokens/s, peak
   memory, and the had_eval student's accuracy beside the teacher's);
   (c) deit-t as published through `frames` (197 patches of width 192):
   five distill steps; (d) smollm-135m as published (30 layers, bf16,
   remat): Eq. 12 sigmas, ten distill steps at seq 2048, batch 4 through
   all four stages (step ms, tokens/s, peak memory under 10 GiB, the
   device's busy share of one more step from torch.profiler), then the
   distilled student served on the binary paged engine under phase 4's
   launch rule with 2 graphs (4 requests), its tokens equal to an engine
   over the student rebuilt from its saved checkpoint.

10. The paper's long-context shapes, after phase 9: K1 at smollm-135m's
   prefill_32k shape at the dry-run cell's batch 4 (36 query rows over
   12 kv rows, S = 32768 over the 32769-position dense cache, N 3834),
   one call in 36 waves within K1's 2 GiB scratch budget, held against
   the plain version window by window (512 queries each, phase 2's
   tolerances); K4 at decode_32k (384 rows x 32769 positions) and
   long_500k (3 rows x 524289, also at ragged lengths) against the plain
   version; each a kernel record whose bound counts this run's kept
   keys. Then the one-card dry run
   (`repro_torch.launch.dryrun.run_cell`) of smollm-135m's four cells on
   the card: decode_32k at batch 128 and long_500k at 1 (the fit rule's
   batches), prefill_32k and train_4k cut to batch 4 and 2 for time
   (`DRYRUN_BATCH`, each cut printed), every cell "ok" with a finite
   output, its peak memory, step time, roofline terms, mfu and
   hbm_share, and K4 (decode) launched 2 x 30 times in it (the counted
   and the timed step), K1 (prefill) 2 x 30 x its 36 waves a call
   (these are the three records' launches); the meta records of the ten
   assigned archs (none an error, the three largest fitting no cell);
   and the counted flops and bytes of a reduced binary serve step, equal
   on the CPU and the card.
11. Tensor-parallel serving, after phase 10: smollm-135m as published at
   tp 3, three ranks spawned on the one card (``launch.mesh.spawn``,
   gloo, every rank on cuda:0, the eager step; each launches K1-K4 on
   its one kv head), phase 4's weights (saved once by this process after
   phase 5, loaded by each rank) and workload: paged (K1 + K2), dense (K1
   + K4), page_topn 64 (K3 + K2), fp paged with page_topn 64 (the
   per-slot page-score max over the ranks) and phase 5's 384-page swap
   pool. First, on this process: a rank's wq / wk / wv columns and its
   lm_head vocabulary slice equal the full products' bit for bit at phase
   4's shapes (the serving step's blocked lm_head GEMMs; the one-GEMM
   product is logged beside), and the four kernels' records at a rank's
   shapes (3 query heads over 1 kv head, G 3, d 64; K3 timed at n_sel
   64). Then every run's token digest equals its single-rank run's of
   phase 4 (swap: phase 4's paged, as phase 5's), per-rank cache bytes x
   3 equal the total, every rank follows phase 4's launch rule, and the
   host ms of prefill and decode steps, tok/s and the collectives staged
   through host memory are printed beside the card. A rank that fails or
   outlasts TP_TIMEOUT_S fails the phase.
12. The examples and the production mesh. (b) runs in a subprocess
   started after phase 11, beside (a) and (c): ``python -m
   repro_torch.launch.dryrun --all --mesh both --device meta``, the ten
   assigned archs x four shapes priced per chip on 16x16 and 2x16x16: 80
   records, none an error, printed as the markdown table. K1-K4 against
   their plain versions at the long-context example's shapes (4 query
   heads over 2 kv heads, d 32, float32 V, top-N 61; 128-query chunks
   over a 525-position dense cache, 2 slots over 9 pages of 64; K3 exact
   at n_sel 4 and 9): four kernel records whose launches are the five
   long-context runs' below. (a) The three examples' PyTorch twins on
   the card at the JAX examples' sizes, each checking itself:
   ``torch_quickstart``; ``torch_long_context_serve`` with no flag,
   --paged, --prefix-cache, --swap-pages 16 and --page-topn 4 (the
   launch counts zeroed just before each run and read after it: K1 and
   K4 in every run (the sequential check serves the dense cache), K2 in
   the paged ones, K3 in the page-topn one; each run's tokens' sha1);
   and ``torch_distill_encoder`` in full (400 teacher steps, 40 a stage),
   the teacher's and the student's accuracies; wall times of each. (a')
   That example's teacher once more on the card and on the CPU from the
   same seeds, and the card's teacher distilled on both (the CPU's on the
   CPU), every step's loss recorded: where the runs part, in which
   stage, and every accuracy. (c) smollm-135m's train_4k
   dry-run cell on the card at phase 10's batch (2), the distill
   attention in float32 and in bfloat16 (``--attn-dtype``): step s, peak
   memory, a finite loss (with ``--profile``, one more step of each
   profiled: kernel time by group, `_busy_share`).

`--profile DIR` profiles the prefill of one 3072-token prompt and decode
windows of the paged, the dense, the full-precision paged and the
page_topn-64 engine (the last unfused and fused in turn), all graphed,
after phase 5; a prefill and a decode window of phase 6's paged vision
engine; a decode window each of phase 7's and phase 8's paged
engines; and one train_4k step each of phase 12 (c), float32 and bf16
(kernel time by group, printed).
Then the kernel record line and, last, the result line.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

try:    # H100 SXM published peaks (NVIDIA data sheet), dense, at 700 W
    from repro_torch.launch.roofline import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.launch.roofline import \
        PEAK_FLOPS as BF16_TENSOR_OPS_PER_S
    from repro_torch.launch.roofline import \
        PEAK_FP32_FLOPS as CUDA_CORE_OPS_PER_S   # outside the tensor cores
    from repro_torch.launch.roofline import \
        PEAK_INT8_OPS as INT8_TENSOR_OPS_PER_S
except ImportError:     # no checkout (or no torch) here: main() says which
    pass
TOL = dict(atol=1e-5, rtol=1e-4)
K5_INT8 = "hamming_score_int8"     # K5's int8 method's own record
CROSS_TOL = dict(atol=2e-3, rtol=2e-3)
VISION = "llama-3.2-vision-11b"
# phase 2's records at the vision model's serving shapes (phase 6's path)
K1_VISION = "binary_prefill_attention[vision causal]"
K1_CROSS = "binary_prefill_attention[vision cross]"
K2_VISION = "binary_paged_decode_attention[vision]"
K3_VISION = "binary_page_score[vision]"
K4_CROSS = "binary_decode_attention[vision cross]"
K4_VISION = "binary_decode_attention[vision self]"
DBRX = "dbrx-132b"
# phase 2's records at dbrx-132b's serving shapes (phase 8's path)
K1_DBRX = "binary_prefill_attention[dbrx causal]"
K2_DBRX = "binary_paged_decode_attention[dbrx]"
K3_DBRX = "binary_page_score[dbrx]"
K4_DBRX = "binary_decode_attention[dbrx self]"
MAMBA = "mamba2-130m"
JAMBA = "jamba-1.5-large-398b"
# phase 12's records: the kernels at examples/torch_long_context_serve.py's
# shapes
K1_EX = "binary_prefill_attention[long-context example]"
K2_EX = "binary_paged_decode_attention[long-context example]"
K3_EX = "binary_page_score[long-context example]"
K4_EX = "binary_decode_attention[long-context example]"
TF32_TENSOR_OPS_PER_S = 495e12    # H100 SXM data sheet, dense, at 700 W
# phase 11's records: the kernels at a tensor-parallel rank's shapes
K1_TP = "binary_prefill_attention[smollm tp3 rank]"
K2_TP = "binary_paged_decode_attention[smollm tp3 rank]"
K3_TP = "binary_page_score[smollm tp3 rank]"
K4_TP = "binary_decode_attention[smollm tp3 rank]"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 20) -> float:
    """Host time of one call in microseconds: `calls` calls enqueued on an
    idle stream, few enough that none waits for the device."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def device_ms(fn, iters: int = 200) -> float:
    """Device time of one call: `iters` calls captured in one CUDA graph,
    the graph replayed between two CUDA events, divided by `iters`. Unlike
    cuda_ms, it does not count the time the device waits for the host to
    enqueue the next call. (torch.profiler would give kernel durations too,
    but a profiled process launches slower afterwards, which would bias
    phase 4; the profiler runs only after it, in --profile.)"""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):         # warm-up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


@contextlib.contextmanager
def unfused_select():
    """Page-sparse decode selects pages as the port did before K3 took the
    selection in: the bounds-only kernel, then ops.select_pages on the card
    (eager sorts, gathers and casts). The launch count stays one a call.
    A CUDA graph keeps the selection it was captured with: an engine must
    capture its decode step inside this context to replay it unfused."""
    from repro_torch.kernels import binary_page_score as pscore
    from repro_torch.kernels import ops
    fused = pscore.paged_select_pages

    def unfused(q, k_pool, tables, counts, lengths, *, d, page, n_sel):
        scores = pscore.paged_page_scores(q, k_pool, tables, counts, d=d)
        return ops.select_pages(scores, tables, lengths, page=page,
                                n_sel=n_sel)

    pscore.paged_select_pages = unfused
    try:
        yield
    finally:
        pscore.paged_select_pages = fused


def bound(nbytes: float, ops) -> tuple[float, str]:
    """Least time (ms) for `nbytes` of memory traffic and `ops`, pairs of
    (operations, peak rate of the unit that does them): the larger of the
    bytes' time and the slowest unit's time."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / rate * 1e3 for n, rate in ops)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def split_tiles(mod, tiles: int):
    """Launches of `mod`'s kernel (and of every kernel that reads its
    SPLIT_TILES) split the key axis into runs of `tiles` tiles."""
    old, mod.SPLIT_TILES = mod.SPLIT_TILES, tiles
    try:
        yield
    finally:
        mod.SPLIT_TILES = old


# ---------------------------------------------------------------------------
# phase 1: the card and the build
# ---------------------------------------------------------------------------

def phase1() -> str:
    import torch
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: unavailable"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"phase 1: built {len(build.SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        regs = [ln.split("ptxas info    : ")[-1] for ln in text.splitlines()
                if "registers" in ln]
        log(f"  {name}: {'; '.join(regs)}")
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions at serving shapes
# ---------------------------------------------------------------------------

B, H, HK, D, DV, PAGE, NB, CHUNK, NSEL = 4, 9, 3, 64, 64, 16, 256, 512, 479
G, W, T_MAX = H // HK, 2, NB * PAGE
SCALE = 0.125                     # (sigma_q * sigma_k) * 64 ** -0.5


def _bits(shape, gen):
    import torch
    from repro_torch.core import hamming
    x = torch.randn(shape, generator=gen, device="cuda")
    return hamming.pack_bits(x).contiguous()


def _prefill_case(gen, lens):
    """lens: per slot (q_offset, q_length); kv_length = offset + length."""
    import torch
    q = _bits((B * H, CHUNK, D), gen)
    k = _bits((B * HK, T_MAX, D), gen)
    v = torch.randn((B * HK, T_MAX, DV), generator=gen,
                    device="cuda").to(torch.bfloat16)
    qoff = torch.tensor([o for o, _ in lens], dtype=torch.int32,
                        device="cuda").repeat_interleave(H)
    qlen = torch.tensor([n for _, n in lens], dtype=torch.int32,
                        device="cuda").repeat_interleave(H)
    return q, k, v, qoff + qlen, qoff, qlen


def _prefill_work(q, k, kvl, qoff, qlen):
    """(bytes, ops) the prefill function needs for these inputs at phase
    2's shapes (see `_k1_work`)."""
    return _k1_work(q, k, DV, kvl, qoff, qlen, d=D, nsel=NSEL, causal=True)


def _paged_case(gen, lengths):
    import torch
    n_pages = B * NB
    q = _bits((B, H, D), gen)
    k_pool = _bits((n_pages + 1, HK, PAGE, D), gen).transpose(-1, -2) \
        .contiguous()
    v_pool = torch.randn((n_pages + 1, HK, PAGE, DV), generator=gen,
                         device="cuda").to(torch.bfloat16)
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    bt = perm.reshape(B, NB).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    used = (lens + PAGE - 1) // PAGE
    bt = torch.where(torch.arange(NB, device="cuda")[None] < used[:, None],
                     bt, -1)
    return q, k_pool, v_pool, bt, lens


def _decode_work(q, k_rows, lens, index_bytes):
    """(bytes, ops) top-N decode needs for these inputs at phase 2's
    shapes: q [B, H, W], k_rows [B, Hk, T, W] row-major, lens [B]; index
    bytes of block tables and counts (paged) or lengths (dense); see
    `_decode_rows_work`."""
    return _decode_rows_work(
        q.reshape(B * HK, G, W), k_rows.reshape(B * HK, -1, W),
        lens.repeat_interleave(HK), index_bytes, d=D, nsel=NSEL, dv=DV)


def _paged_work(q, k_pool, bt, lens):
    from repro_torch.models.attention_block import gather_pages
    k_rows = gather_pages(k_pool, bt.clamp_min(0), 3).transpose(-1, -2)
    return _decode_work(q, k_rows, lens, 2 * B * HK * NB * 4)


def _dense_case(gen, lengths):
    """A dense cache: q [B, H, W], k bit-planes [B*Hk, W, T], bf16 v
    [B*Hk, T, Dv], lengths [B]."""
    import torch
    q = _bits((B, H, D), gen)
    k = _bits((B * HK, T_MAX, D), gen).transpose(-1, -2).contiguous()
    v = torch.randn((B * HK, T_MAX, DV), generator=gen,
                    device="cuda").to(torch.bfloat16)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def _record(mod, replaces, err, ms, plain_ms, work, host, library_ms=None,
            name=None) -> dict:
    """work: (bytes, [(operations, peak rate), ...]); host: host
    microseconds a call."""
    b_ms, b_by = bound(*work)
    name = name or mod.NAME
    log(f"phase 2: {name} {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
        f"{b_ms:.5f} ms by {b_by}, library "
        f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}; "
        f"host {host:.1f} us a call)")
    return dict(name=name, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{mod.NAME}.cu",
                replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


def phase2() -> dict:
    import torch
    from repro_torch.kernels import binary_paged_decode_attention as pdec
    from repro_torch.kernels import binary_prefill_attention as pre
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = {}

    # K1. "main": the last 512-token chunk of a 3072-token prompt in slot 0,
    # the three other slots idle (q_length 0) as in every prefill step.
    # "edges": ragged offsets, a partial query tile (300 = 4*64 + 44).
    cases = {"main": [(2560, 512), (0, 0), (0, 0), (0, 0)],
             "edges": [(1024, 300), (0, 512), (37, 1), (0, 0)]}
    err, timed = 0.0, None
    for name, lens in cases.items():
        q, k, v, kvl, qoff, qlen = _prefill_case(gen, lens)
        kw = dict(d=D, nsel=NSEL, scale=SCALE, kv_length=kvl, q_offset=qoff,
                  q_length=qlen)
        got = pre.prefill_attention(q, k, v, group_size=G, n_kv_heads=HK,
                                    **kw)
        want = ref.prefill_attention_ref(q, k, v, group_size=G, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        err = max(err, (got - want).abs().max().item())
        log(f"phase 2: K1 prefill [{name}] max_abs_err "
            f"{(got - want).abs().max().item():.3e}")
        if name == "main":
            timed = (q, k, v, kw)
    q, k, v, kw = timed
    want = ref.prefill_attention_ref(q, k, v, group_size=G, **kw)
    def k1():
        return pre.prefill_attention(q, k, v, group_size=G, n_kv_heads=HK,
                                     **kw)
    ms = {}
    for tiles in sorted({pre.SPLIT_TILES, 4, 8}):
        with split_tiles(pre, tiles):
            torch.testing.assert_close(k1(), want, **TOL)
            ms[tiles] = cuda_ms(k1, iters=50)
    log("phase 2: K1 ms by tiles per split: " + ", ".join(
        f"{t} -> {v:.4f}" for t, v in ms.items()))
    ms = ms[pre.SPLIT_TILES]
    plain_ms = cuda_ms(lambda: ref.prefill_attention_ref(
        q, k, v, group_size=G, **kw), iters=3, warmup=1)
    records[pre.NAME] = _record(
        pre, "src/repro/kernels/binary_prefill_attention.py:106", err, ms,
        plain_ms, _prefill_work(q, k, kw["kv_length"], kw["q_offset"],
                                kw["q_length"]), host_us(k1))

    # K2: 4 decoding slots, ragged lengths, shuffled pages, -1 past each
    # row's pages (count-0 blocks)
    err = 0.0
    for lengths in ([3104, 1537, 600, 33], [4095, 1, 17, 2048]):
        q, k_pool, v_pool, bt, lens = _paged_case(gen, lengths)
        kw = dict(d=D, nsel=NSEL, scale=SCALE)
        got = ops.paged_decode_attention(q, k_pool, v_pool, bt, lengths=lens,
                                         **kw)
        want = ref.paged_decode_attention_ref(
            q.reshape(B, HK, G, W), k_pool, v_pool, bt, lengths=lens,
            **kw).reshape(B, H, DV)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        err = max(err, (got - want).abs().max().item())
        log(f"phase 2: K2 paged decode lengths {lengths} max_abs_err "
            f"{(got - want).abs().max().item():.3e}")
    q, k_pool, v_pool, bt, lens = _paged_case(gen, [3104, 1537, 600, 33])
    bt_rows, counts, _ = ops._row_tables(bt, lens, HK, PAGE)
    qf = q.reshape(B * HK, G, W).contiguous()
    def k2():
        return pdec.paged_decode_attention(qf, k_pool, v_pool, bt_rows,
                                           counts, d=D, nsel=NSEL,
                                           scale=SCALE)
    ms = {}
    for tiles in sorted({pdec.SPLIT_TILES, 2, 4, 8}):
        with split_tiles(pdec, tiles):
            ms[tiles] = cuda_ms(k2, iters=200)
    log("phase 2: K2 ms by tiles per split: " + ", ".join(
        f"{t} -> {v:.4f}" for t, v in ms.items()))
    ms = ms[pdec.SPLIT_TILES]
    plain_ms = cuda_ms(lambda: ref.paged_decode_attention_rows_ref(
        qf, k_pool, v_pool, bt_rows, counts, d=D, nsel=NSEL, scale=SCALE),
        iters=10, warmup=2)
    records[pdec.NAME] = _record(
        pdec, "src/repro/kernels/binary_paged_decode_attention.py:109", err,
        ms, plain_ms, _paged_work(q, k_pool, bt, lens), host_us(k2))
    records.update(_phase2_k3(gen))
    records.update(_phase2_k4(gen))
    records.update(_phase2_k5(gen))
    _phase2_fp(gen)
    records.update(_phase2_wide(gen, **VISION_SHAPES))
    records.update(_phase2_wide(gen, **DBRX_SHAPES))
    return records


def _tie_pool(k_pool, gen):
    """The pool with every key of a page set to one of three words, so that
    many pages share one bound."""
    import torch
    words = _bits((3, D), gen)                                  # [3, W]
    pick = torch.randint(0, 3, (k_pool.shape[0],), generator=gen,
                         device="cuda")
    return words[pick][:, None, :, None].expand_as(k_pool).contiguous()


def _phase2_k3(gen) -> dict:
    """K3, the fused page bounds + selection + compaction, over the paged
    case's pools: bounds, tables, counts and logical ids equal the plain
    version's exactly, on phase 2's two length sets, a set with a length-0
    row, a page multiple and a full table, and tie-heavy keys, at the
    serving path's n_sel (64, 255) and n_sel = nb. Timed by device time,
    beside the back-to-back event time and the host time of one call, and
    beside the design it replaced (the bounds-only kernel, then
    ops.select_pages on the card) on the same inputs."""
    import torch
    from repro_torch.kernels import binary_page_score as pscore
    from repro_torch.kernels import ops, ref
    cases = [("A", [3104, 1537, 600, 33], False),
             ("B", [4095, 1, 17, 2048], False),
             ("C", [0, 1024, 4096, 160], False),
             ("A ties", [3104, 1537, 600, 33], True)]
    for name, lengths, ties in cases:
        q, k_pool, _, bt, lens = _paged_case(gen, lengths)
        if ties:
            k_pool = _tie_pool(k_pool, gen)
        bt_rows, counts, len_f = ops._row_tables(bt, lens, HK, PAGE)
        qf = q.reshape(B * HK, G, W).contiguous()
        want_s = ref.paged_page_scores_ref(qf, k_pool, bt_rows, counts, d=D)
        check(torch.equal(pscore.paged_page_scores(qf, k_pool, bt_rows,
                                                   counts, d=D), want_s),
              f"K3 bounds-only kernel [{name}]")
        for n_sel in (64, 255, NB):
            scores = torch.empty_like(want_s)
            got = pscore.paged_select_pages(qf, k_pool, bt_rows, counts,
                                            len_f, d=D, page=PAGE,
                                            n_sel=n_sel, scores_out=scores)
            want = ref.paged_select_pages_ref(qf, k_pool, bt_rows, counts,
                                              len_f, d=D, page=PAGE,
                                              n_sel=n_sel)
            torch.cuda.synchronize()
            check(torch.equal(scores, want_s), f"K3 bounds [{name}] {n_sel}")
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"K3 tables/counts/logical [{name}] n_sel {n_sel}")
        check(bool((want_s[counts == 0] == -D).all()),
              "count-0 blocks score -d")
        log(f"phase 2: K3 page select [{name}] lengths {lengths} exact at "
            f"n_sel 64/255/256 (bounds, tables, counts, logical; "
            f"{int((counts > 0).sum())} listed pages, "
            f"{int(want_s.unique().numel())} distinct bounds)")
    q, k_pool, _, bt, lens = _paged_case(gen, [3104, 1537, 600, 33])
    bt_rows, counts, len_f = ops._row_tables(bt, lens, HK, PAGE)
    qf = q.reshape(B * HK, G, W).contiguous()
    n_sel = 64                                   # page_topn 64's cut

    def k3():
        return pscore.paged_select_pages(qf, k_pool, bt_rows, counts, len_f,
                                         d=D, page=PAGE, n_sel=n_sel)

    def unfused():
        return ops.select_pages(pscore.paged_page_scores(
            qf, k_pool, bt_rows, counts, d=D), bt_rows, len_f, page=PAGE,
            n_sel=n_sel)

    check(all(torch.equal(a, b) for a, b in zip(k3(), unfused())),
          "K3 fused == bounds kernel + select_pages")
    ms = device_ms(k3)
    timed = {"fused": (ms, cuda_ms(k3, iters=200), host_us(k3)),
             "bounds kernel + select_pages": (
                 device_ms(unfused), cuda_ms(unfused, iters=200),
                 host_us(unfused))}
    for what, (dev, b2b, host) in timed.items():
        log(f"phase 2: K3 [{what}] device {dev:.4f} ms a call, back-to-back "
            f"events {b2b:.4f} ms, host {host:.1f} us a call"
            + (" (back-to-back measures the host)" if host / 1e3 >= dev
               else ""))
    plain_ms = cuda_ms(lambda: ref.paged_select_pages_ref(
        qf, k_pool, bt_rows, counts, len_f, d=D, page=PAGE, n_sel=n_sel),
        iters=10, warmup=2)
    r = B * HK
    n_keys = lens.sum().item() * HK
    work = (r * G * W * 4 + n_keys * W * 4 + 2 * r * NB * 4 + r * 4
            + 3 * r * n_sel * 4,
            [(n_keys * W * 2 + r * NB * G * W * 6, CUDA_CORE_OPS_PER_S)])
    return {pscore.NAME: _record(
        pscore, "src/repro/kernels/binary_page_score.py:68", 0.0, ms,
        plain_ms, work, timed["fused"][2])}


def _phase2_k4(gen) -> dict:
    """K4 over a dense cache; the same tokens laid out as in-order pages
    through K2 must give the same bits, as must every split size (K4 reads
    K2's SPLIT_TILES)."""
    import torch
    from repro_torch.kernels import binary_decode_attention as dec
    from repro_torch.kernels import binary_paged_decode_attention as pdec
    from repro_torch.kernels import ops, ref
    kw = dict(d=D, nsel=NSEL, scale=SCALE)
    err = 0.0
    for lengths in ([3104, 1537, 600, 33], [4095, 1, 17, 2048]):
        q, k, v, lens = _dense_case(gen, lengths)
        qf = q.reshape(B * HK, G, W).contiguous()
        len_f = lens.repeat_interleave(HK)
        got = dec.decode_attention(qf, k, v, len_f, **kw)
        want = ref.decode_attention_ref(qf, k.transpose(-1, -2), v,
                                        lengths=len_f, **kw)
        k_pool = k.reshape(B, HK, W, NB, PAGE).permute(0, 3, 1, 2, 4) \
            .reshape(B * NB, HK, W, PAGE).contiguous()
        v_pool = v.reshape(B, HK, NB, PAGE, DV).permute(0, 2, 1, 3, 4) \
            .reshape(B * NB, HK, PAGE, DV).contiguous()
        bt = torch.arange(B * NB, dtype=torch.int32,
                          device="cuda").reshape(B, NB)
        paged = ops.paged_decode_attention(q, k_pool, v_pool, bt,
                                           lengths=lens, **kw)
        splits = []
        for tiles in (1, 2, 8):
            with split_tiles(pdec, tiles):
                splits.append(dec.decode_attention(qf, k, v, len_f, **kw))
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        check(torch.equal(got.reshape(B, H, DV), paged),
              f"dense-cache decode != paged decode of the same tokens "
              f"{lengths}")
        check(all(torch.equal(got, x) for x in splits),
              f"K4 differs between split sizes {lengths}")
        err = max(err, (got - want).abs().max().item())
        log(f"phase 2: K4 dense decode lengths {lengths} max_abs_err "
            f"{(got - want).abs().max().item():.3e}, == K2 bit for bit, "
            f"the same bits at 1/2/4/8 tiles a split")
    q, k, v, lens = _dense_case(gen, [3104, 1537, 600, 33])
    qf = q.reshape(B * HK, G, W).contiguous()
    len_f = lens.repeat_interleave(HK)

    def k4():
        return dec.decode_attention(qf, k, v, len_f, **kw)
    ms = {}
    for tiles in sorted({pdec.SPLIT_TILES, 2, 4, 8}):
        with split_tiles(pdec, tiles):
            ms[tiles] = cuda_ms(k4, iters=200)
    log("phase 2: K4 ms by tiles per split: " + ", ".join(
        f"{t} -> {v:.4f}" for t, v in ms.items()))
    ms = ms[pdec.SPLIT_TILES]
    plain_ms = cuda_ms(lambda: ref.decode_attention_ref(
        qf, k.transpose(-1, -2), v, lengths=len_f, **kw), iters=10,
        warmup=2)
    work = _decode_work(q, k.transpose(-1, -2).reshape(B, HK, T_MAX, W),
                        lens, B * HK * 4)
    return {dec.NAME: _record(
        dec, "src/repro/kernels/binary_decode_attention.py:122", err, ms,
        plain_ms, work, host_us(k4))}


def _phase2_k5(gen) -> dict:
    """K5 on q [3, 1536, 2] x k [3, 4096, 2], both methods exact, a record
    each, timed by device time (a call is near its host time); the library
    yardstick is torch._int_mm on the unpacked +-1 int8 matrices (unpack
    excluded), one call per batch entry (it takes 2-D operands)."""
    import torch
    from repro_torch.core import hamming
    from repro_torch.kernels import hamming_score as hs
    from repro_torch.kernels import ref
    qh, kh = _bits((3, 1536, D), gen), _bits((3, 4096, D), gen)
    want = ref.hamming_score_ref(qh, kh, D)
    ms = {}
    for method in hs.METHODS:
        got = hs.hamming_score(qh, kh, D, method=method)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K5 {method} scores")

        def k5():
            return hs.hamming_score(qh, kh, D, method=method)
        ms[method] = device_ms(k5)
        log(f"phase 2: K5 hamming_score [{method}] exact, device "
            f"{ms[method]:.4f} ms a call, back-to-back events "
            f"{cuda_ms(k5, iters=200):.4f} ms")
    q8 = hamming.unpack_bits(qh, D).to(torch.int8)
    k8 = hamming.unpack_bits(kh, D).to(torch.int8)

    def library():
        return [torch._int_mm(q8[i], k8[i].T) for i in range(3)]

    check(torch.equal(torch.stack(library()), want), "torch._int_mm scores")
    library_ms = device_ms(library)
    plain_ms = cuda_ms(lambda: ref.hamming_score_ref(qh, kh, D), iters=3,
                       warmup=1)
    n_out = want.numel()
    nbytes = (qh.numel() + kh.numel()) * 4 + n_out * 4
    replaces = "src/repro/kernels/hamming_score.py:64"
    host = {m: host_us(lambda: hs.hamming_score(qh, kh, D, method=m))
            for m in hs.METHODS}
    return {hs.NAME: _record(
                hs, replaces, 0.0, ms["xor"], plain_ms,
                (nbytes, [(n_out * (2 * W + 2), CUDA_CORE_OPS_PER_S)]),
                host["xor"], library_ms=library_ms),
            K5_INT8: _record(
                hs, replaces, 0.0, ms["int8"], plain_ms,
                (nbytes, [(n_out * 2 * D, INT8_TENSOR_OPS_PER_S)]),
                host["int8"], library_ms=library_ms, name=K5_INT8)}


def _phase2_fp(gen) -> None:
    """The full-precision baseline's attention (standard_attention, the
    port's counterpart of the JAX package's einsums: no kernel of its own)
    against F.scaled_dot_product_attention with the same mask (additive,
    -1e30 where masked, so idle rows are uniform in both), bf16 q/k/v at
    the phase-4 shapes: a decode step of 4 slots over 4096-position rows,
    and a 512-query chunk of slot 0 at offset 2560 with the other slots
    idle. Both timed by device time (graph replay) and back to back; the
    host time of one port call. Allclose at atol/rtol 2e-2 (bf16 output,
    float32 against bf16 products)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.attention import standard_attention
    cases = {"decode": (1, [3104, 1537, 600, 33], [3103, 1536, 599, 32]),
             "prefill 512": (CHUNK, [3072, 0, 0, 0], [2560, 0, 0, 0])}
    for name, (s, lens, offs) in cases.items():
        q = torch.randn((B, H, s, DV), generator=gen, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn((B, HK, T_MAX, DV), generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        kv_len = torch.tensor(lens, device="cuda")
        q_off = torch.tensor(offs, device="cuda")
        kv_valid = torch.arange(T_MAX, device="cuda")[None] < kv_len[:, None]
        pos = torch.arange(s, device="cuda")
        mask = ((torch.arange(T_MAX, device="cuda")[None, None]
                 <= (q_off[:, None] + pos[None])[..., None])
                & kv_valid[:, None])[:, None]               # [B, 1, S, T]
        bias = torch.where(mask, 0.0, -1e30).to(torch.bfloat16)

        def port():
            return standard_attention(q, k, v, scale=DV ** -0.5,
                                      q_offset=q_off, kv_valid=kv_valid)

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, scale=DV ** -0.5, enable_gqa=True)

        got, want = port(), sdpa()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
        iters = 200 if s == 1 else 20
        log(f"phase 2: fp attention [{name}] (not a kernel) port "
            f"{device_ms(port, iters):.4f} ms device / "
            f"{cuda_ms(port, iters):.4f} ms back to back, SDPA "
            f"{device_ms(sdpa, iters):.4f} / {cuda_ms(sdpa, iters):.4f} ms, "
            f"max_abs_err {err:.3e}; port host {host_us(port):.1f} us a "
            f"call")


# llama-3.2-vision-11b's and dbrx-132b's serving shapes: d = 128 -> 4
# words, 32 heads over 8 kv heads (4 query heads each), or 48 over 8 (6
# each), bf16 V of width 128, 4 slots, 512-token chunks, 16-token pages
# over 4096-position tables, top-N 479 (max_len 4096); vision's cross
# layers hold 1601 image keys
VB, VD, V_IMG = 4, 128, 1601
VW, VDV = VD // 32, VD
V_SCALE = VD ** -0.5              # sigma_q = sigma_k = 1
VISION_SHAPES = dict(h=32, hk=8, tag="vision", names=dict(
    k1=K1_VISION, k1_cross=K1_CROSS, k2=K2_VISION, k3=K3_VISION,
    k4=K4_VISION, k4_cross=K4_CROSS))
DBRX_SHAPES = dict(h=48, hk=8, tag="dbrx", names=dict(
    k1=K1_DBRX, k2=K2_DBRX, k3=K3_DBRX, k4=K4_DBRX))


def _k1_work(q, k, dv, kvl, qoff, qlen, *, d, nsel, causal, window=None,
             v_bytes: int = 2, ev_rate: float | None = None):
    """(bytes, ops) the prefill function needs for these inputs, from
    their shapes: q [BH, S, W], k [BHk, T, W], V width dv, per-row
    kv_length / q_offset / q_length. Bytes: the live queries' words, the
    keys some live query may use (words) and the kept ones' V (bf16),
    the float32 output. Operations: the scores of the valid pairs on the
    CUDA cores, E.V of the kept pairs and their sum(E) (a column of ones)
    on the bf16 tensor cores, three bf16 products a multiply-add (E as
    e0 + e1 + e2). The pairs are counted `window` queries at a time
    (default all S; a long call's score matrix does not fit at once):
    valid and kept pairs summed, the keys any window uses OR-ed. Float32
    V (`v_bytes` 4) runs E.V as 3xTF32 products: `ev_rate` the TF32
    rate."""
    import torch
    from repro_torch.core import hamming, topn
    from repro_torch.kernels import binary_prefill_attention as pre
    bh, s, w = q.shape
    bhk, t, _ = k.shape
    g, window = bh // bhk, window or s
    kv_any = torch.zeros((bhk, t), dtype=torch.bool, device="cuda")
    v_any = torch.zeros_like(kv_any)
    n_valid = n_kept = 0
    for s0 in range(0, s, window):
        qw, kw, _, kvlw, qo, ql = pre.wave_inputs(
            q, k, k, kvl, qoff, qlen, g, 0, bh, s0, min(s, s0 + window))
        sc = hamming.binary_scores(qw, torch.repeat_interleave(kw, g, 0), d)
        qi = torch.arange(qw.shape[1], device="cuda")[None, :, None]
        kp = torch.arange(t, device="cuda")[None, None, :]
        valid = (kp < kvlw[:, None, None]) & (qi < ql[:, None, None])
        if causal:
            valid = valid & (kp <= qo[:, None, None] + qi)
        keep = topn.topn_mask_binary(sc, nsel, d, valid=valid)
        kv_any |= valid.reshape(bhk, -1, t).any(1)
        v_any |= keep.reshape(bhk, -1, t).any(1)
        n_valid += valid.sum().item()
        n_kept += keep.sum().item()
        del sc, valid, keep
    nbytes = (qlen.sum().item() * w * 4 + kv_any.sum().item() * w * 4
              + v_any.sum().item() * dv * v_bytes + bh * s * dv * 4
              + 3 * bh * 4)
    return nbytes, [(n_valid * (2 * w + 2), CUDA_CORE_OPS_PER_S),
                    (3 * n_kept * 2 * (dv + 1),
                     ev_rate or BF16_TENSOR_OPS_PER_S)]


def _decode_rows_work(q, k_rows, lens, index_bytes, *, d, nsel, dv,
                      v_bytes: int = 2):
    """(bytes, ops) top-N decode needs for these inputs: q [R, G, W],
    k_rows [R, T, W] row-major, lens [R] valid keys a row; index_bytes of
    tables and counts, or lengths. Bytes: queries, every valid key's
    words, the kept keys' V (bf16), the indices, the float32 output;
    operations on the CUDA cores: the scores and the kept keys' E.V."""
    import torch
    from repro_torch.core import hamming, topn
    r, g, w = q.shape
    s = hamming.binary_scores(q, k_rows, d)                 # [R, G, T]
    valid = (torch.arange(k_rows.shape[1], device="cuda")[None, None]
             < lens[:, None, None]).expand_as(s)
    keep = topn.topn_mask_binary(s, nsel, d, valid=valid)
    n_keys = lens.sum().item()
    nbytes = (r * g * w * 4 + n_keys * w * 4
              + keep.any(1).sum().item() * dv * v_bytes + index_bytes
              + r * g * dv * 4)
    nops = keep.sum().item() * (2 * dv + 1) + n_keys * g * (2 * w + 2)
    return nbytes, [(nops, CUDA_CORE_OPS_PER_S)]


def _phase2_wide(gen, h: int, hk: int, tag: str, names: dict, d: int = VD,
                 k3_nsel: int = 255) -> dict:
    """K1, K2, K3 and K4 at a model's serving shapes (h query heads over hk
    kv heads of width d, 128 by default; phase 6's and phase 8's paths,
    and a phase-11 rank's), each against its
    plain version at phase 2's tolerances, timed by CUDA events (K3 by
    device time), with its bound and host time: K1 causal, slot 0's last
    512-query chunk of a 2048-token prompt over the 4096-position table,
    the other slots idle (a self-attention layer's chunk); K2 over 4 slots
    at ragged ~2k lengths; K3, the fused page select, on K2's pools, exact
    at n_sel 64 (it selects) and 255 (phases 6 and 8's page_topn, which
    keeps every resident page), timed at 255; K4 over a dense engine's
    self-attention cache (4097 positions: max_len and its trash position)
    at K2's lengths. With cross layers (`names` has "k1_cross"): K1
    non-causal over the 1601 image keys, every query of every slot live
    (a cross layer's chunk: the JAX step passes no q_length there), and K4
    over the 1601-key cross cache (a cross layer's decode step, paged
    engine or not), both also checked at nsel 2000, past the 1601 keys.
    `d` is the head width (V as wide); K3 is timed at `k3_nsel`."""
    import torch
    from repro_torch.kernels import binary_decode_attention as dec
    from repro_torch.kernels import binary_paged_decode_attention as pdec
    from repro_torch.kernels import binary_prefill_attention as pre
    from repro_torch.kernels import ops, ref
    records = {}
    t_tab = NB * PAGE
    g_size = h // hk
    w, dv, scale = d // 32, d, d ** -0.5

    def per_row(vals):
        return torch.tensor(vals, dtype=torch.int32,
                            device="cuda").repeat_interleave(h)

    cases = {names["k1"]: (t_tab, True, per_row([1536, 0, 0, 0]),
                           per_row([512, 0, 0, 0]))}
    if "k1_cross" in names:
        cases[names["k1_cross"]] = (V_IMG, False,
                                    per_row([1536, 512, 0, 1000]),
                                    per_row([CHUNK] * VB))
    for name, (t, causal, qoff, qlen) in cases.items():
        q = _bits((VB * h, CHUNK, d), gen)
        k = _bits((VB * hk, t, d), gen)
        v = torch.randn((VB * hk, t, dv), generator=gen,
                        device="cuda").to(torch.bfloat16)
        kvl = qoff + qlen if causal else torch.full_like(qoff, t)
        err = 0.0
        for nsel in (NSEL, 2000) if not causal else (NSEL,):
            kw = dict(d=d, nsel=nsel, scale=scale, kv_length=kvl,
                      q_offset=qoff, q_length=qlen, causal=causal)
            got = pre.prefill_attention(q, k, v, group_size=g_size,
                                        n_kv_heads=hk, **kw)
            want = ref.prefill_attention_ref(q, k, v, group_size=g_size,
                                             **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **TOL)
            e = (got - want).abs().max().item()
            err = max(err, e) if nsel == NSEL else err
            log(f"phase 2: {name} nsel {nsel} max_abs_err {e:.3e}")
            del got, want
        kw = dict(d=d, nsel=NSEL, scale=scale, kv_length=kvl,
                  q_offset=qoff, q_length=qlen, causal=causal)

        def k1():
            return pre.prefill_attention(q, k, v, group_size=g_size,
                                         n_kv_heads=hk, **kw)
        ms = cuda_ms(k1, iters=20)
        plain_ms = cuda_ms(lambda: ref.prefill_attention_ref(
            q, k, v, group_size=g_size, **kw), iters=2, warmup=1)
        work = _k1_work(q, k, dv, kvl, qoff, qlen, d=d, nsel=NSEL,
                        causal=causal)
        records[name] = _record(
            pre, "src/repro/kernels/binary_prefill_attention.py:106", err,
            ms, plain_ms, work, host_us(k1), name=name)
        del q, k, v
        torch.cuda.empty_cache()

    # K2: four decoding slots of a self-attention layer, shuffled pages
    n_pages = VB * NB
    lens = torch.tensor([2063, 1030, 1790, 527], dtype=torch.int32,
                        device="cuda")
    qd = _bits((VB, h, d), gen)
    k_pool = _bits((n_pages + 1, hk, PAGE, d), gen).transpose(-1, -2) \
        .contiguous()
    v_pool = torch.randn((n_pages + 1, hk, PAGE, dv), generator=gen,
                         device="cuda").to(torch.bfloat16)
    bt = torch.randperm(n_pages, generator=gen, device="cuda").reshape(
        VB, NB).to(torch.int32)
    bt = torch.where(torch.arange(NB, device="cuda")[None]
                     < ((lens + PAGE - 1) // PAGE)[:, None], bt, -1)
    kw = dict(d=d, nsel=NSEL, scale=scale)
    got = ops.paged_decode_attention(qd, k_pool, v_pool, bt, lengths=lens,
                                     **kw)
    want = ref.paged_decode_attention_ref(
        qd.reshape(VB, hk, g_size, w), k_pool, v_pool, bt, lengths=lens,
        **kw).reshape(VB, h, dv)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    err = (got - want).abs().max().item()
    log(f"phase 2: {names['k2']} lengths {lens.tolist()} max_abs_err "
        f"{err:.3e}")
    bt_rows, counts, len_f = ops._row_tables(bt, lens, hk, PAGE)
    qf = qd.reshape(VB * hk, g_size, w).contiguous()

    def k2():
        return pdec.paged_decode_attention(qf, k_pool, v_pool, bt_rows,
                                           counts, **kw)
    ms = cuda_ms(k2, iters=200)
    plain_ms = cuda_ms(lambda: ref.paged_decode_attention_rows_ref(
        qf, k_pool, v_pool, bt_rows, counts, **kw), iters=5, warmup=1)
    from repro_torch.models.attention_block import gather_pages
    k_rows = gather_pages(k_pool, bt.clamp_min(0), 3).transpose(-1, -2) \
        .reshape(VB * hk, NB * PAGE, w)
    work = _decode_rows_work(qf, k_rows, lens.repeat_interleave(hk),
                             2 * VB * hk * NB * 4, d=d, nsel=NSEL, dv=dv)
    records[names["k2"]] = _record(
        pdec, "src/repro/kernels/binary_paged_decode_attention.py:109", err,
        ms, plain_ms, work, host_us(k2), name=names["k2"])
    records[names["k3"]] = _phase2_wide_k3(qf, k_pool, bt_rows, counts,
                                           len_f, names["k3"], d=d,
                                           timed_nsel=k3_nsel)
    del k_pool, v_pool, k_rows

    # K4 over a dense engine's self-attention cache at K2's lengths
    r, t_dense = VB * hk, t_tab + 1
    qd = _bits((r, g_size, d), gen)
    k = _bits((r, t_dense, d), gen)
    planes = k.transpose(-1, -2).contiguous()
    v = torch.randn((r, t_dense, dv), generator=gen,
                    device="cuda").to(torch.bfloat16)
    len_f = lens.repeat_interleave(hk)
    kw = dict(d=d, nsel=NSEL, scale=scale)
    got = dec.decode_attention(qd, planes, v, len_f, **kw)
    want = ref.decode_attention_ref(qd, k, v, lengths=len_f, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    err = (got - want).abs().max().item()
    log(f"phase 2: {names['k4']} T {t_dense} lengths {lens.tolist()} "
        f"max_abs_err {err:.3e}")

    def k4_self():
        return dec.decode_attention(qd, planes, v, len_f, **kw)
    ms = cuda_ms(k4_self, iters=200)
    plain_ms = cuda_ms(lambda: ref.decode_attention_ref(
        qd, k, v, lengths=len_f, **kw), iters=5, warmup=1)
    work = _decode_rows_work(qd, k, len_f, r * 4, d=d, nsel=NSEL, dv=dv)
    records[names["k4"]] = _record(
        dec, "src/repro/kernels/binary_decode_attention.py:122", err, ms,
        plain_ms, work, host_us(k4_self), name=names["k4"])
    del k, planes, v
    if "k4_cross" not in names:
        return records

    # K4 over the cross cache: every slot's kv heads, all 1601 keys valid
    name = names["k4_cross"]
    qd = _bits((r, g_size, d), gen)
    k = _bits((r, V_IMG, d), gen)
    planes = k.transpose(-1, -2).contiguous()
    v = torch.randn((r, V_IMG, dv), generator=gen,
                    device="cuda").to(torch.bfloat16)
    len_f = torch.full((r,), V_IMG, dtype=torch.int32, device="cuda")
    err = 0.0
    for nsel in (NSEL, 2000):
        kw = dict(d=d, nsel=nsel, scale=scale)
        got = dec.decode_attention(qd, planes, v, len_f, **kw)
        want = ref.decode_attention_ref(qd, k, v, lengths=len_f, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        e = (got - want).abs().max().item()
        err = max(err, e) if nsel == NSEL else err
        log(f"phase 2: {name} nsel {nsel} max_abs_err {e:.3e}")
    kw = dict(d=d, nsel=NSEL, scale=scale)

    def k4():
        return dec.decode_attention(qd, planes, v, len_f, **kw)
    ms = cuda_ms(k4, iters=200)
    plain_ms = cuda_ms(lambda: ref.decode_attention_ref(
        qd, k, v, lengths=len_f, **kw), iters=5, warmup=1)
    work = _decode_rows_work(qd, k, len_f, r * 4, d=d, nsel=NSEL, dv=dv)
    records[name] = _record(
        dec, "src/repro/kernels/binary_decode_attention.py:122", err, ms,
        plain_ms, work, host_us(k4), name=name)
    return records


def _phase2_wide_k3(qf, k_pool, bt_rows, counts, len_f, name, d: int = VD,
                    timed_nsel: int = 255) -> dict:
    """K3 on a `_phase2_wide` K2 case's pools: bounds, tables, counts and
    logical ids equal the plain version's exactly at n_sel 64 and 255;
    timed by device time at `timed_nsel` (the full-size runs'
    page_topn)."""
    import torch
    from repro_torch.kernels import binary_page_score as pscore
    from repro_torch.kernels import ref
    want_s = ref.paged_page_scores_ref(qf, k_pool, bt_rows, counts, d=d)
    for n_sel in (64, 255):
        scores = torch.empty_like(want_s)
        got = pscore.paged_select_pages(qf, k_pool, bt_rows, counts, len_f,
                                        d=d, page=PAGE, n_sel=n_sel,
                                        scores_out=scores)
        want = ref.paged_select_pages_ref(qf, k_pool, bt_rows, counts, len_f,
                                          d=d, page=PAGE, n_sel=n_sel)
        torch.cuda.synchronize()
        check(torch.equal(scores, want_s), f"{name} bounds {n_sel}")
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{name} tables/counts/logical n_sel {n_sel}")
        log(f"phase 2: {name} n_sel {n_sel} exact (bounds, tables, "
            f"counts, logical; {int((counts > 0).sum())} listed pages, "
            f"{int((want[1] > 0).sum())} kept)")
    n_sel = timed_nsel

    def k3():
        return pscore.paged_select_pages(qf, k_pool, bt_rows, counts, len_f,
                                         d=d, page=PAGE, n_sel=n_sel)
    ms = device_ms(k3)
    plain_ms = cuda_ms(lambda: ref.paged_select_pages_ref(
        qf, k_pool, bt_rows, counts, len_f, d=d, page=PAGE, n_sel=n_sel),
        iters=10, warmup=2)
    r, nb = bt_rows.shape
    g_size = qf.shape[1]
    n_keys = len_f.sum().item()
    w = d // 32
    work = (r * g_size * w * 4 + n_keys * w * 4 + 2 * r * nb * 4 + r * 4
            + 3 * r * n_sel * 4,
            [(n_keys * w * 2 + r * nb * g_size * w * 6,
              CUDA_CORE_OPS_PER_S)])
    return _record(pscore, "src/repro/kernels/binary_page_score.py:68", 0.0,
                   ms, plain_ms, work, host_us(k3), name=name)


# ---------------------------------------------------------------------------
# phase 3: the same weights on the CPU and on the card
# ---------------------------------------------------------------------------

def _engine(cfg, model, scfg_kw, device, telemetry=None, eager=False):
    from repro_torch.serve import Engine, ServeConfig
    return Engine(cfg, model, ServeConfig(**scfg_kw), telemetry=telemetry,
                  device=device, eager=eager)


def _generate(eng, prompts, extras, gen: int):
    """Greedy tokens [R, gen] of `prompts` through the engine, each with
    its extra inputs (or None)."""
    import numpy as np
    ids = [eng.submit(p, max_new_tokens=gen, extra=e)
           for p, e in zip(prompts, extras)]
    out = eng.run()
    return np.stack([out[i] for i in ids])


def _graph_vs_eager(cfg, model, scfg, prompts, extras=None) -> None:
    """On the card, the CUDA-graph step against the eager step of one
    engine configuration: the logits of two prefill chunks (one slot
    each; the first with slot 0's image when `extras` gives prompt 0
    one) and three decode steps through the runners' low-level steps,
    and greedy tokens through the Engine, equal bit for bit."""
    import numpy as np
    import torch
    from repro_torch.serve.runner import _chunk_extra
    extras = extras or [None] * len(prompts)
    rng = np.random.default_rng(2)
    nb = scfg["max_len"] // scfg["page_size"]
    bt = (np.arange(2 * nb, dtype=np.int32)[::-1].reshape(2, nb).copy()
          if scfg.get("paged") else None)
    st = np.array([1, 0], np.int32)       # ignored without cross layers
    chunk = scfg["prefill_chunk"]
    steps = []
    for slot, nv in ((0, chunk), (1, 41)):
        tok = rng.integers(0, cfg.vocab_size, nv).astype(np.int32)
        extra = (_chunk_extra(extras[0], nv, 0, nv, chunk)
                 if slot == 0 else None)
        steps.append(("prefill", (slot, tok, 0,
                                  None if bt is None else bt[slot],
                                  int(st[slot]), extra)))
    for i in range(3):
        steps.append(("decode", (
            rng.integers(0, cfg.vocab_size, 2).astype(np.int32),
            np.array([chunk + i, 41 + i], np.int32), np.ones(2, bool), bt,
            st)))
    logits, tokens = [], []
    for eager in (True, False):
        runner = _engine(cfg, model, scfg, "cuda", eager=eager).runner
        logits.append([
            (runner.prefill_step if kind == "prefill" else
             runner.decode_step)(*args).clone() for kind, args in steps])
        check(runner.graph_count() == (0 if eager else 2),
              runner.graph_count())
        tokens.append(_generate(_engine(cfg, model, scfg, "cuda",
                                        eager=eager), prompts, extras, 8))
    check(all(torch.equal(a, b) for a, b in zip(*logits)),
          ("graph logits != eager logits", scfg))
    check((tokens[0] == tokens[1]).all(), ("graph tokens != eager", scfg))


def phase3() -> None:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("smollm-135m", n_layers=2, param_dtype="float32")
    cpu_model = T.init_params(cfg, torch.Generator().manual_seed(1))
    gpu_model = T.init_params(cfg, torch.Generator().manual_seed(1),
                              device="cuda")
    # first step: one prefill chunk through serve_step on both devices,
    # into page pools and into the dense cache
    n_pages, page, chunk = 8, 16, 64
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (2, chunk)).astype(np.int32)
    args = dict(pos=np.array([0, 0], np.int32),
                active=np.array([True, True]),
                n_valid=np.array([chunk, 41], np.int32))
    caches = {"paged": dict(paged=True, n_pages=n_pages, page_size=page),
              "dense": dict(paged=False, batch=2, max_len=chunk)}
    tables = {"paged": np.array([[2, 5, 0, 6], [1, 3, 7, -1]], np.int32),
              "dense": None}
    for kind, cache_kw in caches.items():
        for binary in (True, False):
            logits = []
            for model, dev in ((cpu_model, "cpu"), (gpu_model, "cuda")):
                bt = tables[kind]
                out = T.serve_step(
                    model, torch.from_numpy(tok).to(dev),
                    T.init_caches(cfg, device=dev, binary=binary,
                                  **cache_kw), n=16,
                    logits_mode="last", binary=binary,
                    block_tables=None if bt is None else
                    torch.from_numpy(bt).to(dev),
                    **{k: torch.from_numpy(v).to(dev)
                       for k, v in args.items()})
                logits.append(out.cpu())
            diff = (logits[0] - logits[1]).abs().max().item()
            torch.testing.assert_close(logits[1], logits[0], **CROSS_TOL)
            log(f"phase 3: first-step logits ({kind} cache, "
                f"{'binary' if binary else 'fp'}) cpu vs cuda "
                f"max_abs_diff {diff:.3e}")
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (70, 130, 41)]
    scfg = dict(max_len=160, batch_slots=2, prefill_chunk=64, paged=True,
                page_size=16)
    paths = (("paged", {}), ("dense", dict(paged=False)),
             ("page_topn 3", dict(page_topn=3)),
             ("fp paged", dict(binary=False)),
             ("fp dense", dict(binary=False, paged=False)))
    for kind, kw in paths:
        outs = []
        for model, dev in ((cpu_model, "cpu"), (gpu_model, "cuda")):
            outs.append(_engine(cfg, model, dict(scfg, **kw),
                                dev).generate(prompts, 8))
        check((outs[0] == outs[1]).all(), (kind, outs[0], outs[1]))
        log(f"phase 3: greedy tokens ({kind}) equal on cpu and cuda: "
            f"{outs[1].tolist()}")
    for kind, kw in paths + (("fp page_topn 3",
                              dict(binary=False, page_topn=3)),):
        _graph_vs_eager(cfg, gpu_model, dict(scfg, **kw), prompts)
        log(f"phase 3: CUDA graphs == eager step ({kind}): logits of 2 "
            f"prefill chunks + 3 decode steps and greedy tokens, bit for "
            f"bit")


V3_VOCAB = 16384       # phase 3's vision vocabulary, cut from 128256


@contextlib.contextmanager
def bits_tape(tape: list, replay: bool):
    """Every `hamming.pack_bits` call of the serving path (queries, keys,
    image keys) either appends its packed words to `tape` (on the host),
    or, with `replay`, returns the tape's words in call order instead of
    its own, counting the words where its own differ. Sign bits of float32
    values within rounding of zero differ between the CPU's and the card's
    GEMMs; replaying the card's bits on the CPU holds everything after
    the binarization, the kernels included, to the plain versions. A
    replay fails if more than max(16, 1 in 10000) of the words differ:
    the projections, RoPE and the fills before the binarization are held
    too (3 of ~200k words differed at phase 3's shapes on an H100)."""
    from repro_torch.core import hamming
    own = hamming.pack_bits
    seen = {"calls": 0, "words": 0, "differ": 0}

    def record(x):
        out = own(x)
        tape.append(out.cpu())
        return out

    def play(x):
        mine = own(x)
        want = tape[seen["calls"]].to(mine.device)
        check(want.shape == mine.shape, ("bits tape out of step",
                                         want.shape, mine.shape))
        seen["calls"] += 1
        seen["words"] += mine.numel()
        seen["differ"] += int((mine != want).sum())
        return want

    hamming.pack_bits = play if replay else record
    try:
        yield seen
    finally:
        hamming.pack_bits = own
    if replay:
        check(seen["calls"] == len(tape), "bits tape not used up")
        check(seen["differ"] <= max(16, seen["words"] // 10000),
              ("the CPU's bits differ from the card's in more words than "
               "float32 rounding flips", seen))


def phase3_vision() -> None:
    """Phase 3 at llama-3.2-vision-11b's widths: one group of its 5 layers
    (AAAAC), float32, the vocabulary cut to V3_VOCAB so that the CPU twin
    stays small; seeded weights drawn on the CPU and copied to the card,
    each first-step row with its own seeded [1601, 1280] image, and one
    image request beside a text-only one (`_phase3_state`)."""
    import numpy as np
    from repro_torch.configs import get_config
    cfg = get_config(VISION, n_layers=5, param_dtype="float32",
                     vocab_size=V3_VOCAB)
    cpu_model, gpu_model = _phase3_models(cfg, 2, "vision",
                                          f"vocabulary cut to "
                                          f"{V3_VOCAB} (of 128256)")
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, cfg.n_image_tokens, cfg.frontend_dim),
                              dtype=np.float32)
    _phase3_state("vision", cfg, cpu_model, gpu_model, rng, img)


def phase3_jamba() -> None:
    """Phase 3 on reduced jamba-1.5-large-398b: one MMMMAMMM group (SSM
    layers around one attention layer, MoE FFNs at every second
    position, 4 experts top-2, d 64), float32 (`_phase3_state`, text
    only): the SSM state pooled or in dense rows, the MoE groups spanning
    the batch rows."""
    import numpy as np
    from repro_torch.configs import get_config
    cfg = get_config(JAMBA, reduced=True)
    cpu_model, gpu_model = _phase3_models(cfg, 4, "jamba", "reduced")
    _phase3_state("jamba", cfg, cpu_model, gpu_model,
                  np.random.default_rng(5), None)


def _phase3_models(cfg, seed: int, tag: str, note: str):
    """Seeded weights drawn on the CPU, and a copy on the card."""
    import torch
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    cpu_model = T.init_params(cfg, torch.Generator().manual_seed(seed))
    gpu_model = T.Transformer(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.refresh_scales()
    log(f"phase 3 [{tag}]: {cfg.name} widths (d {cfg.d_model}), layers "
        f"{cfg.layer_pattern}, {cfg.param_dtype}, {note}, weights drawn on "
        f"the CPU and copied in {time.perf_counter() - t0:.1f} s")
    return cpu_model, gpu_model


def _phase3_state(tag, cfg, cpu_model, gpu_model, rng, img) -> None:
    """Phase 3 for a model with per-slot state (cross caches, SSM state),
    the same weights on the CPU and the card. At wide float32 layers,
    rounding flips sign bits of near-zero queries and keys between the
    CPU's and the card's GEMMs, each flip moving a query's whole score
    row, so the binary runs are compared on the card's bits
    (`bits_tape`): the card records them, the CPU replays them and counts
    the words of its own that differ. First-step logits (a 64-token chunk
    of two slots; with images `img` [2, T, frontend_dim], one a row)
    allclose at CROSS_TOL on the paged cache with pooled state and on the
    dense cache, binary (on the card's bits; the difference on the CPU's
    own bits is printed) and fp; greedy tokens of two requests (with
    images: the first with row 0's image, the second text-only) equal on
    both devices on those four paths (binary: the card's eager step
    recorded, the CPU replaying); and on the card, graph == eager bit for
    bit on the four."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    chunk = 64
    tok = rng.integers(0, cfg.vocab_size, (2, chunk)).astype(np.int32)
    args = dict(pos=np.array([0, 0], np.int32),
                active=np.array([True, True]),
                n_valid=np.array([chunk, 41], np.int32))
    caches = {"paged": (dict(paged=True, n_pages=8, page_size=16,
                             state_pages=2),
                        np.array([[2, 5, 0, 6], [1, 3, 7, -1]], np.int32),
                        np.array([1, 0], np.int32)),
              "dense": (dict(paged=False, batch=2, max_len=chunk), None,
                        None)}

    def first_step(model, dev, cache_kw, bt, st, binary):
        def put(x):
            return None if x is None else torch.from_numpy(x).to(dev)
        return T.serve_step(
            model, put(tok), T.init_caches(cfg, device=dev, binary=binary,
                                           **cache_kw),
            n=16, logits_mode="last", binary=binary, block_tables=put(bt),
            state_tables=put(st), image_embeds=put(img),
            **{k: put(v) for k, v in args.items()}).cpu()

    for kind, (cache_kw, bt, st) in caches.items():
        for binary in (True, False):
            tape: list = []
            with bits_tape(tape, replay=False):
                gpu = first_step(gpu_model, "cuda", cache_kw, bt, st, binary)
            own = first_step(cpu_model, "cpu", cache_kw, bt, st, binary)
            note = ""
            cpu = own
            if binary:
                with bits_tape(tape, replay=True) as seen:
                    cpu = first_step(cpu_model, "cpu", cache_kw, bt, st,
                                     binary)
                note = (f" on the card's bits ({seen['differ']} of "
                        f"{seen['words']} words of the CPU's own differ; on "
                        f"its own bits max_abs_diff "
                        f"{(own - gpu).abs().max().item():.3e})")
            diff = (cpu - gpu).abs().max().item()
            torch.testing.assert_close(gpu, cpu, **CROSS_TOL)
            log(f"phase 3 [{tag}]: first-step logits"
                f"{'' if img is None else ' with images'} ({kind} cache, "
                f"{'binary' if binary else 'fp'}) cpu vs cuda "
                f"max_abs_diff {diff:.3e}" + note)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (70, 41)]
    extras = ([None, None] if img is None
              else [{"image_embeds": img[:1]}, None])
    scfg = dict(max_len=160, batch_slots=2, prefill_chunk=64, paged=True,
                page_size=16)
    paths = (("paged", {}), ("dense", dict(paged=False)),
             ("fp paged", dict(binary=False)),
             ("fp dense", dict(binary=False, paged=False)))
    for kind, kw in paths:
        sc = dict(scfg, **kw)
        tape: list = []
        with bits_tape(tape, replay=False):
            gpu = _generate(_engine(cfg, gpu_model, sc, "cuda", eager=True),
                            prompts, extras, 8)
        note = ""
        if sc.get("binary", True):
            # both eager: the CPU's warm-up of a step kind would add calls
            with bits_tape(tape, replay=True) as seen:
                cpu = _generate(_engine(cfg, cpu_model, sc, "cpu",
                                        eager=True), prompts, extras, 8)
            note = (f" (on the card's bits; {seen['differ']} of "
                    f"{seen['words']} words of the CPU's own differ)")
        else:
            cpu = _generate(_engine(cfg, cpu_model, sc, "cpu"), prompts,
                            extras, 8)
        check((cpu == gpu).all(), (tag, kind, cpu, gpu))
        what = ("two requests" if img is None
                else "an image request and a text-only one")
        log(f"phase 3 [{tag}]: greedy tokens, {what} ({kind}), equal on "
            f"cpu and cuda{note}: {gpu.tolist()}")
        _graph_vs_eager(cfg, gpu_model, sc, prompts, extras)
        first = "" if img is None else " (an image in the first)"
        log(f"phase 3 [{tag}]: CUDA graphs == eager step ({kind}): logits "
            f"of 2 prefill chunks{first} + 3 decode steps and greedy "
            f"tokens, bit for bit")


# ---------------------------------------------------------------------------
# phase 4: the slice at full size
# ---------------------------------------------------------------------------

def _workload(cfg):
    """Phase 4's workload: 8 prompts of 512-3072 tokens drawn from seed 0,
    32 new tokens each, and the ServeConfig fields every run shares."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(512, 3073, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    base = dict(max_len=4096, batch_slots=4, prefill_chunk=512,
                page_size=16)
    return lens, prompts, 32, base


def _serve_run(eng, prompts, gen: int, step=None, stagger: int = 4,
               extras=None) -> dict:
    """The staggered workload through `eng` (4 requests up front, one more
    every `stagger` steps; all up front with stagger 0), stepped by `step`
    (default `eng.step`), request i with extras[i] (default none). Launch
    counts are zeroed just before and read just after: by kernel in
    "counts", with the split counters in "splits"."""
    import torch
    from repro_torch.kernels import ops
    step = eng.step if step is None else step
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    extras = extras or [None] * len(prompts)
    nxt = 4 if stagger else len(prompts)
    ids = [eng.submit(p, max_new_tokens=gen, extra=e)
           for p, e in zip(prompts[:nxt], extras)]
    results, steps, metrics = {}, 0, []
    while eng.queue or any(s.request is not None for s in eng.slots) \
            or nxt < len(prompts) or eng._inflight is not None:
        for fr in step():
            results[fr.request_id] = fr.tokens
        metrics += eng.pop_finished_metrics()
        steps += 1
        if nxt < len(prompts) and steps % stagger == 0:   # arrivals
            ids.append(eng.submit(prompts[nxt], max_new_tokens=gen,
                                  extra=extras[nxt]))
            nxt += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, splits = ops.launch_counts(), ops.launch_counts(splits=True)
    metrics += eng.pop_finished_metrics()
    eng.check()
    check(len(ids) == len(prompts), "every request is submitted")
    return dict(_result(eng, ids, results, gen, counts, wall, steps,
                        metrics), splits=splits)


def _result(eng, ids, results, gen, counts, wall, steps, metrics) -> dict:
    """A served run's record: tokens in submission order (each checked to
    be `gen` in-vocabulary tokens) and their digest, launch counts, host
    wall, steps, the engine's counters, TTFT and ITL in ms."""
    import numpy as np
    check(sorted(results) == sorted(ids), "every request finishes")
    for rid in ids:
        toks = results[rid]
        check(toks.shape == (gen,), (rid, toks.shape))
        check(((toks >= 0) & (toks < eng.cfg.vocab_size)).all(), rid)
    return dict(tokens=[results[rid] for rid in ids], counts=counts,
                digest=hashlib.sha1(b"".join(
                    np.asarray(results[rid], np.int64).tobytes()
                    for rid in ids)).hexdigest()[:12],
                wall=wall, steps=steps, stats=dict(eng.stats),
                ttft=np.array([m.ttft for m in metrics]) * 1e3,
                itl=np.array([x for m in metrics for x in m.itl]) * 1e3)


def _latency(r) -> str:
    import numpy as np
    st = r["stats"]
    return (f"wall {r['wall']:.3f} s, {st['tokens_generated'] / r['wall']:.2f}"
            f" generated tok/s, TTFT p50/p95 "
            f"{np.percentile(r['ttft'], 50):.2f}/"
            f"{np.percentile(r['ttft'], 95):.2f} ms, ITL p50/p95 "
            f"{np.percentile(r['itl'], 50):.2f}/"
            f"{np.percentile(r['itl'], 95):.2f} ms")


def _swap_spy(eng, moved: list) -> None:
    """Record the state entry of every swap-out the runner makes."""
    swap_out = eng.runner._swap_out_pages

    def spy(rid, pages, state_page=-1):
        moved.append(state_page)
        return swap_out(rid, pages, state_page)
    eng.runner._swap_out_pages = spy


def _check_launches(name, eng, r, decoders) -> None:
    """Phase 4's launch rule: every kernel of the run's path ran once a
    layer for each prefill chunk (the prefill kernel, binary runs only) or
    decode step (`decoders`), through replays, and nothing else ran."""
    from repro_torch.kernels import binary_prefill_attention as pre
    st = r["stats"]
    want = {k: 0 for k in r["counts"]}
    if eng.scfg.binary:
        want[pre.NAME] = eng.cfg.n_layers * st["prefill_chunks"]
    for mod in decoders:
        want[mod.NAME] = eng.cfg.n_layers * st["decode_steps"]
    check(r["counts"] == want and st["decode_steps"] > 0,
          (name, r["counts"], want))


def phase4():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import hamming
    from repro_torch.kernels import binary_decode_attention as dec
    from repro_torch.kernels import binary_page_score as pscore
    from repro_torch.kernels import binary_paged_decode_attention as pdec
    from repro_torch.kernels import hamming_score as hs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import Telemetry
    cfg = get_config("smollm-135m")
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cuda")
    log(f"phase 4: {cfg.name} {cfg.n_layers} layers {cfg.param_dtype}, "
        f"weights in {time.perf_counter() - t0:.1f} s")
    lens, prompts, gen, base = _workload(cfg)
    log(f"phase 4: prompts {lens.tolist()}, {gen} new tokens each")
    # run -> (ServeConfig fields, the decode kernels its path launches);
    # "fp_" runs serve the full-precision baseline, which launches none of
    # the kernels
    paths = {"paged": (dict(paged=True), (pdec,)),
             "dense": (dict(paged=False), (dec,)),
             "page_topn_255": (dict(paged=True, page_topn=255),
                               (pdec, pscore)),
             "page_topn_64": (dict(paged=True, page_topn=64),
                              (pdec, pscore))}
    for name, (kw, _) in list(paths.items()):
        paths[f"fp_{name}"] = (dict(kw, binary=False), ())
    # two more binary runs, not counted in the kernel totals: page_topn 64
    # with the selection K3 replaced (the bounds-only kernel, then
    # ops.select_pages), whose pages attended and tokens must equal the
    # fused run's; and paged with the eager step, whose tokens must equal
    # the graphed run's
    extra = ("page_topn_64_unfused", "paged_eager")
    paths["page_topn_64_unfused"] = paths["page_topn_64"]
    paths["paged_eager"] = paths["paged"]
    runs, total, engines = {}, {}, {}
    for name, (kw, decoders) in paths.items():
        eager = name == "paged_eager"
        eng = _engine(cfg, model, dict(base, **kw), "cuda",
                      telemetry=Telemetry(), eager=eager)
        check(eng.n == NSEL, eng.n)
        with (unfused_select() if name.endswith("_unfused")
              else contextlib.nullcontext()):
            r = _serve_run(eng, prompts, gen)
        check(eng.runner.graph_count() == (0 if eager else 2),
              (name, "graphs", eng.runner.graph_count()))
        _check_launches(name, eng, r, decoders)
        if name not in extra:
            for k, v in r["counts"].items():
                total[k] = total.get(k, 0) + v
        st = r["stats"]
        log(f"phase 4 [{name}]: {r['steps']} steps, {st['prefill_chunks']} "
            f"prefill chunks, {st['decode_steps']} decode steps, "
            f"{eng.runner.graph_count()} step graphs, launches "
            f"{r['counts']}, decode pages attended "
            f"{st['decode_pages_touched']}, decode KV bytes "
            f"{st['decode_hbm_bytes']}, tokens sha1 {r['digest']}")
        log(f"phase 4 [{name}]: {_latency(r)}, peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        runs[name] = r
        if name in ("paged", "dense", "page_topn_64", "fp_paged",
                    "page_topn_64_unfused", "paged_eager"):
            engines[name] = eng
    touched = {k: r["stats"]["decode_pages_touched"] for k, r in runs.items()}
    for pre_ in ("", "fp_"):
        for name in ("dense", "page_topn_255"):
            same = all(np.array_equal(a, b) for a, b in
                       zip(runs[pre_ + name]["tokens"],
                           runs[pre_ + "paged"]["tokens"]))
            check(same, f"{pre_}{name} tokens differ from the "
                        f"{pre_}paged run's")
        check(touched[pre_ + "page_topn_255"] == touched[pre_ + "paged"],
              touched)
        check(touched[pre_ + "page_topn_64"] < touched[pre_ + "paged"],
              touched)
    check(touched["page_topn_64_unfused"] == touched["page_topn_64"]
          and runs["page_topn_64_unfused"]["digest"]
          == runs["page_topn_64"]["digest"],
          "page_topn 64: the fused selection differs from the unfused one")
    check(runs["paged_eager"]["digest"] == runs["paged"]["digest"],
          "paged: the graphed run's tokens differ from the eager run's")
    for pre_ in ("", "fp_"):
        agree = np.mean([np.mean(a == b) for a, b in
                         zip(runs[pre_ + "page_topn_64"]["tokens"],
                             runs[pre_ + "paged"]["tokens"])])
        log(f"phase 4: {pre_}dense and {pre_}page_topn 255 tokens equal the "
            f"{pre_}paged run's; {pre_}page_topn 64 attends "
            f"{touched[pre_ + 'page_topn_64']} of {touched[pre_ + 'paged']} "
            f"pages, {agree:.3f} of its tokens agree")
    log("phase 4: page_topn 64's pages and tokens equal the unfused "
        "selection's; the graphed paged run's tokens equal the eager run's")

    # ops.hamming_scores, the public entry point of K5, at the phase-2
    # shapes on packed bits of seeded Gaussian queries and keys
    gen_t = torch.Generator(device="cuda").manual_seed(4)
    qh = hamming.pack_bits(torch.randn((3, 1536, D), generator=gen_t,
                                       device="cuda"))
    kh = hamming.pack_bits(torch.randn((3, 4096, D), generator=gen_t,
                                       device="cuda"))
    scores = []
    for method, key in (("xor", hs.NAME), ("int8", K5_INT8)):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        scores.append(ops.hamming_scores(qh, kh, D, method=method))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check(counts == {**{k: 0 for k in counts}, hs.NAME: 1},
              (method, counts))
        log(f"phase 4 [hamming_scores {method}]: launches {counts}")
        total[key] = total.get(key, 0) + counts[hs.NAME]
    check(scores[0].shape == (3, 1536, 4096)
          and torch.equal(scores[0], scores[1])
          and int(scores[0].abs().max()) <= D, "hamming_scores")
    return total, engines, runs


# ---------------------------------------------------------------------------
# phase 5: the serving surface at full size
# ---------------------------------------------------------------------------

def _step_ms(tel) -> dict:
    """Host ms of a run's steps (schedule + execute + commit, from the
    telemetry's step events), by kind: whether the step moved pages to or
    from the host, and whether it ran a prefill chunk."""
    groups: dict[str, list[float]] = {}
    for e in tel.recorder.events():
        if e["kind"] != "step":
            continue
        swaps = e["swap_ins"] or any(rc["kind"] == "swap-out"
                                     for rc in e["reclaims"])
        key = (("swap" if swaps else "no swap")
               + (", prefill" if e["prefill"] else ", decode only"))
        t = e["timings"]
        groups.setdefault(key, []).append(
            (t["schedule"] + t["execute"] + t["commit"]) * 1e3)
    return groups


def _swap_transfer_ms(eng, n_pages: int) -> tuple[int, float, float]:
    """Bytes, and host ms each way, of swapping `n_pages` pages of the idle
    engine's pool out to pinned host memory and back in (the runner's own
    transfers, each ended by a device sync; pages [0, n_pages) are
    restored as they were)."""
    import torch
    runner = eng.runner
    pages = tuple(range(n_pages))
    before = eng.stats["swap_out_bytes"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner._swap_out_pages(-1, pages)
    runner._finalize_swaps()
    t1 = time.perf_counter()
    runner._swap_in_pages(-1, pages)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (eng.stats["swap_out_bytes"] - before, (t1 - t0) * 1e3,
            (t2 - t1) * 1e3)


def phase5(engines: dict, runs: dict) -> None:
    """Phase 4's workload through swap-out preemption, pipelined stepping
    and the asyncio front end, on the same 30-layer weights; each run's
    tokens must equal phase 4's unpreempted graphed run of its path, each
    engine must hold exactly 2 graphs, and each run must follow phase 4's
    launch rule (counts zeroed just before, read just after).

    (a) Paged with an overcommitted pool, n_pages 384 (the first four
        requests need 171 + 136 + 116 + 78 = 501 pages by their last
        token), and a 1024-page host pool, binary and fp: swap-outs > 0,
        nothing recomputed, both pools drained; host ms of steps that swap
        against steps that do not, and the transfer time of a 171-page
        victim each way. Then the same pool without swap space, which
        preempts by recompute: its tokens are reported against phase 4's,
        not checked (the re-prefill runs the prefill graph's products).
    (b) Paged, sync and pipelined (`step_pipelined`) in turns S P P S on
        one engine whose graphs were captured first: tok/s, ITL p50/p95,
        TTFT p50 and the overlap fraction.
    (c) An AsyncEngine over a fresh paged engine, from its first step (so
        both captures happen in its worker thread), then again, then the
        pipelined and the sync step on that engine, all 8 requests up
        front: streamed tokens == results == phase 4's."""
    import asyncio

    import numpy as np
    import torch
    from repro_torch.kernels import binary_paged_decode_attention as pdec
    from repro_torch.kernels import ops
    from repro_torch.serve import AsyncEngine, Telemetry
    model = engines["paged"].runner.model
    cfg = engines["paged"].cfg
    _, prompts, gen, base = _workload(cfg)

    def same(name, r, ref):
        check(r["digest"] == runs[ref]["digest"] and all(
            np.array_equal(a, b) for a, b in zip(r["tokens"],
                                                 runs[ref]["tokens"])),
              f"{name}: tokens differ from phase 4's {ref} run")

    def summary(r) -> str:
        return (f"{r['stats']['tokens_generated'] / r['wall']:.2f} "
                f"generated tok/s, wall {r['wall']:.3f} s, ITL p50/p95 "
                f"{np.percentile(r['itl'], 50):.2f}/"
                f"{np.percentile(r['itl'], 95):.2f} ms, TTFT p50 "
                f"{np.percentile(r['ttft'], 50):.2f} ms")

    # (a) swap-out preemption
    for pre_, binary in (("", True), ("fp_", False)):
        name = f"{pre_}paged_swap"
        tel = Telemetry(trace_capacity=4096)
        eng = _engine(cfg, model, dict(base, paged=True, n_pages=384,
                                       swap_pages=1024, binary=binary),
                      "cuda", telemetry=tel)
        r = _serve_run(eng, prompts, gen)
        st = r["stats"]
        check(st["swap_outs"] > 0, f"{name}: no swap-out happened (void)")
        check(st["replayed_tokens"] == 0 and st["swap_ins"]
              == st["swap_outs"], (name, st))
        check(eng.allocator.in_use == 0 and eng.swap.in_use == 0,
              f"{name}: pools not drained")
        check(eng.runner.graph_count() == 2,
              (name, "graphs", eng.runner.graph_count()))
        _check_launches(name, eng, r, (pdec,) if binary else ())
        same(name, r, f"{pre_}paged")
        log(f"phase 5 [{name}]: {r['steps']} steps, {st['preemptions']} "
            f"preemptions, {st['swap_outs']} swap-outs / {st['swap_ins']} "
            f"swap-ins, {st['swapped_tokens']} tokens restored, "
            f"{st['replayed_tokens']} recomputed, swap_out_bytes "
            f"{st['swap_out_bytes']}, swap_in_bytes {st['swap_in_bytes']}, "
            f"peak host pool {eng.swap.peak_in_use} pages, launches "
            f"{r['counts']}, tokens sha1 {r['digest']} (== phase 4's "
            f"{pre_}paged)")
        log(f"phase 5 [{name}]: {summary(r)}")
        for kind, ms in sorted(_step_ms(tel).items()):
            log(f"phase 5 [{name}]: steps with {kind}: {len(ms)}, host ms "
                f"a step median {np.median(ms):.3f}, p95 "
                f"{np.percentile(ms, 95):.3f}, max {max(ms):.3f}")
        victim = 171                  # the longest request's pages
        for _ in range(3):
            nbytes, out_ms, in_ms = _swap_transfer_ms(eng, victim)
            log(f"phase 5 [{name}]: a {victim}-page victim, {nbytes} bytes: "
                f"swap-out (gather + copy to pinned host + sync) "
                f"{out_ms:.3f} ms ({nbytes / out_ms / 1e6:.2f} GB/s), "
                f"swap-in (copy + scatter + sync) {in_ms:.3f} ms "
                f"({nbytes / in_ms / 1e6:.2f} GB/s)")

    # the same pool without host swap space preempts by recompute, which
    # re-prefills generated tokens through the prefill graph (other matrix
    # shapes than the decode graph's, so cuBLAS may round differently):
    # its tokens are reported against phase 4's, not checked
    eng = _engine(cfg, model, dict(base, paged=True, n_pages=384), "cuda",
                  telemetry=Telemetry())
    r = _serve_run(eng, prompts, gen)
    st = r["stats"]
    check(eng.runner.graph_count() == 2 and st["replayed_tokens"] > 0,
          ("paged_recompute", eng.runner.graph_count(), st))
    _check_launches("paged_recompute", eng, r, (pdec,))
    agree = [int(np.sum(a == b)) for a, b in zip(r["tokens"],
                                                 runs["paged"]["tokens"])]
    log(f"phase 5 [paged_recompute]: {st['preemptions']} preemptions, "
        f"{st['replayed_tokens']} tokens recomputed, {summary(r)}; tokens "
        f"sha1 {r['digest']}, {sum(agree)} of {gen * len(agree)} equal to "
        f"phase 4's paged run ({agree} by request)")

    # (b) sync against pipelined, in turns on one engine, its two graphs
    # captured first
    eng = _engine(cfg, model, dict(base, paged=True), "cuda",
                  telemetry=Telemetry(trace_capacity=4096))
    eng.generate([prompts[0][:600]], 2)
    for i, mode in enumerate(("sync", "pipelined", "pipelined", "sync")):
        eng.reset_stats()
        r = _serve_run(eng, prompts, gen, step=(
            eng.step_pipelined if mode == "pipelined" else eng.step))
        name = f"paged_{mode}_{i}"
        check(eng.runner.graph_count() == 2,
              (name, "graphs", eng.runner.graph_count()))
        _check_launches(name, eng, r, (pdec,))
        same(name, r, "paged")
        ov = eng.overlap_stats()
        log(f"phase 5 [{name}]: {summary(r)}, {r['steps']} steps"
            + (f", overlap_frac {ov['overlap_frac']:.3f} "
               f"({ov['overlap_s'] * 1e3:.2f} of {ov['schedule_s'] * 1e3:.2f}"
               f" ms of scheduling hidden)" if mode == "pipelined" else ""))

    # (c) the asyncio front end, from a fresh engine's first step (both
    # captures in its worker thread), then again warm, then the pipelined
    # and the sync step on the same engine; all 8 requests up front
    eng = _engine(cfg, model, dict(base, paged=True), "cuda",
                  telemetry=Telemetry(trace_capacity=4096))

    async def serve():
        aeng = AsyncEngine(eng)

        async def client(prompt):
            h = await aeng.submit(prompt, max_new_tokens=gen)
            streamed = [t async for t in h]
            return h.request_id, streamed, await h.result()

        runner = asyncio.ensure_future(aeng.run())
        outs = await asyncio.gather(*[client(p) for p in prompts])
        aeng.stop()
        await runner
        eng.scheduler.token_sink = None
        return outs, aeng.finished_metrics

    for name in ("paged_async_first", "paged_async",
                 "paged_pipelined_up_front", "paged_sync_up_front"):
        eng.reset_stats()
        if name.endswith("_up_front"):
            r = _serve_run(eng, prompts, gen, stagger=0, step=(
                eng.step_pipelined if "pipelined" in name else eng.step))
        else:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            outs, metrics = asyncio.run(serve())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            for rid, streamed, result in outs:
                check(np.array_equal(np.asarray(streamed, np.int32), result),
                      f"{name} request {rid}: streamed tokens != result")
            r = _result(eng, [rid for rid, _, _ in outs],
                        {rid: res for rid, _, res in outs}, gen, counts,
                        wall, None, metrics)
        check(eng.runner.graph_count() == 2,
              (name, "graphs", eng.runner.graph_count()))
        _check_launches(name, eng, r, (pdec,))
        same(name, r, "paged")
        log(f"phase 5 [{name}]: all 8 requests up front, {summary(r)}, "
            f"launches {r['counts']}; "
            + ("streamed == result == " if "async" in name else "")
            + "phase 4's paged tokens")


# ---------------------------------------------------------------------------
# phase 6: llama-3.2-vision-11b at full size
# ---------------------------------------------------------------------------

def _vision_workload(cfg):
    """Phase 6's workload: 8 prompts of 512-2048 tokens drawn from seed 0,
    16 new tokens each; requests 0, 2, 4 and 6 carry seeded image
    embeddings [1, 1601, 1280] (float32). The ServeConfig fields every run
    shares."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(512, 2049, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    extras = [{"image_embeds": rng.standard_normal(
        (1, cfg.n_image_tokens, cfg.frontend_dim), dtype=np.float32)}
        if i % 2 == 0 else None for i in range(8)]
    base = dict(max_len=4096, batch_slots=4, prefill_chunk=512,
                page_size=16)
    return lens, prompts, extras, 16, base


def _launch_rule(eng, st) -> dict:
    """Phases 6-8's launch rule, from the engine's layer kinds, with the
    split counters: K1 once an attention layer for each prefill chunk
    (self- and cross-attention layers; the cross layers' non-causal); a
    paged decode step K2 at each self-attention layer (K3 beside it with
    page_topn) and K4 at each cross layer; a dense decode step K4 at every
    attention layer (the cross layers' tagged); the full-precision
    baseline none, nor an SSM layer (no kernel of its own)."""
    from repro_torch.kernels import binary_decode_attention as dec
    from repro_torch.kernels import binary_page_score as pscore
    from repro_torch.kernels import binary_paged_decode_attention as pdec
    from repro_torch.kernels import binary_prefill_attention as pre
    from repro_torch.kernels import hamming_score as hs
    from repro_torch.models import transformer as T
    kinds = T.layer_kinds(eng.cfg)
    n_a, n_c = kinds.count("A"), kinds.count("C")
    want = {m.NAME: 0 for m in (pre, pdec, pscore, dec, hs)}
    want[f"{pre.NAME}.noncausal_launches"] = 0
    want[f"{dec.NAME}.cross_launches"] = 0
    if not eng.scfg.binary:
        return want
    steps = st["decode_steps"]
    want[pre.NAME] = (n_a + n_c) * st["prefill_chunks"]
    want[f"{pre.NAME}.noncausal_launches"] = n_c * st["prefill_chunks"]
    want[f"{dec.NAME}.cross_launches"] = n_c * steps
    if eng.scfg.paged:
        want[pdec.NAME] = n_a * steps
        want[dec.NAME] = n_c * steps
        if eng.scfg.page_topn is not None:
            want[pscore.NAME] = n_a * steps
    else:
        want[dec.NAME] = (n_a + n_c) * steps
    return want


def phase6():
    """llama-3.2-vision-11b as published (40 layers, AAAAC x 8, bf16),
    weights drawn on the card from seed 0, served at full width: 4 slots,
    512-token chunks, 16-token pages, max_len 4096, phase 6's workload.
    Runs: paged (cross caches in a pooled state allocation), dense,
    page_topn 255, full-precision paged, and paged with a pool small
    enough to preempt and a host pool (swap-out preemption). Each engine
    holds 2 graphs and follows `_launch_rule` (counts zeroed just
    before a run, read just after); dense and page_topn-255 tokens equal
    paged's bit for bit; the swap run swaps at least once, each victim's
    state entry with its pages, and gives paged's tokens; the state pool
    checks and every pool drains. Returns the launch totals of the runs
    by vision record of phase 2, as the wrappers counted them (the split
    counters tell a causal K1 launch from a cross layer's, a self-attention
    layer's K4 from a cross layer's), and the paged engine, for
    --profile."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import binary_decode_attention as dec
    from repro_torch.kernels import binary_page_score as pscore
    from repro_torch.kernels import binary_paged_decode_attention as pdec
    from repro_torch.kernels import binary_prefill_attention as pre
    from repro_torch.models import transformer as T
    from repro_torch.serve import Telemetry
    from repro_torch.serve.paged import pages_needed
    cfg = get_config(VISION)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    kinds = T.layer_kinds(cfg)
    n_a, n_c = kinds.count("A"), kinds.count("C")
    log(f"phase 6: {cfg.name} {cfg.n_layers} layers ({n_a} self-attention, "
        f"{n_c} cross), {cfg.param_dtype}, {n_params} parameters "
        f"({n_params / 1e9:.2f} B, {n_params * 2 / 1e9:.2f} GB), drawn on "
        f"the card in {draw_s:.2f} s")
    lens, prompts, extras, gen, base = _vision_workload(cfg)
    log(f"phase 6: prompts {lens.tolist()}, images on requests 0, 2, 4, 6, "
        f"{gen} new tokens each")
    # the first four requests need 352 pages by their last token; on 234
    # the scheduler (run alone on the host) only preempts victims with
    # nothing computed yet, on 200 it swaps 12 out
    swap_pool = 200
    check(sum(pages_needed(int(n) + gen, base["page_size"])
              for n in lens[:4]) > swap_pool, "the swap pool overcommits")
    paths = {"paged": dict(paged=True), "dense": dict(paged=False),
             "page_topn_255": dict(paged=True, page_topn=255),
             "fp_paged": dict(paged=True, binary=False),
             "paged_swap": dict(paged=True, n_pages=swap_pool,
                                swap_pages=1024)}
    runs, kept = {}, None
    totals = dict.fromkeys((K1_VISION, K1_CROSS, K2_VISION, K3_VISION,
                            K4_CROSS, K4_VISION), 0)
    for name, kw in paths.items():
        eng = _engine(cfg, model, dict(base, **kw), "cuda",
                      telemetry=Telemetry())
        moved: list = []
        _swap_spy(eng, moved)
        torch.cuda.reset_peak_memory_stats()
        r = _serve_run(eng, prompts, gen, extras=extras)
        st = r["stats"]
        check(eng.runner.graph_count() == 2,
              (name, "graphs", eng.runner.graph_count()))
        want = _launch_rule(eng, st)
        check(r["splits"] == want and st["decode_steps"] > 0,
              (name, r["splits"], want))
        check(eng.allocator is None or eng.allocator.in_use == 0,
              f"{name}: page pool not drained")
        if eng.statepool is not None:
            eng.statepool.check()
            check(eng.statepool.n_held == 0, f"{name}: state pool held")
        cache_b = eng.runner.cache_device_bytes()[0]
        state_b = sum(leaf.numel() * leaf.element_size()
                      for i in eng.runner._cross_layers
                      for leaf in eng.runner.caches[i].values())
        log(f"phase 6 [{name}]: {r['steps']} steps, {st['prefill_chunks']} "
            f"prefill chunks, {st['decode_steps']} decode steps, "
            f"{eng.runner.graph_count()} step graphs, launches "
            f"{r['splits']}, tokens sha1 {r['digest']}; cache bytes "
            f"{cache_b} of which cross "
            f"{'state pool' if eng.statepool is not None else 'dense'} "
            f"{state_b}")
        log(f"phase 6 [{name}]: {_latency(r)}, peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if name == "paged_swap":
            check(st["swap_outs"] > 0, "paged_swap: no swap-out (void)")
            check(st["replayed_tokens"] == 0
                  and st["swap_ins"] == st["swap_outs"], st)
            check(len(moved) == st["swap_outs"]
                  and all(e >= 0 for e in moved),
                  ("paged_swap: a victim's state entry did not move", moved))
            check(eng.swap.in_use == 0, "paged_swap: host pool not drained")
            log(f"phase 6 [paged_swap]: {swap_pool}-page pool, "
                f"{st['preemptions']} preemptions, {st['swap_outs']} "
                f"swap-outs (state entries {moved}) / {st['swap_ins']} "
                f"swap-ins, swap_out_bytes {st['swap_out_bytes']}, "
                f"swap_in_bytes {st['swap_in_bytes']}")
        got = r["splits"]       # measured by the wrappers, through replays
        noncausal = got[f"{pre.NAME}.noncausal_launches"]
        cross = got[f"{dec.NAME}.cross_launches"]
        totals[K1_VISION] += got[pre.NAME] - noncausal
        totals[K1_CROSS] += noncausal
        totals[K2_VISION] += got[pdec.NAME]
        totals[K3_VISION] += got[pscore.NAME]
        totals[K4_CROSS] += cross
        totals[K4_VISION] += got[dec.NAME] - cross
        runs[name] = r
        if name == "paged":
            kept = eng
        else:
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    for name in ("dense", "page_topn_255", "paged_swap"):
        check(runs[name]["digest"] == runs["paged"]["digest"] and all(
            np.array_equal(a, b) for a, b in
            zip(runs[name]["tokens"], runs["paged"]["tokens"])),
            f"phase 6: {name} tokens differ from the paged run's")
    log("phase 6: dense, page_topn 255 and swap tokens equal the paged "
        "run's bit for bit")
    return totals, kept


# ---------------------------------------------------------------------------
# phase 7: mamba2-130m at full size
# ---------------------------------------------------------------------------

def _state_bytes(eng) -> int:
    """Bytes of the engine's SSM state (dense rows or the state pool)."""
    return sum(leaf.numel() * leaf.element_size()
               for i in eng.runner._ssm_layers
               for leaf in eng.runner.caches[i].values())


def phase7():
    """mamba2-130m as published (24 SSM layers, d 768, state 128, expand 2,
    head_dim 64, chunk 128, vocab 50280, bf16), seeded weights drawn on
    the card, served with phase 4's workload (4 slots, 512-token chunks,
    16-token pages, max_len 4096, 8 requests of 512-3072 tokens, 32 new
    tokens each), HAD off as the model has no attention (the JAX
    launcher's binary=False). Runs: paged (pooled SSM state), dense
    (per-slot state rows), a 384-page pool with a 1024-page host pool
    (swap-out preemption: each victim's state entry moves with its
    pages), the same pool without host space (recompute preemption: the
    victim restarts from zero state), and 4 requests sharing a 1024-token
    prefix one at a time, warm (prefix cache: pages and a state checkpoint
    restored) and cold (the paged engine). Each engine holds 2 graphs and
    launches no kernel of the port (`_launch_rule`); dense, swap and
    recompute tokens equal paged's, warm tokens equal cold's, with
    state_restores > 0; every pool drains. Returns the paged engine, for
    --profile."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import Telemetry
    cfg = get_config(MAMBA)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 7: {cfg.name} {cfg.n_layers} layers {cfg.layer_pattern!r}, "
        f"d {cfg.d_model}, {cfg.ssm_heads} SSM heads of {cfg.ssm_head_dim}, "
        f"state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, {cfg.param_dtype}, "
        f"{n_params} parameters, drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    lens, prompts, gen, base = _workload(cfg)
    base = dict(base, binary=False)
    log(f"phase 7: prompts {lens.tolist()}, {gen} new tokens each")
    paths = {"paged": dict(paged=True), "dense": dict(paged=False),
             "paged_swap": dict(paged=True, n_pages=384, swap_pages=1024),
             "paged_recompute": dict(paged=True, n_pages=384)}
    runs, kept = {}, None
    for name, kw in paths.items():
        eng = _engine(cfg, model, dict(base, **kw), "cuda",
                      telemetry=Telemetry())
        moved: list = []
        _swap_spy(eng, moved)
        torch.cuda.reset_peak_memory_stats()
        r = _serve_run(eng, prompts, gen)
        st = r["stats"]
        check(eng.runner.graph_count() == 2,
              (name, "graphs", eng.runner.graph_count()))
        check(r["splits"] == _launch_rule(eng, st) and st["decode_steps"],
              (name, r["splits"]))
        check(eng.allocator is None or eng.allocator.in_use == 0,
              f"{name}: page pool not drained")
        if eng.statepool is not None:
            eng.statepool.check()
            check(eng.statepool.n_held == 0, f"{name}: state pool held")
        log(f"phase 7 [{name}]: {r['steps']} steps, {st['prefill_chunks']} "
            f"prefill chunks, {st['decode_steps']} decode steps, "
            f"{eng.runner.graph_count()} step graphs, {st['preemptions']} "
            f"preemptions, tokens sha1 {r['digest']}; SSM state "
            f"{'pool' if eng.statepool is not None else 'rows'} "
            f"{_state_bytes(eng)} bytes, cache bytes "
            f"{eng.runner.cache_device_bytes()[0]}")
        log(f"phase 7 [{name}]: {_latency(r)}, peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if name == "paged_swap":
            check(st["swap_outs"] > 0, "paged_swap: no swap-out (void)")
            check(st["replayed_tokens"] == 0
                  and st["swap_ins"] == st["swap_outs"], st)
            check(len(moved) == st["swap_outs"]
                  and all(e >= 0 for e in moved),
                  ("paged_swap: a victim's state entry did not move", moved))
            check(eng.swap.in_use == 0, "paged_swap: host pool not drained")
            log(f"phase 7 [paged_swap]: {st['swap_outs']} swap-outs (state "
                f"entries {moved}) / {st['swap_ins']} swap-ins, "
                f"swap_out_bytes {st['swap_out_bytes']}, swap_in_bytes "
                f"{st['swap_in_bytes']}")
        if name == "paged_recompute":
            check(st["replayed_tokens"] > 0, "recompute: nothing replayed")
            log(f"phase 7 [paged_recompute]: {st['replayed_tokens']} tokens "
                f"recomputed from zero state")
        runs[name] = r
        if name == "paged":
            kept = eng
        else:
            del eng
            gc.collect()
    for name in ("dense", "paged_swap", "paged_recompute"):
        agree = [int(np.sum(a == b)) for a, b in
                 zip(runs[name]["tokens"], runs["paged"]["tokens"])]
        check(runs[name]["digest"] == runs["paged"]["digest"],
              (f"phase 7: {name} tokens differ from the paged run's",
               agree))
    log("phase 7: dense, swap and recompute tokens equal the paged run's "
        "bit for bit")

    # prefix caching: 4 prompts sharing a 1024-token prefix, one at a time
    rng = np.random.default_rng(7)
    shared = rng.integers(0, cfg.vocab_size, 1024).astype(np.int32)
    shared_prompts = [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, n).astype(np.int32)]) for n in (300, 700, 150,
                                                           1100)]
    warm_eng = _engine(cfg, model, dict(base, paged=True, prefix_cache=True),
                       "cuda", telemetry=Telemetry())
    outs = {}
    for name, eng in (("cold", kept), ("warm", warm_eng)):
        eng.reset_stats()
        outs[name] = [_generate(eng, [p], [None], gen)[0]
                      for p in shared_prompts]
        st = dict(eng.stats)
        check(eng.runner.graph_count() == 2, (name, "graphs"))
        log(f"phase 7 [prefix {name}]: cached_tokens {st['cached_tokens']}, "
            f"state_restores {st['state_restores']}, state_ckpt_bytes "
            f"{st['state_ckpt_bytes']}, prefill_tokens "
            f"{st['prefill_tokens']}")
    st = dict(warm_eng.stats)
    check(st["state_restores"] > 0 and st["cached_tokens"] > 0, st)
    check(all(np.array_equal(a, b) for a, b in zip(outs["warm"],
                                                    outs["cold"])),
          "phase 7: prefix-warm tokens differ from the cold run's")
    warm_eng.statepool.check()
    log("phase 7: prefix-warm tokens equal the cold run's bit for bit")
    del warm_eng
    return kept


# ---------------------------------------------------------------------------
# phase 8: dbrx-132b at full width
# ---------------------------------------------------------------------------

DBRX_LAYERS = 8            # of 40: 54.6 GB of bf16 weights on one card


def phase8():
    """dbrx-132b at full width (d 6144, 48 heads over 8 kv heads of 128,
    16 experts top-4 of d_ff 10752, vocab 100352, bf16) and 8 of its 40
    layers, seeded weights drawn on the card, served with phase 6's
    prompts (8 requests of 512-2048 tokens, 16 new tokens each, no
    images): paged (K1 + K2), dense (K1 + K4), page_topn 255 (K3 + K2)
    and full-precision paged. Each engine holds 2 graphs and follows
    `_launch_rule` (counts zeroed just before a run, read just after);
    dense and page_topn-255 tokens equal paged's bit for bit; every pool
    drains. Returns the launch totals by phase-2 dbrx record, and the
    paged engine, for --profile."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import binary_decode_attention as dec
    from repro_torch.kernels import binary_page_score as pscore
    from repro_torch.kernels import binary_paged_decode_attention as pdec
    from repro_torch.kernels import binary_prefill_attention as pre
    from repro_torch.models import transformer as T
    from repro_torch.serve import Telemetry
    cfg = get_config(DBRX, n_layers=DBRX_LAYERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 8: {cfg.name} {cfg.n_layers} of 40 layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.n_experts} experts "
        f"top-{cfg.experts_per_token} of d_ff {cfg.d_ff}, "
        f"{cfg.param_dtype}, {n_params} parameters ({n_params / 1e9:.2f} B, "
        f"{n_params * 2 / 1e9:.2f} GB), drawn on the card in {draw_s:.2f} s")
    lens, prompts, _, gen, base = _vision_workload(cfg)
    log(f"phase 8: prompts {lens.tolist()}, {gen} new tokens each")
    paths = {"paged": dict(paged=True), "dense": dict(paged=False),
             "page_topn_255": dict(paged=True, page_topn=255),
             "fp_paged": dict(paged=True, binary=False)}
    runs, kept = {}, None
    totals = dict.fromkeys((K1_DBRX, K2_DBRX, K3_DBRX, K4_DBRX), 0)
    for name, kw in paths.items():
        eng = _engine(cfg, model, dict(base, **kw), "cuda",
                      telemetry=Telemetry())
        torch.cuda.reset_peak_memory_stats()
        r = _serve_run(eng, prompts, gen)
        st = r["stats"]
        check(eng.runner.graph_count() == 2,
              (name, "graphs", eng.runner.graph_count()))
        want = _launch_rule(eng, st)
        check(r["splits"] == want and st["decode_steps"] > 0,
              (name, r["splits"], want))
        check(eng.allocator is None or eng.allocator.in_use == 0,
              f"{name}: page pool not drained")
        log(f"phase 8 [{name}]: {r['steps']} steps, {st['prefill_chunks']} "
            f"prefill chunks, {st['decode_steps']} decode steps, "
            f"{eng.runner.graph_count()} step graphs, launches "
            f"{r['counts']}, tokens sha1 {r['digest']}; cache bytes "
            f"{eng.runner.cache_device_bytes()[0]}, decode KV bytes "
            f"{st['decode_hbm_bytes']}")
        log(f"phase 8 [{name}]: {_latency(r)}, peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        got = r["splits"]
        totals[K1_DBRX] += got[pre.NAME]
        totals[K2_DBRX] += got[pdec.NAME]
        totals[K3_DBRX] += got[pscore.NAME]
        totals[K4_DBRX] += got[dec.NAME]
        runs[name] = r
        if name == "paged":
            kept = eng
        else:
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    for name in ("dense", "page_topn_255"):
        check(runs[name]["digest"] == runs["paged"]["digest"] and all(
            np.array_equal(a, b) for a, b in
            zip(runs[name]["tokens"], runs["paged"]["tokens"])),
            f"phase 8: {name} tokens differ from the paged run's")
    log("phase 8: dense and page_topn 255 tokens equal the paged run's bit "
        "for bit")
    return totals, kept


# ---------------------------------------------------------------------------
# phase 9: HAD distillation and training
# ---------------------------------------------------------------------------

# (a)'s schedule: one step in each stage (c 5.0, 0.5, 0.05, 0.05)
STAGE_SCHED = dict(c0=5.0, decay=0.1, stage3_steps=1, stage4_steps=1)
# CPU against card after one step: metrics at 1e-4 relative; a student
# leaf within a tenth of one AdamW step (lr 1e-3), since an element whose
# gradient is a cancellation at float noise moves a noise-chosen part of
# a step (tests/test_torch_train.py's STEP_TOL)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)


def _to(batch: dict, dev) -> dict:
    import torch
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _timed_steps(fn, state, batches, dev) -> tuple:
    """Run `fn` over `batches`, the host waiting for each step; returns
    (state, per-step metrics as floats, per-step seconds)."""
    import torch
    hist, secs = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state, _to(b, dev))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        hist.append({k: float(v) for k, v in m.items()})
    return state, hist, secs


def _check_schedule(tag, hist, sched) -> None:
    """Every metric finite; stage and c those of the schedule at each
    step; the loss att_kl + out_kl through stage 3 and out_kl after (the
    attention-KL term on through stage 3 only)."""
    import math

    import numpy as np
    for i, m in enumerate(hist):
        check(all(math.isfinite(v) for v in m.values()), (tag, i, m))
        check(m["stage"] == sched.stage_at_traced(i), (tag, i, m["stage"]))
        check(np.isclose(m["c"], float(sched.c_at(i)), rtol=1e-6),
              (tag, i, m["c"]))
        att = m["att_kl"] if i < sched.stage3_end else 0.0
        check(np.isclose(m["loss"], att + m["out_kl"] + 0.01 * m["moe_aux"],
                         rtol=1e-5, atol=1e-6), (tag, i, m))
    check(sorted({m["stage"] for m in hist}) == [1, 2, 3, 4], tag)


def phase9a() -> None:
    """smollm-135m at its reduced widths (one layer, d 64, 4 heads over 2,
    float32) on the CPU and on the card from the same seeded teacher, the
    sigmas of Eq. 12 estimated on the CPU: one pretrain step, then one
    distill step in each of the four stages from the same teacher, student
    and batch (the step counter set to the stage's first step). Loss,
    att_kl, out_kl and grad_norm allclose (METRIC_TOL), every updated
    student leaf within TRAIN_TOL. Stages 3-4 take the logits as integer
    sign products times sigma_q * sigma_k, so ties at the top-N threshold
    stay ties on both devices."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.binarize import CSchedule
    from repro_torch.core.distill import DistillConfig
    from repro_torch.data import lm_stream
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam, schedules
    from repro_torch.train import steps as STEPS
    cfg = get_config("smollm-135m", reduced=True)
    teacher = T.init_params(cfg, torch.Generator().manual_seed(9))
    data = lm_stream(vocab=cfg.vocab_size, batch=2, seq=128, seed=9)
    batches = [next(data) for _ in range(3)]
    STEPS.estimate_and_set_sigmas(teacher, cfg, [_to(b, "cpu")
                                                 for b in batches[:2]])
    opt = adam.AdamWConfig()
    dcfg = DistillConfig(schedule=CSchedule(**STAGE_SCHED),
                         lr_stages_123=1e-3, lr_stage_4=1e-4)
    runs = {}
    for dev in ("cpu", "cuda"):
        out = []
        st = STEPS.init_pretrain_state(
            cfg, opt, model=T.init_params(cfg, torch.Generator()
                                          .manual_seed(9)), device=dev)
        fn = STEPS.build_pretrain_step(cfg, opt, schedules.constant(1e-3))
        st, m = fn(st, _to(batches[2], dev))
        out.append(({k: float(v) for k, v in m.items()},
                    {n: t.detach().cpu() for n, t in
                     T.named_tensors(st["params"]).items()}))
        fn = STEPS.build_distill_step(cfg, dcfg, opt)
        for stage in (1, 2, 3, 4):
            st = STEPS.init_distill_state(cfg, opt,
                                          teacher=copy.deepcopy(teacher),
                                          device=dev)
            st["step"].fill_(stage - 1)
            st, m = fn(st, _to(batches[2], dev))
            check(float(m["stage"]) == stage, (dev, stage, m["stage"]))
            out.append(({k: float(v) for k, v in m.items()},
                        {n: t.detach().cpu() for n, t in
                         T.student_tensors(cfg, st["student"]).items()}))
        runs[dev] = out
    names = ["pretrain"] + [f"distill stage {i}" for i in (1, 2, 3, 4)]
    for name, (mc, tc), (mg, tg) in zip(names, runs["cpu"], runs["cuda"]):
        for k in mc:
            check(np.allclose(mg[k], mc[k], **METRIC_TOL),
                  (name, k, mg[k], mc[k]))
        worst = max(float((tg[n] - tc[n]).abs().max()) for n in tc)
        for n in tc:
            check(np.allclose(tg[n].numpy(), tc[n].numpy(), **TRAIN_TOL),
                  (name, n))
        keys = [k for k in ("loss", "att_kl", "out_kl", "grad_norm")
                if k in mc]
        log(f"phase 9 (a): {name}: cpu/cuda " + ", ".join(
            f"{k} {mc[k]:.6g}/{mg[k]:.6g}" for k in keys)
            + f"; leaves max |cuda - cpu| {worst:.3e} over {len(tc)} "
              f"tensors")


def _cls_accuracy(model, cfg, tasks, mode: str, n: int) -> float:
    """Accuracy of the class logits at position 0 (the benchmarks'
    encoder readout) over `tasks` (TaskBatches), in `mode`."""
    import torch
    from repro_torch.models import transformer as T
    right = total = 0
    with torch.no_grad():
        for tb in tasks:
            lg = T.forward(model, _to(tb.inputs, "cuda"), cfg=cfg, mode=mode,
                           att={"n": n}).logits[:, 0, :cfg.vocab_size]
            right += int((lg.argmax(-1).cpu().numpy() == tb.labels).sum())
            total += len(tb.labels)
    return right / total


def phase9b() -> None:
    """bert-base-had as published (12 layers, d 768, 12 heads, context
    256, N 30: the paper's GLUE setting), float32 as the JAX package's
    config: a teacher fitted for 60 steps to `classification_task` (2
    classes, batch 16; cross entropy on the class logits at position 0,
    AdamW lr 1e-4), Eq. 12 sigmas from 4 batches, then `tiny_schedule(5)`
    through all four stages (25 steps, output_positions "last"). Checked:
    every metric finite; stage and c those of the schedule; the attention
    KL in the loss through stage 3 only. Printed: step ms, tokens/s, peak
    memory, and the had_eval student's accuracy beside the std teacher's
    on 8 held-out batches (reported, not checked)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import losses
    from repro_torch.core.distill import DistillConfig, tiny_schedule
    from repro_torch.data import classification_task, take
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam
    from repro_torch.train import steps as STEPS
    cfg = get_config("bert-base-had")
    seq, batch = 256, 16
    n = cfg.had.topn(seq)
    check(n == 30, n)
    task = classification_task(vocab=cfg.vocab_size, n_classes=2,
                               batch=batch, seq=seq, seed=0)
    held = take(classification_task(vocab=cfg.vocab_size, n_classes=2,
                                    batch=batch, seq=seq, seed=1), 8)
    teacher = T.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0), device="cuda")
    named = T.named_tensors(teacher)
    for t in named.values():
        t.requires_grad_(True)
    tcfg = adam.AdamWConfig(grad_clip=1.0)
    opt = adam.init(named, tcfg)
    t0 = time.perf_counter()
    for _ in range(60):
        tb = next(task)
        out = T.forward(teacher, _to(tb.inputs, "cuda"), cfg=cfg)
        loss = losses.softmax_cross_entropy(
            out.logits[:, 0, :cfg.vocab_size],
            torch.from_numpy(tb.labels).to("cuda"))
        grads = dict(zip(named, torch.autograd.grad(
            loss, list(named.values()), allow_unused=True)))
        grads = {k: torch.zeros_like(named[k]) if g is None else g
                 for k, g in grads.items()}
        opt, _ = adam.update(grads, opt, named, lr=1e-4, cfg=tcfg)
    torch.cuda.synchronize()
    for t in named.values():
        t.requires_grad_(False)
    log(f"phase 9 (b): {cfg.name} {cfg.n_layers} layers d {cfg.d_model}, "
        f"teacher fitted 60 steps in {time.perf_counter() - t0:.1f} s "
        f"(last CE {loss.item():.4f})")
    STEPS.estimate_and_set_sigmas(
        teacher, cfg, [_to(tb.inputs, "cuda") for tb in take(task, 4)])
    sched = tiny_schedule(5)
    dcfg = DistillConfig(schedule=sched)
    opt_cfg = adam.AdamWConfig()
    state = STEPS.init_distill_state(cfg, opt_cfg, teacher=teacher,
                                     device="cuda")
    fn = STEPS.build_distill_step(
        cfg, dcfg, opt_cfg, STEPS.StepConfig(output_positions="last"))
    torch.cuda.reset_peak_memory_stats()
    state, hist, secs = _timed_steps(
        fn, state, [tb.inputs for tb in take(task, sched.stage4_end)],
        "cuda")
    _check_schedule("9b", hist, sched)
    ms = float(np.mean(secs[1:])) * 1e3
    log(f"phase 9 (b): {sched.stage4_end} distill steps through stages "
        f"{sorted({int(m['stage']) for m in hist})}, batch {batch} x {seq}, "
        f"N {n}: step {ms:.2f} ms (mean of steps 2-{len(secs)}; first "
        f"{secs[0] * 1e3:.1f} ms), {batch * seq / ms * 1e3:.0f} tokens/s, "
        f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"att_kl {hist[0]['att_kl']:.4f} -> {hist[-1]['att_kl']:.4f}, "
        f"out_kl {hist[0]['out_kl']:.4f} -> {hist[-1]['out_kl']:.4f}")
    acc_t = _cls_accuracy(teacher, cfg, held, "std", n)
    acc_s = _cls_accuracy(state["student"], cfg, held, "had_eval", n)
    log(f"phase 9 (b): accuracy on {8 * batch} held-out samples: teacher "
        f"(std) {acc_t:.4f}, student (had_eval, N {n}) {acc_s:.4f} "
        f"(reported, not checked)")


def phase9c() -> None:
    """deit-t as published (12 layers, d 192, 3 heads of 64), float32:
    197 patch embeddings of width 192 from `patch_task` enter through
    `frames` and frontend_proj, plus learned positions; Eq. 12 sigmas
    from 2 batches, then `tiny_schedule(1)` (5 distill steps, all four
    stages) at batch 16: every metric finite, the schedule kept."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.distill import DistillConfig, tiny_schedule
    from repro_torch.data import patch_task, take
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam
    from repro_torch.train import steps as STEPS
    cfg = get_config("deit-t")
    task = patch_task(dim=cfg.frontend_dim, n_patches=197, n_classes=1000,
                      batch=16, seed=0)
    teacher = T.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0), device="cuda")
    STEPS.estimate_and_set_sigmas(
        teacher, cfg, [_to(tb.inputs, "cuda") for tb in take(task, 2)])
    sched = tiny_schedule(1)
    opt = adam.AdamWConfig()
    state = STEPS.init_distill_state(cfg, opt, teacher=teacher,
                                     device="cuda")
    fn = STEPS.build_distill_step(cfg, DistillConfig(schedule=sched), opt)
    torch.cuda.reset_peak_memory_stats()
    state, hist, secs = _timed_steps(
        fn, state, [tb.inputs for tb in take(task, sched.stage4_end)],
        "cuda")
    _check_schedule("9c", hist, sched)
    log(f"phase 9 (c): {cfg.name} frames [16, 197, {cfg.frontend_dim}], "
        f"N {cfg.had.topn(197)}: {len(hist)} distill steps, stages "
        f"{[int(m['stage']) for m in hist]}, step "
        f"{float(np.mean(secs[1:])) * 1e3:.2f} ms, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, out_kl "
        f"{hist[0]['out_kl']:.4f} -> {hist[-1]['out_kl']:.4f}")


def _busy_share(fn) -> str:
    """The device's busy share over one call of `fn`, from torch.profiler:
    the summed time of its CUDA kernels over the host wall time of the
    window, with that time by group (GEMMs, the top-N selection, softmax,
    reductions, the rest); "not measured" when the profiler sees no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.key.lower()
        key = ("GEMM" if any(t in name for t in ("gemm", "cutlass", "xmma",
                                                  "sm90", "cublas"))
               else "top-N select" if any(t in name for t in (
                   "kthvalue", "radix", "sort", "select"))
               else "softmax" if "softmax" in name
               else "reduce" if "reduce" in name
               else "elementwise and other")
        groups[key] = groups.get(key, 0.0) + getattr(
            e, "self_device_time_total",
            getattr(e, "self_cuda_time_total", 0.0)) / 1e3
    dev_ms = sum(groups.values())
    if dev_ms <= 0:
        return "not measured (the profiler saw no device time)"
    parts = ", ".join(f"{k} {v:.1f}" for k, v in
                      sorted(groups.items(), key=lambda kv: -kv[1]))
    return (f"{dev_ms:.1f} ms of kernels in {wall * 1e3:.1f} ms (busy "
            f"share {dev_ms / 1e3 / wall:.3f}, profiled; ms by group: "
            f"{parts})")


def phase9d() -> None:
    """smollm-135m as published (30 layers, bf16, remat on), seeded weights
    on the card: Eq. 12 sigmas from 2 batches, then a distill at seq 2048,
    batch 4 through all four stages (`tiny_schedule(2)`: 10 steps, 2-4 in
    each stage). Printed: step ms, peak memory, device busy share of one
    more step (torch.profiler, after the serving below). The student is
    saved in the JAX state layout (CheckpointManager), its serving scales
    refreshed, and served on the binary paged Engine under phase 4's
    launch rule (K1 30 a chunk, K2 30 a decode step) with 2 graphs, 4
    requests of phase 4's prompts; a fresh Engine over a model rebuilt
    from the saved checkpoint gives the same greedy tokens."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager, params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.core.distill import DistillConfig, tiny_schedule
    from repro_torch.data import lm_stream, take
    from repro_torch.kernels import binary_paged_decode_attention as pdec
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam
    from repro_torch.serve import Telemetry
    from repro_torch.train import steps as STEPS
    cfg = get_config("smollm-135m")
    check(cfg.remat and cfg.param_dtype == "bfloat16", cfg)
    seq, batch = 2048, 4
    data = lm_stream(vocab=cfg.vocab_size, batch=batch, seq=seq, seed=0)
    teacher = T.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0), device="cuda")
    t0 = time.perf_counter()
    STEPS.estimate_and_set_sigmas(teacher, cfg,
                                  [_to(b, "cuda") for b in take(data, 2)])
    torch.cuda.synchronize()
    sig = teacher.blocks[0].mixer
    log(f"phase 9 (d): {cfg.name} {cfg.n_layers} layers {cfg.param_dtype} "
        f"remat, sigmas of 2 batches [{batch}, {seq}] in "
        f"{time.perf_counter() - t0:.2f} s (layer 0: sigma_q "
        f"{sig.sigma_q.item():.4f}, sigma_k {sig.sigma_k.item():.4f})")
    sched = tiny_schedule(2)
    opt = adam.AdamWConfig()
    dcfg = DistillConfig(schedule=sched)
    state = STEPS.init_distill_state(cfg, opt, teacher=teacher,
                                     device="cuda")
    fn = STEPS.build_distill_step(cfg, dcfg, opt)
    torch.cuda.reset_peak_memory_stats()
    state, hist, secs = _timed_steps(fn, state, take(data, sched.stage4_end),
                                     "cuda")
    _check_schedule("9d", hist, sched)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(peak < 10.0, f"distill step peak {peak:.2f} GiB")
    ms = float(np.mean(secs[1:])) * 1e3
    log(f"phase 9 (d): {len(hist)} distill steps [{batch}, {seq}] N "
        f"{cfg.had.topn(seq)}, stages {[int(m['stage']) for m in hist]}: "
        f"step {ms:.1f} ms (mean of steps 2-{len(secs)}; first "
        f"{secs[0] * 1e3:.0f} ms), {batch * seq / ms * 1e3:.0f} tokens/s, "
        f"peak {peak:.2f} GiB; att_kl {hist[0]['att_kl']:.4f} -> "
        f"{hist[-1]['att_kl']:.4f}, out_kl {hist[0]['out_kl']:.4f} -> "
        f"{hist[-1]['out_kl']:.4f}")

    student = state["student"]
    ck = tempfile.mkdtemp(prefix="chip_smoke_ck_")
    CheckpointManager(ck).save(int(state["step"]),
                               {"state": STEPS.state_tree(state)})
    student.refresh_scales()
    _, prompts, _, base = _workload(cfg)
    prompts, gen = prompts[:4], 16
    runs = {}
    for name in ("distilled", "from_checkpoint"):
        if name == "from_checkpoint":
            _, got = CheckpointManager(ck).restore(
                {"state": STEPS.state_tree(state)})
            model = params_from_numpy(got["state"]["student"], cfg,
                                      device="cuda")
        else:
            model = student
        eng = _engine(cfg, model, dict(base, paged=True), "cuda",
                      telemetry=Telemetry())
        r = _serve_run(eng, prompts, gen, stagger=0)
        check(eng.runner.graph_count() == 2,
              (name, "graphs", eng.runner.graph_count()))
        _check_launches(f"9d {name}", eng, r, (pdec,))
        st = r["stats"]
        log(f"phase 9 (d) [{name}]: served {len(prompts)} requests "
            f"({[len(p) for p in prompts]} tokens, {gen} new): "
            f"{st['prefill_chunks']} chunks, {st['decode_steps']} decode "
            f"steps, 2 step graphs, launches {r['counts']}, tokens sha1 "
            f"{r['digest']}, {_latency(r)}")
        runs[name] = r
        del eng
    check(runs["distilled"]["digest"] == runs["from_checkpoint"]["digest"]
          and all(np.array_equal(a, b) for a, b in
                  zip(runs["distilled"]["tokens"],
                      runs["from_checkpoint"]["tokens"])),
          "9d: the checkpointed student's tokens differ")
    log("phase 9 (d): the engine over the checkpoint's student gives the "
        "distilled student's tokens bit for bit")
    more = next(data)
    log("phase 9 (d): one more distill step: "
        + _busy_share(lambda: fn(state, _to(more, "cuda"))))


def phase9() -> None:
    t0 = time.perf_counter()
    phase9a()
    _free()
    phase9b()
    _free()
    phase9c()
    _free()
    phase9d()
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 10: the long-context kernels and the one-card dry run
# ---------------------------------------------------------------------------

SMOLLM = "smollm-135m"
# phase 10's records: K1 and K4 at smollm-135m's dry-run shapes
K1_32K = "binary_prefill_attention[smollm prefill_32k]"
K4_32K = "binary_decode_attention[smollm decode_32k]"
K4_512K = "binary_decode_attention[smollm long_500k]"
# the dry run's batch cuts, for time (the fit rule gives 256 and 32): a
# distill step at seq 4096 takes seconds a microbatch of 2, and K1 grows
# with S^2 a row
DRYRUN_BATCH = {"train_4k": 2, "prefill_32k": 4}
LONG_WINDOW = 512           # queries a plain-version window at 32k


def _k1_32k_plan(batch: int):
    """K1's plan for smollm-135m's prefill_32k serve step at `batch`: the
    step's one call a layer, S = 32768 queries of batch x 9 rows over the
    32769-position dense cache (its trash position), 3 rows a GQA group."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import binary_prefill_attention as pre
    cfg = get_config(SMOLLM)
    h, dh = batch * cfg.n_heads, cfg.dh
    return pre.split_plan((h, 32768, dh // 32), 32769, dh, dh,
                          group_size=cfg.n_heads // cfg.n_kv_heads)


def phase10_k1(gen) -> dict:
    """K1 at smollm-135m's prefill_32k shape as the dry-run cell runs it
    (DRYRUN_BATCH's batch 4: 36 query rows over 12 kv rows, S = 32768
    over the 32769-position dense cache, causal from position 0, N =
    topn(32768)). One call runs in waves (its one-launch scratch would
    be 59 GiB); its output is held against the plain version window by
    window (LONG_WINDOW queries, the plain version's inputs those of
    `wave_inputs`), at phase 2's TOL. The plain version's time is that of
    all its windows."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import binary_prefill_attention as pre
    from repro_torch.kernels import ref
    cfg = get_config(SMOLLM)
    batch = DRYRUN_BATCH["prefill_32k"]
    h, hk, dh = batch * cfg.n_heads, batch * cfg.n_kv_heads, cfg.dh
    g, s, t = h // hk, 32768, 32769
    nsel = cfg.had.topn(s)
    q = _bits((h, s, dh), gen)
    k = _bits((hk, t, dh), gen)
    v = torch.randn((hk, t, dh), generator=gen,
                    device="cuda").to(torch.bfloat16)
    zero = torch.zeros(h, dtype=torch.int32, device="cuda")
    full = torch.full((h,), s, dtype=torch.int32, device="cuda")
    kw = dict(d=dh, nsel=nsel, scale=SCALE, causal=True)
    plan = _k1_32k_plan(batch)
    n_waves = len(list(pre.waves(plan, h, s)))
    check(n_waves > 1 and plan.scratch_words <= pre.SCRATCH_WORDS,
          f"K1 32k waves {plan}")

    def k1():
        return pre.prefill_attention(q, k, v, kv_length=full, q_offset=zero,
                                     q_length=full, group_size=g,
                                     n_kv_heads=cfg.n_kv_heads, **kw)
    got = k1()
    torch.cuda.synchronize()
    err = 0.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    plain_ms = 0.0
    for s0 in range(0, s, LONG_WINDOW):
        s1 = s0 + LONG_WINDOW
        qw, kw_, vw, kvl, qo, ql = pre.wave_inputs(q, k, v, full, zero, full,
                                                   g, 0, h, s0, s1)
        start.record()
        want = ref.prefill_attention_ref(qw, kw_, vw, kv_length=kvl,
                                         q_offset=qo, q_length=ql,
                                         group_size=g, **kw)
        end.record()
        torch.cuda.synchronize()
        plain_ms += start.elapsed_time(end)
        torch.testing.assert_close(got[:, s0:s1], want, **TOL)
        err = max(err, (got[:, s0:s1] - want).abs().max().item())
        del want
    log(f"phase 10: {K1_32K}: batch {batch}, {h} rows, {n_waves} waves of "
        f"{plan.wave_rows} rows x {plan.wave_qtiles} query tiles, scratch "
        f"{plan.scratch_words * 4 / 2**30:.3f} GiB; max_abs_err {err:.3e} "
        f"over {s // LONG_WINDOW} windows")
    ms = cuda_ms(k1, iters=3, warmup=1)
    work = _k1_work(q, k, dh, full, zero, full, d=dh, nsel=nsel,
                    causal=True, window=LONG_WINDOW)
    rec = _record(pre, "src/repro/kernels/binary_prefill_attention.py:106",
                  err, ms, plain_ms, work, host_us(k1, calls=2), name=K1_32K)
    rec["waves"] = n_waves
    return {K1_32K: rec}


def phase10_k4(gen) -> dict:
    """K4 at smollm-135m's decode cells: decode_32k (batch 128: 384 rows of
    3 grouped queries over the 32769-position cache, every row at 32768
    valid keys, as the dry run's step at pos 32767) and long_500k (3 rows
    over 524289 positions), against the plain version at phase 2's TOL;
    long_500k also at ragged lengths (300001, 1)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import binary_decode_attention as dec
    from repro_torch.kernels import ref
    cfg = get_config(SMOLLM)
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    g = h // hk
    records = {}
    for name, batch, seq in ((K4_32K, 128, 32768), (K4_512K, 1, 524288)):
        r, t = batch * hk, seq + 1
        nsel = cfg.had.topn(seq)
        q = _bits((r, g, dh), gen)
        k = _bits((r, t, dh), gen)
        planes = k.transpose(-1, -2).contiguous()
        v = torch.randn((r, t, dh), generator=gen,
                        device="cuda").to(torch.bfloat16)
        lens = torch.full((r,), seq, dtype=torch.int32, device="cuda")
        kw = dict(d=dh, nsel=nsel, scale=SCALE)
        err = 0.0
        cases = [lens] + ([torch.tensor([seq, 300001, 1], dtype=torch.int32,
                                        device="cuda")] if batch == 1 else [])
        for ln in cases:
            got = dec.decode_attention(q, planes, v, ln, **kw)
            want = ref.decode_attention_ref(q, k, v, lengths=ln, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **TOL)
            err = max(err, (got - want).abs().max().item())
            log(f"phase 10: {name} T {t} lengths {ln[:3].tolist()} "
                f"max_abs_err {(got - want).abs().max().item():.3e}")
            del got, want

        def k4():
            return dec.decode_attention(q, planes, v, lens, **kw)
        ms = cuda_ms(k4, iters=20)
        plain_ms = cuda_ms(lambda: ref.decode_attention_ref(
            q, k, v, lengths=lens, **kw), iters=2, warmup=1)
        work = _decode_rows_work(q, k, lens, r * 4, d=dh, nsel=nsel, dv=dh)
        records[name] = _record(
            dec, "src/repro/kernels/binary_decode_attention.py:122", err,
            ms, plain_ms, work, host_us(k4), name=name)
        del q, k, planes, v
        _free()
    return records


def phase10_dryrun() -> dict:
    """smollm-135m's four dry-run cells on the card (`launch.dryrun.
    run_cell`: weights drawn on the card, a counted step, then a timed
    one), decode_32k and long_500k at the fit rule's batch (128, 1), the
    others at DRYRUN_BATCH (each cut printed); every cell "ok" with its
    peak memory, step time, roofline terms, mfu and hbm_share, and the
    kernel of its path launched in both steps (the counted and the timed
    one) in each of the 30 layers: K4 once a call by the decode cells,
    K1 once a wave by prefill_32k (`_k1_32k_plan`'s waves a call), read
    from the wrappers' counters zeroed just before the cell. Then the
    meta records of the ten assigned archs: none an error, and the three
    largest fit no cell."""
    from repro_torch.configs import ASSIGNED, get_config
    from repro_torch.kernels import binary_decode_attention as dec
    from repro_torch.kernels import binary_prefill_attention as pre
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as M
    layers, heads = get_config(SMOLLM).n_layers, get_config(SMOLLM).n_heads
    path = {"prefill_32k": (pre.NAME, K1_32K), "decode_32k": (dec.NAME,
                                                              K4_32K),
            "long_500k": (dec.NAME, K4_512K), "train_4k": (None, None)}
    counts = {}
    for shape in M.SHAPES:
        batch = DRYRUN_BATCH.get(shape)
        if batch:
            fit, _ = D.fit_batch(get_config(SMOLLM), M.SHAPES[shape])
            log(f"phase 10: dry run {SMOLLM} {shape} cut to batch {batch} "
                f"(the fit rule gives {fit})")
        ops.reset_launch_counts()
        rec = D.run_cell(SMOLLM, shape, batch=batch)
        launched = ops.launch_counts()
        log(f"phase 10: {D.summary(rec)}")
        log(json.dumps({k: rec[k] for k in rec if k != "trace"}))
        check(rec["status"] == "ok", (shape, rec.get("trace")))
        kernel, record = path[shape]
        want = {n: 0 for n in launched}
        if kernel:
            want[kernel] = 2 * layers
            if kernel == pre.NAME:
                want[kernel] *= len(list(pre.waves(
                    _k1_32k_plan(batch), batch * heads, 32768)))
            counts[record] = launched[kernel]
        check(launched == want, (shape, launched, want))
        check(rec["step_s"] > 0 and rec["mfu"] > 0 and rec["hbm_share"] > 0
              and rec["memory"]["peak_memory_in_bytes"] > 0, rec)
        _free()
    for arch in ASSIGNED:
        for shape in M.SHAPES:
            rec = D.run_cell(arch, shape, device="meta")
            log(f"phase 10: {D.summary(rec)}")
            check(rec["status"] != "error", rec.get("trace"))
            if arch in ("kimi-k2-1t-a32b", JAMBA, DBRX):
                check(rec["status"] == "does_not_fit", rec)
    return counts


def phase10_counts_cpu_vs_card() -> None:
    """The counted flops and bytes of a reduced binary serve step (smollm
    widths cut to the reduced config, float32: a dense prefill of 24
    tokens, then a decode step) are equal on the CPU (plain versions) and
    on the card (kernels), and so are the kernels' reported calls."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import op_cost
    from repro_torch.models import transformer as T
    cfg = get_config(SMOLLM, reduced=True)
    cpu_model = T.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 25),
                           generator=torch.Generator().manual_seed(1))
    costs = {}
    for dev in ("cpu", "cuda"):
        model = cpu_model.to(dev)
        caches = T.init_caches(cfg, paged=False, batch=2, max_len=40,
                               device=dev)
        tok = tokens.to(dev)
        with op_cost.Counter() as c:
            for t0, t1 in ((0, 24), (24, 25)):
                T.serve_step(model, tok[:, t0:t1], caches,
                             pos=torch.full((2,), t0, dtype=torch.int32,
                                            device=dev),
                             n=cfg.had.topn(40), logits_mode="last")
        costs[dev] = (c.cost.flops, c.cost.bytes, c.kernel_calls)
    log(f"phase 10: counted reduced serve step: cpu {costs['cpu']}, "
        f"card {costs['cuda']}")
    check(costs["cpu"] == costs["cuda"], costs)


def phase10(records: dict, counts: dict) -> None:
    import torch
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(10)
    records.update(phase10_k1(gen))
    _free()
    records.update(phase10_k4(gen))
    counts.update(phase10_dryrun())
    phase10_counts_cpu_vs_card()
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 11: tensor-parallel serving, three ranks on the one card
# ---------------------------------------------------------------------------

TP = 3
TP_TIMEOUT_S = 600.0      # the three ranks' whole run, and each collective
# a rank's attention shapes at tp 3: 3 query heads over 1 kv head (G 3)
TP_SHAPES = dict(h=9 // TP, hk=3 // TP, tag="smollm tp3", d=64, k3_nsel=64,
                 names=dict(k1=K1_TP, k2=K2_TP, k3=K3_TP, k4=K4_TP))
# run -> (ServeConfig fields, the single-rank run of phase 4 whose tokens
# it must give; phase 5's binary swap run gives phase 4's paged tokens)
TP_RUNS = {"paged": (dict(paged=True), "paged"),
           "dense": (dict(paged=False), "dense"),
           "page_topn_64": (dict(paged=True, page_topn=64), "page_topn_64"),
           "fp_page_topn_64": (dict(paged=True, page_topn=64, binary=False),
                               "fp_page_topn_64"),
           "paged_swap": (dict(paged=True, n_pages=384, swap_pages=1024),
                          "paged")}


def save_weights(model, directory: str) -> None:
    """The full weights of `model`, once, as a JAX-layout checkpoint
    (``params.npz``) that `load_npz` + `params_from_numpy` read back."""
    import numpy as np
    from repro_torch.checkpoint.bridge import to_jax_flat
    from repro_torch.models.transformer import named_tensors
    np.savez(os.path.join(directory, "params.npz"),
             **to_jax_flat(model.cfg, named_tensors(model)))


def _tp_projections(weights_dir: str) -> None:
    """Does a rank's slice of a projection give the full product's columns
    bit for bit on the card, at phase 4's shapes (a 2048-row prefill chunk
    batch and a 4-row decode step; layer 0's wq / wk / wv in bf16 and the
    float32 lm_head of the last positions)? The serving step's lm_head
    product (`unembed_blocked`) must; the one-GEMM `unembed` is logged
    beside it."""
    import torch
    from repro_torch.checkpoint import load_npz, params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.models import common
    model = params_from_numpy(load_npz(weights_dir),
                              get_config("smollm-135m"))
    gen = torch.Generator(device="cuda").manual_seed(11)
    mix = model.blocks[0].mixer
    ok, seen = True, []
    for rows in (2048, 4):
        x = torch.randn((rows, 576), generator=gen, device="cuda").to(
            torch.bfloat16)
        for name in ("wq", "wk", "wv"):
            w = getattr(mix, name).to("cuda")
            n = w.shape[1] // TP
            full = x @ w
            same = all(torch.equal(full[:, r * n:(r + 1) * n],
                                   x @ w[:, r * n:(r + 1) * n].contiguous())
                       for r in range(TP))
            ok &= same
            seen.append(f"{name} [{rows}, 576] x [576, {n}]: {same}")
    head = model.lm_head.to("cuda")
    n = head.shape[1] // TP
    x = torch.randn((4, 1, 576), generator=gen, device="cuda")
    for fn in (common.unembed_blocked, common.unembed):
        full = fn(x, head)
        same = all(torch.equal(full[..., r * n:(r + 1) * n],
                               fn(x, head[:, r * n:(r + 1) * n].contiguous()))
                   for r in range(TP))
        if fn is common.unembed_blocked:
            ok &= same
        seen.append(f"lm_head {fn.__name__} [4, 576] x [576, {n}]: {same}")
    log("phase 11: a rank's columns equal the full product's, bit for bit: "
        + "; ".join(seen))
    check(ok, "phase 11: a sharded projection's columns differ from the "
              "full product's")
    del model, head


def _tp_rank(weights_dir: str, run_names: list) -> dict:
    """One of phase 11's ranks: phase 4's weights loaded from the parent's
    checkpoint, phase 4's workload served once a run over the 1 x 3 mesh
    (gloo, every rank on cuda:0, the eager step). Rank 0 drives each run
    and returns its record (`_serve_run`'s, the cache bytes, the step ms,
    the host-staged collectives); the others follow it and return their
    launch counts."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import load_npz, params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import Engine, ServeConfig, Telemetry
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_host_mesh(data=1, model=TP)
    cfg = get_config("smollm-135m")
    model = params_from_numpy(load_npz(weights_dir), cfg)   # on the host
    _, prompts, gen, base = _workload(cfg)
    lead = mesh.model_rank == 0
    out = {}
    for name in run_names:
        tel = Telemetry(trace_capacity=4096) if lead else None
        eng = Engine(cfg, model, ServeConfig(**dict(base, **TP_RUNS[name][0]),
                                             mesh=mesh),
                     telemetry=tel, device=mesh.device, eager=True)
        collectives.reset_staged_counts()
        if lead:
            try:
                r = _serve_run(eng, prompts, gen)
            finally:
                eng.close()
            steps = {k: (len(v), float(np.median(v)))
                     for k, v in _step_ms(tel).items()}
            out[name] = dict(
                {k: r[k] for k in ("digest", "counts", "stats", "wall",
                                   "steps")},
                ttft=r["ttft"], itl=r["itl"], step_ms=steps,
                bytes=eng.runner.cache_device_bytes(),
                graphs=eng.runner.graph_count(),
                staged=collectives.staged_counts())
        else:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            calls = eng.serve_worker()
            torch.cuda.synchronize()
            out[name] = dict(counts=ops.launch_counts(), calls=calls,
                             bytes=eng.runner.cache_device_bytes(),
                             staged=collectives.staged_counts())
        del eng
        _free()
    return out


def phase11(card: str, digests: dict, weights_dir: str,
            records: dict) -> dict:
    """Tensor-parallel serving of smollm-135m as published at tp 3: three
    spawned ranks on the one card (gloo; each rank launches K1-K4 on its
    kv head), phase 4's weights (saved once by this process, loaded by
    each rank) and workload, over TP_RUNS. First the projection check
    (`_tp_projections`) and the kernels' records at a rank's shapes
    (`_phase2_wide`: 3 query heads over 1 kv head, G 3, d 64). Then each
    run's token digest must equal its single-rank run's, per rank bytes x
    3 must equal the total, and every rank must follow phase 4's launch
    rule (a kernel of the path once a layer a chunk or step, nothing
    else); a rank that fails or outlasts TP_TIMEOUT_S fails the phase.
    Returns the per-rank records' launches (rank 0's, over the runs)."""
    import torch
    from repro_torch.kernels import binary_decode_attention as dec
    from repro_torch.kernels import binary_page_score as pscore
    from repro_torch.kernels import binary_paged_decode_attention as pdec
    from repro_torch.kernels import binary_prefill_attention as pre
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    _tp_projections(weights_dir)
    _free()
    records.update(_phase2_wide(torch.Generator(device="cuda").manual_seed(
        11), **TP_SHAPES))
    _free()
    t1 = time.perf_counter()
    ranks = spawn(_tp_rank, TP, weights_dir, list(TP_RUNS), backend="gloo",
                  timeout=TP_TIMEOUT_S)
    log(f"phase 11: {TP} ranks (gloo, every rank on cuda:0, eager) served "
        f"{len(TP_RUNS)} runs in {time.perf_counter() - t1:.1f} s")
    decoders = {"paged": (pdec,), "dense": (dec,),
                "page_topn_64": (pdec, pscore), "fp_page_topn_64": (),
                "paged_swap": (pdec,)}
    names = {pre.NAME: K1_TP, pdec.NAME: K2_TP, pscore.NAME: K3_TP,
             dec.NAME: K4_TP}
    launches = {k: 0 for k in names.values()}
    for name, (_, ref) in TP_RUNS.items():
        r = ranks[0][name]
        st = r["stats"]
        want = {k: 0 for k in r["counts"]}
        if "fp_" not in name:
            want[pre.NAME] = 30 * st["prefill_chunks"]
        for mod in decoders[name]:
            want[mod.NAME] = 30 * st["decode_steps"]
        for rank, rec in enumerate(ranks):
            check(rec[name]["counts"] == want and st["decode_steps"] > 0,
                  (name, rank, rec[name]["counts"], want))
            total, per = rec[name]["bytes"]
            check(per * TP == total, (name, rank, "bytes", total, per))
        check(r["graphs"] == 0, (name, "graphs", r["graphs"]))
        check(r["digest"] == digests[ref],
              f"phase 11 [{name}]: tokens {r['digest']} differ from the "
              f"single-rank {ref} run's {digests[ref]}")
        if name == "paged_swap":
            check(st["swap_outs"] > 0 and st["swap_ins"] == st["swap_outs"]
                  and st["replayed_tokens"] == 0, (name, st))
        for k, v in r["counts"].items():
            if k in names:
                launches[names[k]] += v
        total, per = r["bytes"]
        ms = ", ".join(f"{k}: {n} steps, median {m:.2f} ms"
                       for k, (n, m) in sorted(r["step_ms"].items()))
        log(f"phase 11 [{name}]: {r['steps']} steps, "
            f"{st['prefill_chunks']} prefill chunks, {st['decode_steps']} "
            f"decode steps, step graphs 0 (eager), launches on each rank "
            f"{r['counts']}, cache bytes {total} total, {per} a rank, "
            f"tokens sha1 {r['digest']} (== the single-rank {ref} run's)"
            + (f", {st['swap_outs']} swap-outs, swap_out_bytes "
               f"{st['swap_out_bytes']}" if name == "paged_swap" else ""))
        log(f"phase 11 [{name}]: {card}: host ms a step by kind: {ms}; "
            f"{_latency(r)}; collectives staged through host memory "
            f"(gloo, CUDA tensors) by rank: "
            f"{[rec[name]['staged'] for rec in ranks]}")
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    return launches



def profile_decode(eng, name: str, out_dir: str, prompt_len: int) -> None:
    """Device time by group in a decode window of a full-size engine: 4
    slots filled with `prompt_len`-token prompts, then 8 decode steps run
    once on the host clock and once under torch.profiler. Groups: the
    attention kernels, GEMMs (the projections, the expert matmuls, the
    head), index ops (the MoE dispatch and combine, the state pool's
    gathers and scatters), memcpy/memset and the rest (elementwise and
    reductions: the SSM's conv, exp, cumsum and einsum glue, the router's
    softmax and sort)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(9)
    while eng.queue or any(s.request is not None for s in eng.slots):
        eng.step()
    for _ in range(4):
        eng.submit(rng.integers(0, eng.cfg.vocab_size, prompt_len).astype(
            np.int32), max_new_tokens=64)
    while eng.queue or any(s.prefilling for s in eng.slots):
        eng.step()
    eng.step()
    n = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3

    groups: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        key = ("K1 prefill_*_kernel" if "prefill_" in e.key else
               "K2/K4 split_*_kernel" if "split_" in e.key else
               "K3 page_select_kernel" if "page_select" in e.key else
               "memcpy/memset" if "Memcpy" in e.key or "Memset" in e.key
               else "gemm" if any(t in e.key for t in
                                  ("gemm", "nvjet", "cutlass", "sm90"))
               else "index (dispatch/combine, state gather/scatter)"
               if any(t in e.key.lower() for t in
                      ("index", "gather", "scatter"))
               else "other elementwise/reduce")
        groups[key] = groups.get(key, 0.0) + dev(e)
    busy = sum(groups.values())
    with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=80))
    log(f"profile {name}: {n} steps, host wall {wall / n:.3f} ms a step, "
        f"device {busy / n:.3f} ms a step, busy {busy / wall:.3f}; per "
        f"step: " + "; ".join(f"{k} {v / n:.3f} ms" for k, v in
                              sorted(groups.items(), key=lambda kv: -kv[1])))


def profile_vision(eng, out_dir: str) -> None:
    """Device time by group in two windows of phase 6's paged vision
    engine, each run once on the host clock and then once under
    torch.profiler: the prefill of one 2048-token prompt with an image
    into the idle engine (4 chunks in one step), then 8 decode steps of 4
    slots at ~2k-token contexts, 2 with images. Groups: K1 (self- and
    cross-attention chunks alike), K2 at the self-attention layers, K4 at
    the cross layers (its DenseSrc split launches), the pooled cross
    state's gathers (index_select), GEMMs and the rest."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(5)
    cfg = eng.cfg

    def request(gen, image):
        eng.submit(rng.integers(0, cfg.vocab_size, 2048).astype(np.int32),
                   max_new_tokens=gen, extra={"image_embeds": (
                       rng.standard_normal((1, cfg.n_image_tokens,
                                            cfg.frontend_dim),
                                           dtype=np.float32))}
                   if image else None)

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3

    def window(name, n, setup):
        setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        setup()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                eng.step()
            torch.cuda.synchronize()
        groups: dict[str, float] = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            key = ("K1 prefill_*_kernel" if "prefill_" in e.key else
                   "K4 split_*_kernel (cross layers)" if "split_" in e.key
                   and "DenseSrc" in e.key else
                   "K2 split_*_kernel" if "split_" in e.key else
                   "state gather (index_select)" if "ndexSelect" in e.key
                   or "index_select" in e.key else
                   "memcpy/memset" if "Memcpy" in e.key
                   or "Memset" in e.key
                   else "gemm" if any(t in e.key for t in
                                      ("gemm", "nvjet", "cutlass", "sm90"))
                   else "other elementwise/reduce/index")
            groups[key] = groups.get(key, 0.0) + dev(e)
        busy = sum(groups.values())
        with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=80))
        log(f"profile {name}: {n} steps, host wall {wall / n:.3f} ms a "
            f"step, device {busy / n:.3f} ms a step, busy {busy / wall:.3f};"
            f" per step: " + "; ".join(
                f"{k} {v / n:.3f} ms" for k, v in
                sorted(groups.items(), key=lambda kv: -kv[1])))

    window("vision_prefill_2048_paged", 1, lambda: request(1, True))
    while eng.queue or any(s.request is not None for s in eng.slots):
        eng.step()
    for i in range(4):
        request(64, i % 2 == 0)
    while eng.queue or any(s.prefilling for s in eng.slots):
        eng.step()
    eng.step()
    window("vision_decode_4x2k_paged", 8, lambda: None)


def profile_windows(engines: dict, out_dir: str) -> None:
    """Device time by kernel in windows of the full-size engines of phase
    4, each run four times -- three timed on the host clock, then once
    under torch.profiler: the prefill of one 3072-token prompt into the
    idle paged engine (6 chunks in one step: the budget lifts when no slot
    decodes), then 8 decode steps of 4 slots at ~3.1k-token contexts on the
    paged engine (K2), the dense-cache engine (K4), the full-precision
    paged engine (no kernel of its own) and the page_topn-64 engines (K3 +
    K2), the engine captured with the unfused selection (the bounds-only
    kernel, then ops.select_pages) and the fused one in turn: unfused,
    fused, fused, unfused. Every step of those replays the engine's CUDA
    graphs; the prefill and the paged decode window run again on the
    eager engine. Busy share = device kernel time under the profiler / the
    median host wall of the unprofiled runs; the caching allocator's
    cudaMalloc calls in those runs are counted, and the engine's telemetry
    splits the host wall into schedule, execute (staging, the replay or the
    eager ops, the logits copy that waits for the device, and host
    sampling) and commit. Writes each window's op table to `out_dir`."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(1)

    vocab = engines["paged"].cfg.vocab_size

    def prompt():
        return rng.integers(0, vocab, 3072).astype(np.int32)

    def steps(eng, n):
        """Host wall (ms) of n steps, and the telemetry's schedule /
        execute / commit ms summed over them."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ev = [e for e in eng.telemetry.recorder.events()
              if e["kind"] == "step"][-n:]
        return wall, {k: sum(e["timings"][k] for e in ev) * 1e3
                      for k in ("schedule", "execute", "commit")}

    def mallocs():
        st = torch.cuda.memory_stats()
        return st.get("num_device_alloc", st["segment.all.allocated"])

    def fill(eng):
        """Drain the engine, then prefill 4 slots with 3072-token prompts."""
        while eng.queue or any(s.request is not None for s in eng.slots):
            eng.step()
        for _ in range(4):
            eng.submit(prompt(), max_new_tokens=64)
        while eng.queue or any(s.prefilling for s in eng.slots):
            eng.step()

    def window(name, eng, n, setup, decode="K2/K4"):
        runs, m0 = [], mallocs()
        for _ in range(3):
            setup()
            runs.append(steps(eng, n))
        walls = [w for w, _ in runs]
        wall, phases = sorted(runs, key=lambda r: r[0])[1]
        n_malloc = mallocs() - m0
        setup()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            steps(eng, n)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]

        def dev(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)) / 1e3

        busy = sum(dev(e) for e in kernels)
        groups: dict[str, float] = {}
        for e in kernels:
            # K1 is three CUDA launches, prefill_{hist,partial,combine}_
            # kernel; K2 and K4 three each, had::split_{scores,tile_sums,
            # combine}_kernel (an engine runs one of the two); K3 one,
            # page_select_kernel, or page_score_kernel when unfused, whose
            # selection's sorts and gathers get a group of their own
            key = ("K1 prefill_*_kernel" if "prefill_" in e.key else
                   f"{decode} split_*_kernel" if "split_" in e.key else
                   "K3 page_select_kernel" if "page_select" in e.key else
                   "K3 page_score_kernel" if "page_score" in e.key else
                   "sort/gather" if "sort" in e.key.lower()
                   or "gather" in e.key.lower() else
                   "memcpy/memset" if "Memcpy" in e.key or "Memset" in e.key
                   else "gemm" if any(t in e.key for t in
                                      ("gemm", "nvjet", "cutlass", "sm90"))
                   else "other elementwise/reduce/index")
            groups[key] = groups.get(key, 0.0) + dev(e)
        with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                              row_limit=80))
        log(f"profile {name}: {n} steps, host wall {wall / n:.3f} ms a step "
            f"(runs {', '.join(f'{w:.3f}' for w in walls)} ms; {n_malloc} "
            f"cudaMalloc calls; telemetry a step: " + ", ".join(
                f"{k} {v / n:.3f} ms" for k, v in phases.items())
            + f"), device {busy / n:.3f} ms a step, busy "
            f"{busy / wall:.3f}; per step: " + "; ".join(
                f"{k} {v / n:.3f} ms" for k, v in
                sorted(groups.items(), key=lambda kv: -kv[1])))

    for name in ("paged", "paged_eager"):      # idle after phase 4
        eng = engines[name]
        window(f"prefill_3072{name[5:]}", eng, 1,
               lambda: eng.submit(prompt(), max_new_tokens=1))
    for name in ("paged", "paged_eager", "dense", "fp_paged"):
        eng = engines[name]
        fill(eng)
        window(f"decode_4x3k_{name}", eng, 8, lambda: None,
               {"dense": "K4", "fp_paged": "fp"}.get(name, "K2"))
    for i, name in enumerate(("page_topn_64_unfused", "page_topn_64",
                              "page_topn_64", "page_topn_64_unfused")):
        eng = engines[name]
        fill(eng)
        window(f"decode_4x3k_{name}_{i}", eng, 8, lambda: None, "K2")


# ---------------------------------------------------------------------------
# phase 12: the examples' twins, the production mesh, bf16 attention
# ---------------------------------------------------------------------------

LONG_FLAGS = {"dense": [], "paged": ["--paged"],
              "prefix": ["--prefix-cache"], "swap": ["--swap-pages", "16"],
              "topn": ["--page-topn", "4"]}
MESH_TIMEOUT_S = 600.0


def _example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(tokens) -> str:
    import numpy as np
    h = hashlib.sha1()
    for t in tokens:
        h.update(np.asarray(t, np.int64).tobytes())
    return h.hexdigest()[:12]


def phase12_mesh_start():
    """Start the production-mesh dry run in a subprocess: CPU work on the
    meta device, started after phase 11 (whose host-clock times it would
    disturb) to run beside phase 12 (a) and (c). Returns (process, its
    output directory, its log file)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    code = ("import sys, time\n"
            "t0 = time.perf_counter()\n"
            "from repro_torch.launch import dryrun\n"
            "rc = dryrun.main(['--all', '--mesh', 'both', '--device', "
            "'meta', '--out', sys.argv[1]])\n"
            "print(f'mesh dry run: {time.perf_counter() - t0:.1f} s')\n"
            "sys.exit(rc)\n")
    log_f = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", code, out], env=env,
                            cwd=ROOT, stdout=log_f, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out, log_f


def phase12_mesh_finish(proc, out: str, log_f) -> None:
    """(b): 80 records, none an error; the markdown table."""
    from repro_torch.launch import dryrun as D
    try:
        proc.wait(timeout=MESH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    log_f.seek(0)
    text = log_f.read()
    recs = []
    for fn in sorted(os.listdir(out)):
        with open(os.path.join(out, fn)) as f:
            recs.append(json.load(f))
    lines = text.strip().splitlines()
    log(f"phase 12 (b): python -m repro_torch.launch.dryrun --all --mesh "
        f"both --device meta, a subprocess beside phase 12: exit "
        f"{proc.returncode}, {len(recs)} records; {'; '.join(lines[-2:])}")
    check(proc.returncode == 0 and len(recs) == 80, text[-3000:])
    check(not [r for r in recs if r["status"] == "error"], text[-3000:])
    order = {m: i for i, m in enumerate(("16x16", "2x16x16"))}
    recs.sort(key=lambda r: (r["arch"], r["shape"], order[r["mesh"]]))
    log("phase 12 (b): per-chip pricing (compute and HBM: the meta count, "
        "a lower bound; collectives at NVLink 450 GB/s in a node, 50 GB/s "
        "a GPU across nodes)\n" + D.mesh_table(recs))


def phase12_records(gen) -> dict:
    """K1-K4 at the long-context example's shapes (its CFG: 4 query heads
    over 2 kv heads of width 32 -> 1 word, float32 V, top-N 61 at 524
    positions; 2 slots, 128-query chunks, 64-token pages, 9-block tables,
    a dense cache of 525 positions with the trash one), each against its
    plain version at phase 2's tolerances (K3's bounds, tables, counts and
    logical ids exactly, at n_sel 4 and 9), timed (K3 by device time),
    with its bound and host time. K1: slot 0's last chunk of the 512-token
    prompt and slot 1's second of the 256-token one; K2 and K4 at decode
    lengths 520 and 262, K2 over shuffled pages."""
    import torch
    from repro_torch.kernels import binary_decode_attention as dec
    from repro_torch.kernels import binary_page_score as pscore
    from repro_torch.kernels import binary_paged_decode_attention as pdec
    from repro_torch.kernels import binary_prefill_attention as pre
    from repro_torch.kernels import ops, ref
    from repro_torch.models.attention_block import gather_pages
    ex = _example("torch_long_context_serve")
    cfg, ctx = ex.CFG, ex.CTX + ex.GEN
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    g, w, dv = h // hk, d // 32, d
    nsel, scale, page, chunk, b = cfg.had.topn(ctx), d ** -0.5, 64, 128, 2
    nb = -(-ctx // page)
    t = ctx + 1
    f32 = dict(v_bytes=4)
    records = {}

    def rows(vals):
        return torch.tensor(vals, dtype=torch.int32,
                            device="cuda").repeat_interleave(h)

    q = _bits((b * h, chunk, d), gen)
    k = _bits((b * hk, t, d), gen)
    v = torch.randn((b * hk, t, dv), generator=gen, device="cuda")
    qoff, qlen = rows([384, 128]), rows([chunk, chunk])
    kw = dict(d=d, nsel=nsel, scale=scale, kv_length=qoff + qlen,
              q_offset=qoff, q_length=qlen, causal=True)

    def k1():
        return pre.prefill_attention(q, k, v, group_size=g, n_kv_heads=hk,
                                     **kw)
    got, want = k1(), ref.prefill_attention_ref(q, k, v, group_size=g, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    records[K1_EX] = _record(
        pre, "src/repro/kernels/binary_prefill_attention.py:106",
        (got - want).abs().max().item(), cuda_ms(k1, iters=50),
        cuda_ms(lambda: ref.prefill_attention_ref(
            q, k, v, group_size=g, **kw), iters=5, warmup=1),
        _k1_work(q, k, dv, qoff + qlen, qoff, qlen, d=d, nsel=nsel,
                 causal=True, ev_rate=TF32_TENSOR_OPS_PER_S, **f32),
        host_us(k1), name=K1_EX)

    lens = torch.tensor([520, 262], dtype=torch.int32, device="cuda")
    n_pages = b * nb
    qd = _bits((b, h, d), gen)
    k_pool = _bits((n_pages + 1, hk, page, d), gen).transpose(-1, -2) \
        .contiguous()
    v_pool = torch.randn((n_pages + 1, hk, page, dv), generator=gen,
                         device="cuda")
    bt = torch.randperm(n_pages, generator=gen, device="cuda").reshape(
        b, nb).to(torch.int32)
    bt = torch.where(torch.arange(nb, device="cuda")[None]
                     < ((lens + page - 1) // page)[:, None], bt, -1)
    kw = dict(d=d, nsel=nsel, scale=scale)
    got = ops.paged_decode_attention(qd, k_pool, v_pool, bt, lengths=lens,
                                     **kw)
    want = ref.paged_decode_attention_ref(
        qd.reshape(b, hk, g, w), k_pool, v_pool, bt, lengths=lens,
        **kw).reshape(b, h, dv)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    bt_rows, counts, len_f = ops._row_tables(bt, lens, hk, page)
    qf = qd.reshape(b * hk, g, w).contiguous()

    def k2():
        return pdec.paged_decode_attention(qf, k_pool, v_pool, bt_rows,
                                           counts, **kw)
    k_rows = gather_pages(k_pool, bt.clamp_min(0), 3).transpose(-1, -2) \
        .reshape(b * hk, nb * page, w)
    records[K2_EX] = _record(
        pdec, "src/repro/kernels/binary_paged_decode_attention.py:109",
        (got - want).abs().max().item(), cuda_ms(k2, iters=200),
        cuda_ms(lambda: ref.paged_decode_attention_rows_ref(
            qf, k_pool, v_pool, bt_rows, counts, **kw), iters=5, warmup=1),
        _decode_rows_work(qf, k_rows, len_f, 2 * b * hk * nb * 4, d=d,
                          nsel=nsel, dv=dv, **f32),
        host_us(k2), name=K2_EX)

    for n_sel in (4, nb):
        got = pscore.paged_select_pages(qf, k_pool, bt_rows, counts, len_f,
                                        d=d, page=page, n_sel=n_sel)
        want = ref.paged_select_pages_ref(qf, k_pool, bt_rows, counts,
                                          len_f, d=d, page=page, n_sel=n_sel)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"{K3_EX} tables/counts/logical n_sel {n_sel}")

    def k3():
        return pscore.paged_select_pages(qf, k_pool, bt_rows, counts, len_f,
                                         d=d, page=page, n_sel=4)
    n_keys = len_f.sum().item()
    r = b * hk
    records[K3_EX] = _record(
        pscore, "src/repro/kernels/binary_page_score.py:68", 0.0,
        device_ms(k3), cuda_ms(lambda: ref.paged_select_pages_ref(
            qf, k_pool, bt_rows, counts, len_f, d=d, page=page, n_sel=4),
            iters=10, warmup=2),
        (r * g * w * 4 + n_keys * w * 4 + 2 * r * nb * 4 + r * 4
         + 3 * r * 4 * 4,
         [(n_keys * w * 2 + r * nb * g * w * 6, CUDA_CORE_OPS_PER_S)]),
        host_us(k3), name=K3_EX)

    qd = _bits((r, g, d), gen)
    k = _bits((r, t, d), gen)
    planes = k.transpose(-1, -2).contiguous()
    v = torch.randn((r, t, dv), generator=gen, device="cuda")

    def k4():
        return dec.decode_attention(qd, planes, v, len_f, **kw)
    got, want = k4(), ref.decode_attention_ref(qd, k, v, lengths=len_f,
                                               **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    records[K4_EX] = _record(
        dec, "src/repro/kernels/binary_decode_attention.py:122",
        (got - want).abs().max().item(), cuda_ms(k4, iters=200),
        cuda_ms(lambda: ref.decode_attention_ref(qd, k, v, lengths=len_f,
                                                 **kw), iters=5, warmup=1),
        _decode_rows_work(qd, k, len_f, r * 4, d=d, nsel=nsel, dv=dv, **f32),
        host_us(k4), name=K4_EX)
    return records


def phase12_examples() -> dict:
    """(a): the three twins on the card at the JAX examples' sizes.
    Returns the long-context runs' launches by phase 12's record."""
    from repro_torch.kernels import binary_decode_attention as dec
    from repro_torch.kernels import binary_page_score as pscore
    from repro_torch.kernels import binary_paged_decode_attention as pdec
    from repro_torch.kernels import binary_prefill_attention as pre
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    q = _example("torch_quickstart").main(["--device", "cuda"])
    counts = ops.launch_counts()
    log(f"phase 12 (a) quickstart: {time.perf_counter() - t0:.1f} s, "
        f"sigma_q {q['sigma_q']:.6f}, HAD tokens sha1 {_digest(q['had'])}, "
        f"fp {_digest(q['fp'])}, agreement {q['agree']:.2f}, launches "
        f"{counts}")
    check(counts[pre.NAME] > 0 and counts[dec.NAME] > 0, counts)
    long_mod = _example("torch_long_context_serve")
    names = {pre.NAME: K1_EX, pdec.NAME: K2_EX, pscore.NAME: K3_EX,
             dec.NAME: K4_EX}
    launches = {k: 0 for k in names.values()}
    for name, flags in LONG_FLAGS.items():
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        r = long_mod.main(["--device", "cuda"] + flags)
        counts = ops.launch_counts()
        want = {pre.NAME, dec.NAME}
        if flags:
            want.add(pdec.NAME)
        if name == "topn":
            want.add(pscore.NAME)
        log(f"phase 12 (a) long_context_serve {' '.join(flags) or '(dense)'}"
            f": {time.perf_counter() - t0:.1f} s, tokens sha1 "
            f"{_digest(r['tokens'])}, launches {counts}")
        check(all(counts[k] > 0 for k in want), (name, counts, want))
        check(all(counts[k] == 0 for k in counts if k not in want),
              (name, counts, want))
        for k, rec in names.items():
            launches[rec] += counts[k]
        _free()
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    res = _example("torch_distill_encoder").run("cuda")
    log(f"phase 12 (a) distill_encoder: {time.perf_counter() - t0:.1f} s "
        f"(teacher {res['teacher_s']:.1f} s, distillation "
        f"{res['distill_s']:.1f} s), teacher accuracy "
        f"{res['teacher_acc']:.3f}, HAD student accuracy "
        f"{res['student_acc']:.3f}, launches {ops.launch_counts()}")
    _free()
    phase12_distill_devices()
    _free()
    return launches


def phase12_distill_devices() -> None:
    """(a'): ``torch_distill_encoder``'s teacher trained on the card and
    on the CPU from the same seeded weights and batches, and the "had"
    distillation of the card's teacher on both devices and of the CPU's
    teacher on the CPU, every step's loss recorded: where the teachers
    part and how far their weights end apart; where the two distillations
    of one teacher part (loss more than 1e-4 relative apart) and in which
    stage; each teacher's and each student's accuracy. Checks only that
    every loss is finite: the point is where the runs part."""
    import copy

    import numpy as np
    import torch
    from repro_torch.core.distill import tiny_schedule
    from repro_torch.models import transformer as T
    tw = _example("torch_distill_encoder")
    sps = 40
    sched = tiny_schedule(sps)
    t0 = time.perf_counter()
    teachers, t_loss, t_acc = {}, {}, {}
    for dev in ("cuda", "cpu"):
        tl = []
        teachers[dev] = tw.train_teacher(
            tw.CFG, tw.task(0), dev, steps=400, lr=1e-3,
            on_step=lambda i, loss, p: tl.append(loss.detach()))
        t_loss[dev] = torch.stack(tl).cpu().numpy()
        t_acc[dev] = tw.evaluate(tw.CFG, teachers[dev], tw.task(99), dev,
                                 n_batches=tw.EVAL_BATCHES)
    w_diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        T.named_tensors(teachers["cuda"]).values(),
        T.named_tensors(teachers["cpu"]).values()))
    d_loss, s_acc = {}, {}
    for src, dev in (("cuda", "cuda"), ("cuda", "cpu"), ("cpu", "cpu")):
        dl = []
        res = tw.distill_had(
            tw.CFG, copy.deepcopy(teachers[src]).to(dev), tw.task(0), dev,
            topn=tw.TOPN, steps_per_stage=sps, eval_task=tw.task(99),
            eval_batches=tw.EVAL_BATCHES,
            on_step=lambda i, loss, own: dl.append(loss.detach()))
        d_loss[src, dev] = torch.stack(dl).cpu().numpy()
        s_acc[src, dev] = res.accuracy
    check(all(np.isfinite(x).all() for x in [*t_loss.values(),
                                            *d_loss.values()]), "losses")

    def parting(a, b, tol):
        rel = np.abs(a - b) / np.abs(b)
        over = np.flatnonzero(rel > tol)
        return (int(over[0]) if over.size else None), float(rel.max())
    t_first, t_max = parting(t_loss["cuda"], t_loss["cpu"], 1e-5)
    d_first, d_max = parting(d_loss["cuda", "cuda"], d_loss["cuda", "cpu"],
                             1e-4)
    stage = (f" (stage {int(sched.stage_at(d_first))})"
             if d_first is not None else "")
    log(f"phase 12 (a') distill_encoder, the same seeds on the card and "
        f"the CPU: teachers' losses part (1e-5 relative) at step "
        f"{t_first} of {len(t_loss['cpu'])}, {t_max:.2e} at most, weights "
        f"{w_diff:.2e} apart at the end; teacher accuracy card "
        f"{t_acc['cuda']:.4f} / CPU {t_acc['cpu']:.4f}. Distilling the "
        f"card's teacher (stages end at steps {sched.stage1_end}, "
        f"{sched.stage2_end}, {sched.stage3_end}, {sched.stage4_end}) on "
        f"the card and on the CPU: losses part (1e-4) at step {d_first}"
        f"{stage}, {d_max:.2e} at most; student accuracy card "
        f"{s_acc['cuda', 'cuda']:.4f} / CPU {s_acc['cuda', 'cpu']:.4f}. "
        f"The CPU's teacher distilled on the CPU: "
        f"{s_acc['cpu', 'cpu']:.4f}. {time.perf_counter() - t0:.1f} s")


def phase12_bf16(card: str, profile: bool = False) -> None:
    """(c): smollm-135m's train_4k cell on the card at phase 10's batch,
    the distill attention in float32 and then bfloat16; with `profile`
    (``--profile``), one more step of each profiled (kernel time by
    group, ~1 min each)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as M
    batch = DRYRUN_BATCH["train_4k"]
    cfg, shape = get_config(SMOLLM), M.SHAPES["train_4k"]
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        t0 = time.perf_counter()
        rec = D.run_cell(SMOLLM, "train_4k", batch=batch, attn_dtype=dt)
        check(rec["status"] == "ok", rec.get("trace"))
        log(f"phase 12 (c) {SMOLLM} train_4k batch {batch} attn {tag}: "
            f"step {rec['step_s']:.4f} s, peak "
            f"{rec['memory']['peak_memory_in_bytes'] / 2**30:.3f} GiB, "
            f"counted flops {rec['roofline']['flops']:.4e} bytes "
            f"{rec['roofline']['bytes_hbm']:.4e}, {card}")
        _free()
        if not profile:
            continue
        gen = torch.Generator(device="cuda").manual_seed(0)
        step, _ = D._train_runner(cfg, shape, batch, torch.device("cuda"),
                                  gen, None, dt)
        log(f"phase 12 (c) {SMOLLM} train_4k batch {batch} attn {tag}, one "
            f"more step profiled: {_busy_share(step)}; the cell and the "
            f"profile {time.perf_counter() - t0:.1f} s")
        del step
        _free()


def phase12(card: str, records: dict, mesh: tuple,
            profile: bool = False) -> dict:
    """Phase 12 (the module docstring); `mesh` is (b)'s subprocess, started
    after phase 11 (`phase12_mesh_start`). Adds the kernels' records at
    the long-context example's shapes to `records` and returns their
    launches."""
    import torch
    t0 = time.perf_counter()
    records.update(phase12_records(
        torch.Generator(device="cuda").manual_seed(12)))
    _free()
    launches = phase12_examples()
    phase12_bf16(card, profile)
    phase12_mesh_finish(*mesh)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    return launches


def _free() -> None:
    """Return the memory of dropped engines and models to the card."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="profile prefill and decode windows of the "
                         "full-size engines of phases 4-8 into DIR, and "
                         "phase 12 (c)'s train steps")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU "
              "port and has no CPU mode", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT}/src "
              f"({e}); run from a checkout of the repository",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    weights_dir = tempfile.mkdtemp(prefix="chip_smoke_weights_")
    mesh = None
    try:
        card = phase1()
        records = phase2()
        phase3()
        phase3_vision()
        phase3_jamba()
        counts, engines, runs = phase4()
        phase5(engines, runs)
        if args.profile:
            profile_windows(engines, args.profile)
        digests = {name: r["digest"] for name, r in runs.items()}
        save_weights(engines["paged"].runner.model, weights_dir)
        del engines, runs
        vision_counts, engine = phase6()
        counts.update(vision_counts)
        if args.profile:
            profile_vision(engine, args.profile)
        del engine                      # phase 8's weights need the room
        _free()
        engine = phase7()
        if args.profile:
            profile_decode(engine, "mamba2_decode_4x3k_paged", args.profile,
                           3072)
        del engine
        _free()
        dbrx_counts, engine = phase8()
        counts.update(dbrx_counts)
        if args.profile:
            profile_decode(engine, "dbrx_decode_4x2k_paged", args.profile,
                           2048)
        del engine
        _free()
        phase9()
        _free()
        phase10(records, counts)
        _free()
        counts.update(phase11(card, digests, weights_dir, records))
        _free()
        mesh = phase12_mesh_start()
        counts.update(phase12(card, records, mesh,
                              profile=args.profile is not None))
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(weights_dir, ignore_errors=True)
        if mesh is not None:
            if mesh[0].poll() is None:
                mesh[0].kill()
            mesh[0].wait()
            mesh[2].close()
            shutil.rmtree(mesh[1], ignore_errors=True)
    for name, rec in records.items():
        rec["launches"] = counts[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(card)
    log(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                for rec in records.values()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
