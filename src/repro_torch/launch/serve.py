"""Serving launcher for the PyTorch port: continuous-batching HAD inference
over the packed-bit K cache, with staggered mixed-length requests, each
request's tokens streamed the step they commit (the scheduler's
`token_sink` hook, which the asyncio front end consumes too).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --paged                          # on the GPU (the default device)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --reduced --page-topn 2 --device cpu --prompt-len 16 --gen 4

The cache is dense (per-slot rows) unless --paged, --prefix-cache,
--swap-pages or --page-topn asks for the paged pool. Attention is HAD over
packed K bits unless --baseline asks for full precision. Weights are
random, drawn from --seed on the serving device. Each step runs as a
replay of one of the runner's two CUDA graphs (prefill chunk, decode
step); the count is printed at exit. With --async the drive loop is the double-buffered
`Engine.step_pipelined()` and the overlap summary is printed at exit; with
--slo-ttft-ms / --slo-itl-ms the summary adds goodput under those
deadlines.

--mesh-model N serves tensor-parallel over N ranks (``launch.mesh.spawn``,
the ``spawn`` start method): every rank draws the same full weights from
--seed and keeps its shard (heads, kv heads of the caches, the lm_head's
vocabulary slice); rank 0 schedules, samples and prints, the others
follow its plans. N must divide n_kv_heads. The backend is NCCL when
there are N cards (one per rank), gloo otherwise: on one card every rank
uses cuda:0, on the CPU (--device cpu) gloo. On the card the step runs
eager (gloo's collectives cannot be captured; `step graphs: 0`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --paged --mesh-model 3                 # three ranks on one card

A model with cross-attention layers (--arch llama-3.2-vision-11b) is
served text-only, as the JAX launcher serves it: it has no image flag, so
every request's cross layers attend a zero image cache. Images ride in
`Engine.submit(..., extra={"image_embeds": ...})`. SSM and MoE models
(--arch mamba2-130m, jamba-1.5-large-398b --reduced, dbrx-132b) take the
same flags; as in the JAX launcher, a model without attention layers, or
with HAD disabled (mamba2-130m), serves without the binary path, and an
encoder arch exits with a message.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
      --reduced --device cpu --paged --prompt-len 24 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch jamba-1.5-large-398b --reduced --device cpu --prompt-len 24
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh, spawn
from repro_torch.models.transformer import init_params
from repro_torch.serve import Engine, SamplingParams, ServeConfig, Telemetry
from repro_torch.serve.runner import resolve_device
from repro_torch.serve.telemetry import slo_attainment


RANK_TIMEOUT_S = 3600.0   # a tensor-parallel run's ranks, and collectives


def main(argv=None):
    args = _parse(argv)
    if args.mesh_model < 1:
        raise SystemExit(f"--mesh-model must be >= 1, got {args.mesh_model}")
    if args.mesh_model == 1:
        return _serve(args)
    n = args.mesh_model
    cards = (torch.cuda.device_count()
             if resolve_device(args.device).type == "cuda" else 0)
    backend = "nccl" if cards >= n else "gloo"
    return spawn(_serve_rank, n, args, backend=backend,
                 timeout=RANK_TIMEOUT_S)[0]


def _serve_rank(args):
    """One rank of `--mesh-model N`: the whole run on rank 0, the
    worker loop on the others."""
    dev = resolve_device(args.device)
    mesh = make_host_mesh(data=1, model=args.mesh_model,
                          device=None if dev.type == "cuda" else dev)
    return _serve(args, mesh)


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain kernel versions)")
    ap.add_argument("--baseline", action="store_true",
                    help="full-precision attention instead of HAD")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache (block tables + shared page pool); "
                         "the default is the dense cache")
    ap.add_argument("--prompt-len", type=int, default=64,
                    help="mean prompt length")
    ap.add_argument("--len-spread", type=float, default=0.5,
                    help="prompt lengths drawn from mean*(1±spread)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=0,
                    help="total requests (default: 2x slots)")
    ap.add_argument("--stagger", type=int, default=2,
                    help="submit a new request every K steps (0: all up "
                         "front)")
    ap.add_argument("--prefill-chunk", type=int, default=512)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=0,
                    help="page pool size (0: dense-equivalent capacity; "
                         "smaller overcommits and preempts on exhaustion)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="automatic prefix caching (implies --paged)")
    ap.add_argument("--swap-pages", type=int, default=0,
                    help="page-aligned swap-out preemption (implies "
                         "--paged): evicted residents' KV pages move to a "
                         "host pool of this many pages and are restored "
                         "verbatim on re-admission, with no re-prefill")
    ap.add_argument("--page-topn", type=int, default=0,
                    help="two-phase page-sparse decode (implies --paged): "
                         "attend only each row's top-N pages by their "
                         "popcount score bound (--baseline: each slot's by "
                         "their max logit), plus the frontier page")
    ap.add_argument("--policy", choices=("fcfs", "shortest-prompt"),
                    default="fcfs")
    ap.add_argument("--victim-policy", choices=("youngest", "longest-idle"),
                    default="youngest")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--trace-file", default=None,
                    help="dump the step flight recorder and per-request "
                         "lifecycle records as JSONL here at exit (schema: "
                         "repro_torch.serve.telemetry)")
    ap.add_argument("--metrics", action="store_true",
                    help="print the Prometheus-text metrics render and the "
                         "queue/TTFT/ITL percentile summary at exit")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="drive the double-buffered pipelined loop: the "
                         "scheduler builds plan N+1 while step N runs on "
                         "the device (the same tokens; prints the overlap "
                         "summary at exit)")
    ap.add_argument("--stream", action="store_true",
                    help="print every token the step it commits (one line "
                         "per token) as well as each request's sequence at "
                         "exit")
    ap.add_argument("--slo-ttft-ms", type=float, default=0.0,
                    help="TTFT deadline for the goodput summary: a request "
                         "attains its SLO only if its first token arrived "
                         "within this bound (0: no TTFT leg; enables "
                         "telemetry)")
    ap.add_argument("--slo-itl-ms", type=float, default=0.0,
                    help="inter-token deadline for the goodput summary: "
                         "every gap between consecutive tokens must stay "
                         "within this bound (0: no ITL leg; enables "
                         "telemetry)")
    ap.add_argument("--fence", action="store_true",
                    help="synchronize the device between execute and commit "
                         "so per-step execute timings measure device time, "
                         "not dispatch time (enables telemetry)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="tensor-parallel serving over N ranks: wq/wk/wv "
                         "head-sharded, KV pools sharded over kv heads, "
                         "outputs bit-identical to N=1. N must divide "
                         "n_kv_heads. NCCL with N cards, else gloo (one "
                         "card shared by every rank, or the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _serve(args, mesh=None):
    paged = (args.paged or args.prefix_cache or bool(args.swap_pages)
             or bool(args.page_topn))
    device = mesh.device if mesh is not None else resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only — no decode loop")
    binary = not args.baseline and cfg.had.enabled and cfg.has_attention
    model = init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device=device)
    n_req = args.requests or 2 * args.slots
    rng = np.random.default_rng(args.seed)
    lo = max(1, int(args.prompt_len * (1 - args.len_spread)))
    hi = max(lo + 1, int(args.prompt_len * (1 + args.len_spread)) + 1)
    lens = rng.integers(lo, hi, size=n_req)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(s)) for s in lens]
    max_len = int(max(lens)) + args.gen
    slo = bool(args.slo_ttft_ms or args.slo_itl_ms)
    telemetry = (Telemetry(trace_file=args.trace_file, fence=args.fence)
                 if (args.trace_file or args.metrics or args.fence or slo)
                 else None)
    eng = Engine(cfg, model, ServeConfig(
        max_len=max_len, batch_slots=args.slots,
        prefill_chunk=args.prefill_chunk, binary=binary,
        paged=paged,
        page_size=args.page_size, n_pages=args.n_pages or None,
        policy=args.policy, prefix_cache=args.prefix_cache,
        page_topn=args.page_topn or None, swap_pages=args.swap_pages,
        victim_policy=args.victim_policy, mesh=mesh), telemetry=telemetry,
        device=device, eager=mesh is not None and device.type == "cuda")
    if mesh is not None and mesh.model_rank != 0:
        eng.serve_worker()
        return None
    if mesh is not None:
        n, cards = args.mesh_model, (torch.cuda.device_count()
                                     if device.type == "cuda" else 0)
        why = ("one card a rank" if mesh.backend == "nccl" else
               f"{cards} card(s) for {n} ranks, every rank on {device}: "
               f"NCCL needs one card a rank" if cards else "the CPU")
        print(f"mesh: 1 data x {n} model over {n} ranks, backend "
              f"{mesh.backend} ({why})")
        total_b, per_b = eng.runner.cache_device_bytes()
        print(f"  kv pools: {total_b} bytes total, {per_b} per rank")
    try:
        return _drive(args, eng, cfg, prompts, lens, n_req, telemetry, slo,
                      binary, paged, device)
    finally:
        eng.close()


def _drive(args, eng, cfg, prompts, lens, n_req, telemetry, slo, binary,
           paged, device):
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, seed=args.seed)

    # per-token streaming: the scheduler hands every sampled token to the
    # sink the step it commits; the finished arrays must agree with it
    streamed: dict[int, list[int]] = {}

    def sink(rid: int, tok: int) -> None:
        toks = streamed.setdefault(rid, [])
        toks.append(int(tok))
        if args.stream:
            print(f"  + req {rid}[{len(toks) - 1}] = {int(tok)}", flush=True)

    eng.scheduler.token_sink = sink
    step = eng.step_pipelined if args.async_mode else eng.step

    t0 = time.perf_counter()
    results: dict[int, np.ndarray] = {}
    ids: list[int] = []
    warm = args.slots if args.stagger else n_req
    for i in range(warm):
        ids.append(eng.submit(prompts[i], max_new_tokens=args.gen,
                              sampling=sampling))
    next_req, steps, req_metrics = warm, 0, []
    while (eng.queue or any(s.request is not None for s in eng.slots)
           or next_req < n_req or eng._inflight is not None):
        for fr in step():
            results[fr.request_id] = fr.tokens
        req_metrics += eng.pop_finished_metrics()
        steps += 1
        if args.stagger and next_req < n_req and steps % args.stagger == 0:
            ids.append(eng.submit(prompts[next_req], max_new_tokens=args.gen,
                                  sampling=sampling))
            next_req += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    req_metrics += eng.pop_finished_metrics()

    gen_tok = eng.stats["tokens_generated"]
    print(f"arch={cfg.name} device={device} N={eng.n} slots={args.slots} "
          f"requests={n_req} prompt_lens={lens.tolist()} gen={args.gen}")
    for rid in ids:
        if streamed.get(rid, []) != results[rid].tolist():
            raise RuntimeError(f"req {rid}: streamed tokens diverge from "
                               f"the finished array")
        print(f"  req {rid}: {results[rid].tolist()}")
    print(f"wall {dt:.2f}s  decode_steps={eng.stats['decode_steps']} "
          f"prefill_chunks={eng.stats['prefill_chunks']} "
          f"({gen_tok / dt:.1f} generated tok/s)")
    print(f"attention: {'HAD' if binary else 'full precision'}, "
          f"step graphs: {eng.runner.graph_count()}")
    if args.async_mode:
        ov = eng.overlap_stats()
        print(f"pipeline: {ov['pipelined_steps']} double-buffered steps, "
              f"{100 * ov['overlap_frac']:.0f}% of scheduling overlapped "
              f"with device execution "
              f"({ov['overlap_s'] * 1e3:.1f}/{ov['schedule_s'] * 1e3:.1f} "
              f"ms)")
    if paged:
        a = eng.allocator
        print(f"kv pool: peak {a.peak_in_use}/{a.n_pages} pages x "
              f"{a.page_size} tok, {eng.stats['preemptions']} preemptions, "
              f"max {eng.stats['max_residents']} concurrent residents")
        mode = (f"top-{args.page_topn} page-sparse" if args.page_topn
                else "dense")
        print(f"decode traffic ({mode}): "
              f"{eng.stats['decode_pages_touched']} pages attended, "
              f"~{eng.stats['decode_hbm_bytes']} B KV read")
    if args.prefix_cache:
        pc = eng.prefix
        print(f"prefix cache: {eng.stats['cached_tokens']} prompt tok "
              f"served from cached pages ({pc.hits} page hits, "
              f"{pc.registered} registered, {pc.evictions} evicted, "
              f"{len(pc)} resident entries)")
    if args.swap_pages:
        sw = eng.swap
        print(f"swap pool: {eng.stats['swap_outs']} swap-outs / "
              f"{eng.stats['swap_ins']} swap-ins (peak {sw.peak_in_use}/"
              f"{sw.capacity} pages), {eng.stats['swapped_tokens']} tok "
              f"restored without re-prefill vs "
              f"{eng.stats['replayed_tokens']} recomputed, "
              f"{eng.stats['swap_out_bytes']} B out / "
              f"{eng.stats['swap_in_bytes']} B in")
    if telemetry is None:
        eng.check()
        return results

    def pcts(xs):
        if not xs:
            return "n/a"
        ms = np.asarray(xs, np.float64) * 1e3
        p = [float(np.percentile(ms, q)) for q in (50, 95, 99)]
        return f"{p[0]:.1f}/{p[1]:.1f}/{p[2]:.1f} ms"

    by_id = sorted(req_metrics, key=lambda m: m.request_id)
    ttft = [m.ttft for m in by_id if m.ttft is not None]
    queue = [m.queue_time for m in by_id if m.queue_time is not None]
    itl = [s for m in by_id for s in m.itl]
    print(f"latency (p50/p95/p99): queue {pcts(queue)} | "
          f"TTFT {pcts(ttft)} | ITL {pcts(itl)}")
    if slo:
        att = slo_attainment(
            req_metrics,
            ttft_s=args.slo_ttft_ms / 1e3 if args.slo_ttft_ms else None,
            itl_s=args.slo_itl_ms / 1e3 if args.slo_itl_ms else None)
        legs = []
        if args.slo_ttft_ms:
            legs.append(f"TTFT<={args.slo_ttft_ms:g}ms")
        if args.slo_itl_ms:
            legs.append(f"ITL<={args.slo_itl_ms:g}ms")
        print(f"SLO ({', '.join(legs)}): {att['attained']}/"
              f"{att['total']} requests attained "
              f"({100 * att['attainment']:.0f}%) | goodput "
              f"{att['attained'] / dt:.2f} req/s of "
              f"{att['total'] / dt:.2f} req/s served")
    victims = [m for m in by_id
               if any(n for k, n in m.preemptions.items()
                      if k != "lru-evict")]
    if victims:
        print(f"preempted requests ({len(victims)}):")
        for m in victims:
            kinds = ", ".join(f"{k} x{n}"
                              for k, n in sorted(m.preemptions.items()) if n)
            print(f"  req {m.request_id}: {kinds}, "
                  f"{m.swapped_tokens} tok swapped back, "
                  f"{m.replayed_tokens} replayed, "
                  f"{m.swap_out_bytes} B out")
    if args.metrics:
        print(telemetry.registry.render())
    if args.trace_file:
        n = eng.dump_trace(requests=req_metrics)
        print(f"wrote {n} trace events -> {args.trace_file}")
    else:
        eng.check()
    return results


if __name__ == "__main__":
    main()
