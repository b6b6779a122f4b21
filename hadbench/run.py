#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card:

    python3 hadbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up (weights drawn on the card from the
seed, the kernels built or loaded from ``build/repro_torch/``, the
traffic's documents prefilled, both step graphs captured) is timed from
the process's start to the window's opening (`setup_s`). The window
serves the cell's traffic for `--seconds`; then the program is freed and
the plain reference judges a sample of what it served (``check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; ``check`` (each number compared, with its limit) comes
last, and the same numbers are the last lines of standard error.
Without a card, or with fewer than the cell asks for, it prints no
result and exits 2; if JAX or the JAX package was loaded, 3.
"""
from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The process's start on the `time.perf_counter` clock (10 ms
    resolution from /proc; now where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.perf_counter() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_PROCESS = _process_start()

import argparse       # noqa: E402
import gc             # noqa: E402
import importlib      # noqa: E402
import json           # noqa: E402
import math           # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the traced run profiles the window's last PROFILE_S (at most half of
# it), so that reading the profile, which takes seconds, falls after the
# close and the traffic keeps coming until then
PROFILE_S = 4.0


def cache_env(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = root / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process, few threads: the host path is Python and one stream
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules (or `names`) whose whole top-level name is JAX's,
    flax's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def quantity(name: str) -> str:
    """The window quantity an end-to-end metric reports: its name up to
    the first dot (`ttft_p95_ms.open` is `ttft_p95_ms` in the cells that
    list it, under a bound of its own)."""
    return name.split(".")[0]


def judge(got: dict, limits: dict, sound: bool) -> tuple[dict, bool]:
    """Each number a cell compares (``limits/<cell>.json``) beside its
    limit, and whether the run is correct: `sound` and every number
    within its limit (a number not read fails)."""
    compared = {name: {"value": got.get(name, math.inf),
                       "limit": lim["limit"]}
                for name, lim in limits.items()}
    return compared, bool(sound and all(c["value"] <= c["limit"]
                                        for c in compared.values()))


def kernel_shapes(port: dict, engine: dict, module) -> dict:
    """The shapes the kernel work formulas (``kernels/``) read: the
    attention widths, N, the pages and slots of the traffic's `engine`,
    and the layers that launch K1 and K2 (`module`'s `attn_layers`)."""
    from hadbench.reference.model import topn
    return {"n_heads": port["n_heads"], "n_kv_heads": port["n_kv_heads"],
            "head_dim": port["head_dim"],
            "topn": topn(port, engine["max_len"]),
            "page_size": engine.get("page_size", 16),
            "attn_layers": module.attn_layers(port),
            "batch_slots": engine["batch_slots"]}


def warm_up(eng, seed: int, vocab: int) -> None:
    """Capture both step graphs (and build the kernels) on one request of
    two chunks and two new tokens."""
    from hadbench.loops import rng, tokens
    eng.submit(tokens(rng(seed, 11), eng.chunk + 1, vocab), 2)
    eng.run()


def run_cell(cell: dict, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: float | None = None,
             control: str | None = None, keep_gaps: bool = False
             ) -> dict:
    """One run of `cell` (``manifest.cell``) on `device`; returns the
    result line's object. `control` (``calibrate.py``): also judge the
    tokens that reference, in that lower precision, puts first at the
    same positions, as the program's are judged (``info.control``: its
    readings, each number beside its limit, and `correct`); `keep_gaps`:
    keep every gap read (``info.gap_values``, ``info.control_values``)."""
    import torch

    from hadbench import check, driver, program, reference, stats
    from hadbench import trace as tr
    from repro_torch.serve.telemetry import Telemetry
    t_process = time.perf_counter() if t_process is None else t_process
    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    port, traffic = cell["config"]["port"], cell["traffic"]
    engine_kw = traffic["engine"]
    module = reference.module(cell["reference"])
    loop = importlib.import_module(f"hadbench.loops.{traffic['loop']}") \
        .make(traffic, seed=seed, vocab=port["vocab_size"], seconds=seconds)

    # set-up
    model = program.build_model(port, seed=seed, device=device,
                                rules=module.draw_rules)
    tel = Telemetry(trace_capacity=1 << 20, clock=time.time) if trace \
        else None
    eng = program.build_engine(port, model, engine_kw, device=device,
                               telemetry=tel)
    for doc in loop.setup_prompts():
        eng.submit(doc, 0)
    eng.run()
    warm_up(eng, seed, port["vocab_size"])
    eng.reset_stats()
    if trace:
        tr.warm_profiler()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process

    # the window
    prof_s = min(PROFILE_S, 0.5 * seconds)
    tracer = tr.Tracer(seconds - prof_s, prof_s) if trace else None
    k0 = tel.recorder.recorded if trace else 0
    records, t0, t1 = driver.serve(eng, loop, seconds, tracer=tracer)
    if cuda:
        torch.cuda.synchronize()
    summary = stats.window(records, t0, t1)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                         if cuda else 0)}
    metrics, extra = {}, {}
    if not trace:
        for m in cell["end_to_end"]:
            v = setup_s if m["name"] == "setup_s" \
                else summary.get(quantity(m["name"]))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        shapes = kernel_shapes(port, engine_kw, module)
        ctx = tr.Context(tracer, tel.recorder.events()[k0:], port, shapes,
                         shapes["topn"], module)
        for m in cell["per_layer"]:
            v = tr.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if ctx.profiled:
            w0, w1 = ctx.window_ns
            device_info["busy_s"] = ctx.busy_ns / 1e9
            device_info["window_s"] = (w1 - w0) / 1e9
            extra["breakdown"] = ctx.breakdown()
    late = [(r.sent - r.origin) * 1e3 for r in records
            if t0 <= r.sent < t1]
    info = {"setup_s": setup_s, "tokens": summary["tokens"],
            "finished": summary["finished"],
            "ttft_samples": len(summary["ttft_ms"]),
            "itl_samples": len(summary["itl_ms"]),
            "late_p95_ms": stats.percentile(late, 95) if late else None,
            **{k: summary.get(k) for k in (
                "ttft_p50_ms", "ttft_p95_ms", "unanswered_at_close",
                "ttft_p50_first_third_ms", "ttft_p50_last_third_ms")},
            "stats": dict(eng.stats)}

    # correctness, on the program's outputs alone
    del eng, model, tel, tracer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    recs = check.sample(records, seed, traffic["check"]["requests"])
    gaps = check.served_gaps(module, port, recs, seed=seed,
                             max_len=engine_kw["max_len"], device=device)
    over = cell["limits"].get("share_over", {}).get("gap")
    got = check.numbers(gaps, over)
    info.update(check_s=time.perf_counter() - c0, gaps=got,
                checked_requests=len(recs), checked_tokens=int(gaps.size))
    if keep_gaps:
        info["gap_values"] = gaps.tolist()
    compared, correct = judge(got, cell["limits"],
                              gaps.size > 0 and summary["failed"] == 0)
    if control is not None:
        # the control's tokens in the program's place, judged the same way
        ctl = check.served_gaps(module, port, recs, seed=seed,
                                max_len=engine_kw["max_len"], device=device,
                                quant=control)
        ctl_got = check.numbers(ctl, over)
        ctl_compared, ctl_correct = judge(ctl_got, cell["limits"],
                                          ctl.size > 0)
        info["control"] = {"gaps": ctl_got, "check": ctl_compared,
                           "correct": ctl_correct}
        if keep_gaps:
            info["control_values"] = ctl.tolist()
    out = {"correct": bool(correct), "attempted": summary["attempted"],
           "failed": summary["failed"], "metrics": metrics,
           "device": device_info}
    out.update(extra)
    out["info"] = info
    out["check"] = compared
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch

    from hadbench import manifest
    cell = manifest.cell(manifest.load(ROOT), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" available: no result")
        return 2
    result = run_cell(cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), t_process=T_PROCESS)
    found = forbidden_modules()
    if found:
        log(f"loaded in this process: {', '.join(found)}; no result")
        return 3
    for name, c in result["check"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
