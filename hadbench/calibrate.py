#!/usr/bin/env python3
"""Readings that set a cell's correctness limit (``limits/<cell>.json``),
on the card, at the cell's own size:

    python3 hadbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds 10 [--control-seeds 3] [--fault NAME] [--out FILE]

For each seed it runs the cell (set-up, a window of `--seconds` at the
cell's load, the check) and prints one JSON line with the program's
readings (``check.numbers``: the lower reading of a number is its
largest over a dozen seeds or more) and its `correct`; on the first
`--control-seeds` seeds it also judges the fp8 control's tokens on the
same sampled requests as the program's are judged (``control``: its
readings, the upper reading being the smallest of these, and its
`correct`). With `--fault` the program runs with that fault of
``faults.py`` planted. The benchmark's runs never call it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import run


def main(argv=None) -> int:
    for path in (run.ROOT / "src", run.ROOT):
        sys.path.insert(0, str(path))
    from hadbench import faults, manifest
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control-seeds", type=int, default=0)
    ap.add_argument("--fault", choices=faults.NAMES)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run.cache_env(run.ROOT)
    import torch

    cell = manifest.cell(manifest.load(run.ROOT), args.workload)
    if not torch.cuda.is_available():
        run.log("no CUDA device: no readings")
        return 2
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        with (faults.planted(args.fault) if args.fault
              else contextlib.nullcontext()):
            r = run.run_cell(cell, seed=seed, seconds=args.seconds,
                             trace=False, keep_gaps=True,
                             control="fp8" if i < args.control_seeds
                             else None)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "fault": args.fault, "correct": r["correct"],
                           "gaps": r["info"]["gaps"],
                           "control": r["info"].get("control"),
                           "gap_values": r["info"]["gap_values"],
                           "control_values":
                               r["info"].get("control_values"),
                           "attempted": r["attempted"],
                           "failed": r["failed"],
                           "metrics": {k: v["value"] for k, v in
                                       r["metrics"].items()},
                           "info": {k: v for k, v in r["info"].items()
                                    if k not in ("stats", "gap_values",
                                                 "control_values")},
                           "wall_s": time.perf_counter() - t})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
