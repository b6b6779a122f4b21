#!/usr/bin/env python3
"""The knee of an open-loop cell, found once by a sweep on the card: the
cell's traffic at each of `--rates` (requests/s), one window each, with
the backlog it leaves (requests unanswered at the close, the median
TTFT of the window's last third against its first):

    python3 hadbench/sweep.py --workload <name> --rates 4,6,8 \
        --seconds 20 --seed 1

The knee is the highest rate whose backlog does not grow; the cell's
traffic file holds 0.8 of it as a number. The benchmark's runs never
call it.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    run.cache_env(run.ROOT)
    for path in (run.ROOT / "src", run.ROOT):
        sys.path.insert(0, str(path))
    from hadbench import manifest
    base = manifest.cell(manifest.load(run.ROOT), args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        cell = copy.deepcopy(base)
        cell["traffic"]["rate_per_s"] = rate
        r = run.run_cell(cell, seed=args.seed, seconds=args.seconds,
                         trace=False)
        print(json.dumps({"rate_per_s": rate, "correct": r["correct"],
                          "metrics": {k: v["value"] for k, v in
                                      r["metrics"].items()},
                          "info": {k: v for k, v in r["info"].items()
                                   if k != "stats"}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
