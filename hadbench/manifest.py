"""``BENCHMARK.json`` and the files it names: a cell's configuration
(``configs/<config>.json``), traffic mix (``traffic/<traffic>.json``) and
correctness limits (``limits/<workload>.json``), found by name, and the
model module its configuration names (``reference/<name>.py``)."""
from __future__ import annotations

import json
import re
from pathlib import Path

from hadbench import reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def reports(metric: dict, workload: str) -> bool:
    """Whether `metric` is reported in the cell `workload`."""
    return "workloads" not in metric or workload in metric["workloads"]


def reference_name(config: dict) -> str:
    """The name of the model module a configuration names: its
    ``"reference"`` key, by default ``model``."""
    return config.get("reference", reference.DEFAULT)


def cell(bench: dict, workload: str) -> dict:
    """Everything one run of `workload` needs, read from its files."""
    wl = [w for w in bench["workloads"] if w["name"] == workload]
    if not wl:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    wl = wl[0]
    config = read_json("configs", wl["config"])
    return {"name": workload, "chips": wl["chips"], "config": config,
            "reference": reference_name(config),
            "traffic": read_json("traffic", wl["traffic"]),
            "limits": read_json("limits", workload),
            "end_to_end": [m for m in bench["end_to_end"]
                           if reports(m, workload)],
            "per_layer": [m for m in bench["per_layer"]
                          if reports(m, workload)]}
