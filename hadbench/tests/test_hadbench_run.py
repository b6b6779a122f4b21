"""`run.py` on a machine without a card: no result, a non-zero exit; and
the faults a served cell can have make `correct` false when the rest of a
run is driven on the CPU."""
import json
import os
import subprocess
import sys

import pytest
import torch

from hadbench import faults, manifest, run, tiny

BENCH = manifest.load()


one_thread = pytest.fixture(autouse=True)(tiny.one_thread)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal is for none")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(run.ROOT / "hadbench/run.py"),
                        "--workload", "smollm-135m.short_chat", "--seed",
                        "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env,
                       cwd=run.ROOT, timeout=120)
    assert p.returncode == 2, p.stderr
    assert "no result" in p.stderr
    for line in p.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


@pytest.mark.parametrize("fault", faults.NAMES)
def test_a_fault_makes_correct_false(fault):
    with faults.planted(fault):
        out = run.run_cell(tiny.cell(prefix=False), seed=9, seconds=1.0,
                           trace=False, device="cpu")
    assert out["info"]["checked_tokens"] > out["info"]["checked_requests"]
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("fault", ["state", "token"])
def test_a_fault_fails_each_cells_own_limits(fault, workload):
    """The numbers the cells compare (a mean gap, a share over a margin),
    at their limits, on the cell's configuration at the tiny size. (The
    half-batch fault reads 0.035-0.083 in mean gap there, around the fp8
    control's 0.044, as the tiny model's logits are narrow: it is read at
    the cells' own size on the card.)"""
    w = [x for x in BENCH["workloads"] if x["name"] == workload][0]
    cell = tiny.cell(w["config"], prefix=False)
    cell["limits"] = manifest.read_json("limits", workload)
    with faults.planted(fault):
        out = run.run_cell(cell, seed=9, seconds=1.0, trace=False,
                           device="cpu")
    assert set(out["check"]) == set(cell["limits"])
    assert not out["correct"], out["check"]


def test_the_traced_run_profiles_the_windows_end():
    """`--trace 1` on the CPU: the per-layer readers that need no device
    read the flight recorder, and the profiled sub-window is the window's
    last steps (its reading falls after the close)."""
    cell = tiny.cell()
    cell["per_layer"] = [m for m in BENCH["per_layer"]
                         if "smollm-135m.doc_turns" in m["workloads"]]
    out = run.run_cell(cell, seed=4, seconds=2.0, trace=True, device="cpu")
    assert out["correct"], out["check"]
    assert {"sched_host_ms", "execute_ms.decode", "step_mfu.decode"} <= \
        set(out["metrics"])
    assert 0.5 <= out["device"]["window_s"] <= 1.5
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
