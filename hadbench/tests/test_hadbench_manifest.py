"""BENCHMARK.json against the contract's form, and a new cell made of new
files and entries alone."""
import json
import shutil

import numpy as np
import pytest

from hadbench import check, manifest, run, tiny, trace

BENCH = manifest.load()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


one_thread = pytest.fixture(autouse=True)(tiny.one_thread)


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["hadbench"]
    assert BENCH["command"] == ["python3", "hadbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_unique(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert manifest.NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert manifest.UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


def test_every_config_has_a_cell_and_a_file():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"hadbench/configs/{c['name']}.json"
        cfg = manifest.read_json("configs", c["name"])
        assert cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])


def test_every_cell_resolves_and_reports_enough():
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        cell = manifest.cell(BENCH, w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]
        names = set(check.numbers(np.array([0.0, 0.5]), over=0.1))
        assert cell["limits"] and set(cell["limits"]) <= names
        for lim in cell["limits"].values():
            assert lim["limit"] > 0


def test_moves_is_reported_where_the_metric_is():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", [x["name"] for x in BENCH["workloads"]]):
            assert manifest.reports(e2e[m["moves"]], w), (m["name"], w)
        assert callable(trace.reader(m["name"]).read)
        base = m["name"].split(".")[0]
        if base.endswith("_roofline"):
            kernel = base[:-len("_roofline")]
            assert (manifest.HERE / "kernels" / f"{kernel}.py").exists()


def test_every_end_to_end_metric_is_a_window_quantity():
    quantities = {"gen_tok_s", "ttft_p95_ms", "itl_p50_ms", "itl_p95_ms",
                  "setup_s"}
    for m in BENCH["end_to_end"]:
        assert run.quantity(m["name"]) in quantities, m["name"]
    # a family's reader is its quantity's, found by name
    assert trace.reader("execute_ms.decode.open").__file__.endswith(
        "execute_ms.decode.py")


def test_a_new_cell_is_new_files_and_entries(tmp_path, monkeypatch):
    """A config, a mix and limits added as files, and a workload entry
    with end-to-end metrics of its own (a quantity under a new dotted
    name): the run finds them by name, with no code and no existing
    entry changed."""
    for kind in ("configs", "traffic", "limits", "metrics", "kernels"):
        shutil.copytree(manifest.HERE / kind, tmp_path / kind)
    port = tiny.port("smollm-135m")
    (tmp_path / "configs" / "tiny-lm.json").write_text(
        json.dumps({"source": "a test", "reduced": [], "port": port}))
    (tmp_path / "traffic" / "tiny_mix.json").write_text(
        json.dumps(tiny.traffic("open", prefix=False)))
    (tmp_path / "limits" / "tiny-lm.tiny_mix.json").write_text(
        json.dumps({"gap_max": {"limit": 1e-3}}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "tiny-lm.tiny_mix",
                               "config": "tiny-lm", "traffic": "tiny_mix",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "ttft_p95_ms.tiny", "unit": "ms",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny-lm.tiny_mix"]})
    bench["per_layer"].append({"name": "k1_roofline.tiny", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "kernels", "moves": "ttft_p95_ms.tiny",
                               "workloads": ["tiny-lm.tiny_mix"]})
    assert [e for e in bench["end_to_end"] + bench["per_layer"]
            if e in BENCH["end_to_end"] + BENCH["per_layer"]] == \
        BENCH["end_to_end"] + BENCH["per_layer"]
    monkeypatch.setattr(manifest, "HERE", tmp_path)
    cell = manifest.cell(bench, "tiny-lm.tiny_mix")
    assert [m["name"] for m in cell["per_layer"]] == ["k1_roofline.tiny"]
    out = run.run_cell(cell, seed=3, seconds=1.0, trace=False, device="cpu")
    assert out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == {"ttft_p95_ms.tiny", "setup_s"}
    assert out["metrics"]["ttft_p95_ms.tiny"]["value"] > 0
    assert list(out)[-1] == "check"
