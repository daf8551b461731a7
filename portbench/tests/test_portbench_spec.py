"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file of its own; a cell added as new files only is found and
run."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_size():
    assert set(DOC) == {"command", "paths", "run_seconds", *KEYS}
    assert len(json.dumps(DOC)) <= 64 * 1024
    assert DOC["paths"] == ["portbench"]
    assert 1 <= len(DOC["command"]) <= 32 and all(TEXT.match(w) for w in DOC["command"])
    assert isinstance(DOC["run_seconds"], int) and 1 <= DOC["run_seconds"] <= 51


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries_keys_names_and_units(group):
    entries = DOC[group]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer"):
            assert key not in e or TEXT.match(e[key]), (e["name"], key)
        if group == "configs":
            assert TEXT.match(e["source"]) and e["source"].startswith("https://")


def test_metrics_reported_and_bounded():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    cells = {w["name"] for w in DOC["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    # set-up is reported in every cell, those added later too
    assert "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in DOC["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        moved = e2e[m["moves"]]
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
    for cell in cells:
        got = [m["name"] for m in DOC["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in got and len(got) >= 2, cell
        assert any(cell in m.get("workloads", cells) for m in DOC["per_layer"]), cell


def test_cells_and_configs():
    configs = {c["name"]: c for c in DOC["configs"]}
    used = {w["config"] for w in DOC["workloads"]}
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in DOC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) for w in DOC["workloads"])
    assert sum(w["chips"] == 4 for w in DOC["workloads"]) <= max(1, len(pairs) // 4)
    for c in configs.values():
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    # a full check of 24 cells fits the driver's 43,200 seconds
    assert (2 + 14 * 24) * (DOC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_name_is_found():
    spec = harness.Spec()
    for w in DOC["workloads"]:
        spec.config(w["config"])
        traffic = spec.traffic(w["traffic"])
        assert issubclass(spec.driver(traffic).Cell, harness.Cell)
        assert spec.limits(w["name"])
        for trace in (False, True):
            for m in spec.metrics(w["name"], trace):
                assert callable(spec.reader(m["name"]))
    files = {p.name for p in (harness.PKG / "metrics").glob("*.py")}
    assert files == {f"{m['name']}.py" for m in DOC["end_to_end"] + DOC["per_layer"]}


def test_a_cell_added_as_files_only_is_found_and_run(tmp_path):
    """A copy of the benchmark with a new configuration, traffic mix, limits,
    driver and per-layer metric, each a new file and a new entry: the
    harness finds each by name and runs the cell."""
    pkg = tmp_path / "portbench"
    shutil.copytree(harness.PKG, pkg, ignore=shutil.ignore_patterns("out", "cache",
                                                                    "__pycache__"))
    doc = json.loads(json.dumps(DOC))
    cfg = json.loads((harness.PKG / "configs" / "config5-1m.json").read_text())
    cfg.update(name="tiny", nodes=256 * 3)
    (pkg / "configs" / "tiny.json").write_text(json.dumps(cfg))
    drift = json.loads((harness.PKG / "traffic" / "drift.json").read_text())
    drift.update(driver="gated_step_copy", sigma=0.2)
    (pkg / "traffic" / "drift-strong.json").write_text(json.dumps(drift))
    shutil.copy(pkg / "drivers" / "gated_step.py", pkg / "drivers" / "gated_step_copy.py")
    shutil.copy(pkg / "limits" / "config5-1m.drift.json", pkg / "limits" / "tiny.strong.json")
    (pkg / "metrics" / "steps_seen.py").write_text(
        "def read(ctx):\n    return ctx.steps\n")
    doc["configs"].append(dict(doc["configs"][0], name="tiny",
                               file="portbench/configs/tiny.json"))
    doc["workloads"].append(dict(doc["workloads"][0], name="tiny.strong", config="tiny",
                                 traffic="drift-strong"))
    doc["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                             "source": "program_counter", "layer": "gate",
                             "moves": "infer_nodes_per_s", "workloads": ["tiny.strong"]})
    for m in doc["end_to_end"]:
        if m["name"] == "infer_nodes_per_s":
            m["workloads"].append("tiny.strong")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    spec = harness.Spec(root=tmp_path, pkg=pkg)
    res = harness.run("tiny.strong", 7, 0.2, True, torch.device("cpu"), 0.0, spec)
    assert spec.driver(spec.traffic("drift-strong")).__file__ == str(
        pkg / "drivers" / "gated_step_copy.py")
    assert res["metrics"]["steps_seen"]["value"] == res["attempted"] >= 1
    assert res["correct"] and set(res["check"]) == set(spec.limits("tiny.strong"))
