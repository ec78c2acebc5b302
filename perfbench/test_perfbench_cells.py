"""Cells are data: a cell made only of new files (a configuration, a
traffic mix, limits and a reader) is found by its name, and a cell's
metrics are those BENCHMARK.json gives it."""
import json
import shutil
from pathlib import Path

import pytest

from perfbench import harness

HERE = Path(__file__).resolve().parent


def test_cells_of_the_benchmark_load():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.chips == w["chips"]
        assert cell.limits["numbers"]
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.reader(m["name"]))


def test_new_files_make_a_new_cell(tmp_path):
    pb = tmp_path / "perfbench"
    for sub in ("configs", "traffic", "limits", "readers"):
        (pb / sub).mkdir(parents=True)
    shutil.copy(HERE / "configs" / "starcoder2-7b-edge2.json",
                pb / "configs" / "new-model.json")
    mix = json.loads((HERE / "traffic" / "code-unshared.json").read_text())
    mix["arrival"]["rate"] = 1.5
    (pb / "traffic" / "new-mix.json").write_text(json.dumps(mix))
    (pb / "limits" / "new-model.new-mix.json").write_text(
        json.dumps({"sample": 4, "numbers": {"logit_gap": {"limit": 1.0}}}))
    (pb / "readers" / "new_metric.x.py").write_text(
        "def read(rec):\n    return 42.0\n")
    (pb / "readers" / "setup_s.py").write_text(
        "def read(rec):\n    return rec['setup_s']\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "new-model",
                     "file": "perfbench/configs/new-model.json"}],
        "workloads": [{"name": "new-model.new-mix", "config": "new-model",
                       "traffic": "new-mix", "chips": 1, "why": "test"}],
        "end_to_end": [{"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "new_metric.x", "unit": "ms",
                       "moves": "setup_s",
                       "workloads": ["new-model.new-mix"]},
                      {"name": "other.y", "unit": "ms", "moves": "setup_s",
                       "workloads": ["elsewhere"]}]}))
    cell = harness.load_cell("new-model.new-mix", root=tmp_path)
    assert cell.mix["arrival"]["rate"] == 1.5
    assert cell.limits["sample"] == 4
    assert [m["name"] for m in cell.per_layer] == ["new_metric.x"]
    rec = {"setup_s": 3.0}
    assert harness.metrics(cell, rec, trace=True) == {
        "new_metric.x": {"value": 42.0, "unit": "ms"}}
    assert harness.metrics(cell, rec, trace=False) == {
        "setup_s": {"value": 3.0, "unit": "s"}}
    with pytest.raises(KeyError):
        harness.load_cell("missing", root=tmp_path)
