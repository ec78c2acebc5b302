"""Cells are data: a cell made only of new files (a configuration with
its model kind, a traffic mix, limits and readers, hooks and all) is
found by its name and runs; a cell's metrics are those BENCHMARK.json
gives it; a configuration whose kind is missing or incomplete is
refused when its cell is loaded."""
import json
import shutil
import time
from pathlib import Path

import pytest

from perfbench import harness, size_pool

HERE = Path(__file__).resolve().parent
CELL = "new-model.new-mix"
SPAN_READERS = ("step_ms.open", "select_ms.open", "chunk_fill.open",
                "lanes_held.open", "collect_wait_ms.open",
                "idle_in_enqueue.open")

# a kind that is the dense decoder, counting each call
RECORDED = '''"""The dense decoder, counting each call of its functions."""
from perfbench.models import dense

CALLS = {}


def _counted(name):
    fn = getattr(dense, name)

    def call(*args, **kw):
        CALLS[name] = CALLS.get(name, 0) + 1
        return fn(*args, **kw)
    return call


spec = _counted("spec")
model_config = _counted("model_config")
make_weights = _counted("make_weights")
copy_weights = _counted("copy_weights")
engine_params = _counted("engine_params")
weight_bytes = _counted("weight_bytes")
page_bytes = _counted("page_bytes")
logits_at = _counted("logits_at")
flops = _counted("flops")
'''

# a reader with all three hooks: each notes, in the module's own state,
# when it ran and what it saw; collect hands the notes to the record
HOOKED = '''"""How many hooks ran; each notes what it saw."""
SEEN = {}


def _count(name, **saw):
    SEEN[name] = dict(saw, calls=SEEN.get(name, {}).get("calls", 0) + 1)


def prepare(served):
    _count("prepare", engines=len(served.engines))


def begin(served):
    _count("begin", engines=len(served.engines),
           cluster=served.cluster is not None)


def collect(served, rec):
    _count("collect", engines=len(served.engines), steps=len(rec["steps"]))
    rec["hooked"] = dict(SEEN)


def read(rec):
    return len(rec["hooked"]) if "hooked" in rec else None
'''


def _bench(tmp_path, kind="recorded", kind_src=RECORDED, per_layer=()):
    """A benchmark of new files under ``tmp_path``: a copy of the
    starcoder2 configuration naming ``kind``, a mix at 1.5 req/s, limits,
    and the readers of ``per_layer`` (new ones or copies)."""
    pb = tmp_path / "perfbench"
    for sub in ("configs", "traffic", "limits", "readers", "models"):
        (pb / sub).mkdir(parents=True)
    conf = json.loads((HERE / "configs" / "starcoder2-7b-edge2.json")
                      .read_text())
    if kind is None:
        del conf["model"]
    else:
        conf["model"] = kind
    if kind_src is not None:
        (pb / "models" / f"{kind}.py").write_text(kind_src)
    (pb / "configs" / "new-model.json").write_text(json.dumps(conf))
    mix = json.loads((HERE / "traffic" / "code-unshared.json").read_text())
    mix["arrival"]["rate"] = 1.5
    (pb / "traffic" / "new-mix.json").write_text(json.dumps(mix))
    (pb / "limits" / f"{CELL}.json").write_text(
        json.dumps({"sample": 4, "numbers": {"logit_gap": {"limit": 1.0}}}))
    (pb / "readers" / "new_metric.x.py").write_text(
        "def read(rec):\n    return 42.0\n")
    (pb / "readers" / "setup_s.py").write_text(
        "def read(rec):\n    return rec['setup_s']\n")
    for name in per_layer:
        if name == "hooked.x":
            (pb / "readers" / "hooked.x.py").write_text(HOOKED)
        elif name != "new_metric.x":
            shutil.copy(HERE / "readers" / f"{name}.py", pb / "readers")
    cell = [CELL]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "new-model",
                     "file": "perfbench/configs/new-model.json"}],
        "workloads": [{"name": CELL, "config": "new-model",
                       "traffic": "new-mix", "chips": 1, "why": "test"}],
        "end_to_end": [{"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": m, "unit": "ms", "moves": "setup_s",
                       "workloads": cell} for m in per_layer]
        + [{"name": "other.y", "unit": "ms", "moves": "setup_s",
            "workloads": ["elsewhere"]}]}))


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
        assert all(callable(getattr(cell.kind, f))
                   for f in harness.KIND_FUNCS)


def test_new_files_make_a_new_cell(tmp_path):
    _bench(tmp_path, per_layer=("new_metric.x",))
    cell = harness.load_cell(CELL, root=tmp_path)
    assert cell.mix["arrival"]["rate"] == 1.5
    assert cell.limits["sample"] == 4
    assert [m["name"] for m in cell.per_layer] == ["new_metric.x"]
    assert Path(cell.kind.__file__) == \
        tmp_path / "perfbench" / "models" / "recorded.py"
    rec = {"setup_s": 3.0}
    assert harness.metrics(cell, rec, trace=True) == {
        "new_metric.x": {"value": 42.0, "unit": "ms"}}
    assert harness.metrics(cell, rec, trace=False) == {
        "setup_s": {"value": 3.0, "unit": "s"}}
    with pytest.raises(KeyError):
        harness.load_cell("missing", root=tmp_path)


# the CPU rehearsal's sizes (test_perfbench_faults.py's)
SHRINK = {"layers": 2, "d_model": 64, "heads": 4, "kv_heads": 2,
          "d_ff": 96, "vocab": 97, "init_std": 0.018 * (4608 / 64) ** 0.5}


def _small(cell):
    cell.conf["serve"].update(lanes=8, max_len=160, prefill_chunk=64)
    cell.mix.update(arrival={"kind": "poisson", "rate": 16.0},
                    drain_s=120.0,
                    prompt={**cell.mix["prompt"], "median": 60, "min": 20,
                            "max": 120},
                    output={**cell.mix["output"], "median": 8, "min": 3,
                            "max": 24})
    return cell


def test_new_kind_and_hooked_readers_drive_a_traced_run(tmp_path):
    """A whole traced run on the CPU through a kind and readers that are
    new files: every function of the kind is reached, each distinct hook
    runs once (the six span readers share one ``begin`` and one
    ``collect``), at its place in the run, and the hooked reader's value
    comes out."""
    per_layer = ("hooked.x", "mfu.open") + SPAN_READERS
    _bench(tmp_path, per_layer=per_layer)
    cell = _small(harness.load_cell(CELL, root=tmp_path))
    opts = harness.Options(seed=2**31 + 99, seconds=1.0, trace=True,
                           device="cpu", shrink=SHRINK, num_pages=200,
                           sample=4)
    hooks = harness.reader_hooks(cell)
    assert [len(hooks[h]) for h in harness.HOOKS] == [1, 2, 2]
    served = harness.setup(cell, opts)
    reqs = harness.requests(cell, opts, served.spec["vocab"], 2)
    rec = harness.settle(served, reqs,
                         harness.serve(served, reqs, time.perf_counter()))
    checked = harness.judge(served, rec)
    got = harness.metrics(cell, rec, trace=True)

    assert rec["hooked"] == {
        "prepare": {"calls": 1, "engines": 0},
        "begin": {"calls": 1, "engines": 2, "cluster": True},
        "collect": {"calls": 1, "engines": 2, "steps": len(rec["steps"])}}
    # the tracer was on from the warm-up's end to the drain's: one
    # decision span a request submitted
    names = [s["name"] for s in rec["spans"]]
    assert names.count("scheduler.select") == rec["submitted"] > 0
    assert "cluster.step" in names
    # the step calls timed are the window's: one a chunk or round span,
    # none of the warm-up's
    assert len(rec["prefill_calls"]) == names.count("engine.prefill_chunk")
    assert len(rec["decode_calls"]) == names.count("engine.decode_round")
    # the span readers' values depend on how fast the CPU steps before
    # the profiled sub-window; the hooked reader's and mfu's do not
    assert {"hooked.x", "mfu.open"} <= set(got) <= set(per_layer)
    assert got["hooked.x"]["value"] == 3
    assert all(v["ok"] for v in checked["verdict"].values()), checked
    # the tracer the span readers' begin switched on is off again
    from repro_torch import tracing
    with tracing.span("after") as sp:
        assert sp is None
    # size_pool.py's arithmetic reaches the last two functions
    sv = cell.conf["serve"]
    plan = size_pool.plan(cell.kind, served.spec, sv, 200, 10**9, 8 * 10**9)
    assert plan["num_pages"] > 0
    assert set(cell.kind.CALLS) == set(harness.KIND_FUNCS), cell.kind.CALLS


def test_untraced_run_calls_no_hook(tmp_path):
    _bench(tmp_path, per_layer=("hooked.x",))
    cell = _small(harness.load_cell(CELL, root=tmp_path))
    opts = harness.Options(seed=2**31 + 98, seconds=0.5, device="cpu",
                           shrink=SHRINK, num_pages=200)
    served = harness.setup(cell, opts)
    reqs = harness.requests(cell, opts, served.spec["vocab"], 2)
    rec = harness.settle(served, reqs,
                         harness.serve(served, reqs, time.perf_counter()))
    assert served.hooks == {} and "hooked" not in rec


_NO_FLOPS = RECORDED.replace('flops = _counted("flops")\n', "")


@pytest.mark.parametrize("kind,src,match", [
    ("noflops", _NO_FLOPS, r"noflops\.py defines no flops"),
    ("absent", None, r"model kind 'absent': no file .*absent\.py"),
    (None, None, r"new-model\.json: no \\?\"model\\?\" key"),
], ids=["missing-function", "missing-file", "no-model-key"])
def test_a_kind_that_is_incomplete_is_refused(tmp_path, kind, src, match):
    _bench(tmp_path, kind=kind, kind_src=src)
    with pytest.raises((AttributeError, FileNotFoundError, KeyError),
                       match=match):
        harness.load_cell(CELL, root=tmp_path)
