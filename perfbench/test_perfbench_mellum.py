"""The mellum2-12b-edge2 cell on the CPU: a small edge pair of the
``moe_window`` kind (a period of three windowed layers and one yarn
layer, twice; dropless experts) runs the whole of a traced run but the
look for a card.  Served as it is, it is correct and its three readers
read their records; with the program broken underneath, once for each
of the mechanisms the cell adds, it is not; the float8 control reads
above the limit.  The readers' arithmetic is held to hand counts, and a
program without the counter or the windowed op leaves their metrics out
without raising."""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from perfbench import check, harness, moe_window_layers, roofline, traffic

CELL = "mellum2-12b-edge2.code-unshared"
READERS = ("expert_gemm_roofline.mellum2", "window_decode_roofline.mellum2",
           "expert_skew.mellum2")
# two periods of the published layer kinds, 8 experts top-4, window 8:
# prompts of 20-120 tokens cross it many times; the published logit scale
# (std 0.02 at d 2304)
SHRINK = {"layers": 8, "d_model": 64, "heads": 4, "kv_heads": 2,
          "d_expert": 32, "experts": 8, "top_k": 4, "vocab": 97,
          "window": 8, "init_std": 0.02 * (2304 / 64) ** 0.5}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, before the module's runs (the sound one
    included): the runs step on the wall clock, and a worker's threads
    contending with its neighbours' for the cores slow each small step
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_cell():
    real = harness.load_cell(CELL)
    conf = json.loads(json.dumps(real.conf))
    conf["serve"].update(lanes=8, max_len=160, prefill_chunk=64)
    mix = json.loads(json.dumps(real.mix))
    # its own arrivals, lengths and blocks: 16 requests the CPU serves
    mix.update(arrival={"kind": "poisson", "rate": 16.0}, drain_s=120.0,
               block=traffic.BLOCK,
               prompt={**mix["prompt"], "median": 60, "min": 20, "max": 120},
               output={**mix["output"], "median": 8, "min": 3, "max": 24})
    return harness.Cell(CELL, 1, conf, mix, real.limits, real.end_to_end,
                        real.per_layer)


def _run(breakage=None, trace=False):
    cell = _small_cell()
    opts = harness.Options(seed=2**31 + 99, seconds=1.0, device="cpu",
                           shrink=SHRINK, num_pages=200, sample=6,
                           trace=trace)
    served = harness.setup(cell, opts, breakage)
    # the engines' routed-rows counters, which the run's end lets go
    counters = [e.expert_rows for e in served.engines]
    reqs = harness.requests(cell, opts, served.spec["vocab"], 2)
    rec = harness.settle(served, reqs,
                         harness.serve(served, reqs, time.perf_counter()))
    rec["engine_counters"] = counters
    return served, rec, harness.judge(served, rec)


# ---------------------------------------------------------------------------
# faults planted in the program (the port's modules, patched through the
# probes so that the run's restore undoes them)
# ---------------------------------------------------------------------------


def _top_k_less_one(served):
    """The router keeps one expert fewer than the config's top-k."""
    from repro_torch.models import moe
    top_k = moe._top_k

    def fewer(router_w, cfg, xf):
        m = dataclasses.replace(cfg.moe, top_k=cfg.moe.top_k - 1)
        return top_k(router_w, dataclasses.replace(cfg, moe=m), xf)

    served.probes._patch(moe, "_top_k", fewer)


def _window_less_one(served):
    """Every windowed layer's chunk and decode read one key fewer."""
    from repro_torch.models import attention
    chunk, dec = attention.paged_chunk_attend, attention.paged_decode_attend

    def short(w):
        return None if w is None else w - 1

    served.probes._patch(attention, "paged_chunk_attend",
                         lambda q, kd, vd, start, window=None:
                         chunk(q, kd, vd, start, short(window)))
    served.probes._patch(attention, "paged_decode_attend",
                         lambda q, cache, bt, n, window=None:
                         dec(q, cache, bt, n, short(window)))


def _yarn_factor_dropped(served):
    """The full layers' RoPE leaves out yarn's attention factor."""
    from repro_torch.models import attention
    rope = attention.apply_rope

    def dropped(x, positions, theta=10_000.0, spec=None):
        if spec is not None and spec.kind == "yarn":
            spec = dataclasses.replace(spec, attention_factor=1.0)
        return rope(x, positions, theta, spec)

    served.probes._patch(attention, "apply_rope", dropped)


def _capacity_on(served):
    """The experts drop rows past 1.25x a fair share again: the capacity
    path on the same weights."""
    from repro_torch.models import moe

    def capped(p, cfg, xf, groups=1):
        f = cfg.d_ff
        loop = {"router": p["router"], "we_down": p["we_down"],
                "we_gate": p["we_gate_up"][..., :f],
                "we_up": p["we_gate_up"][..., f:]}
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.25))
        return moe._apply_moe_local(loop, cfg, xf, groups)

    served.probes._patch(moe, "_apply_moe_grouped", capped)


@pytest.fixture(scope="module")
def sound():
    return _run(trace=True)


def test_sound_run_is_correct_and_read(sound):
    served, rec, checked = sound
    assert checked["numbers"]["sampled"] == 6
    assert all(v["ok"] for v in checked["verdict"].values()), checked
    got = harness.metrics(served.cell, rec, trace=True)
    # the cell reads the accepted cell's per-layer metrics too; the span
    # readers' values depend on how fast the CPU steps before the profiled
    # sub-window, mfu's (the moe_window kind's FLOPs) and the skew's do not
    names = {m["name"] for m in served.cell.per_layer}
    assert len(names) == 18
    assert {"expert_skew.mellum2", "mfu.open", "place_ms.open",
            "queue_ms.open"} <= set(got) <= names
    assert got["mfu.open"]["value"] > 0
    # no kernel runs on the CPU: the four rooflines find no device time
    assert not set(got) & {"expert_gemm_roofline.mellum2",
                           "window_decode_roofline.mellum2",
                           "flash_attention_roofline.open",
                           "paged_decode_roofline.open"}
    assert got["expert_skew.mellum2"]["value"] >= 1.0
    assert rec["window_calls"] == [] or all(c[7] == 8
                                            for c in rec["window_calls"])
    # every routed row of the window's calls is in the engines' counters
    # (never zeroed: the warm-up's rows are there too)
    window_rows = sum(int(c[2].sum()) for c in rec["expert_calls"])
    total = sum(int(t.sum()) for t in rec["engine_counters"])
    assert 0 < window_rows <= total
    calls = len(rec["prefill_calls"]) + len(rec["decode_calls"])
    assert len(rec["expert_calls"]) == calls
    assert all(int(c.sum(1).min()) > 0 for _, _, c in rec["expert_calls"])


def test_control_fails_the_limit(sound):
    served, rec, _ = sound
    limit = served.cell.limits["numbers"]["logit_gap"]["limit"]
    low = check.logit_gap(served.cell.kind, served.weights, served.spec,
                          harness.finished(rec), "fp8")
    assert low > limit, low


@pytest.mark.parametrize("fault", [_top_k_less_one, _window_less_one,
                                   _yarn_factor_dropped, _capacity_on],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(fault):
    _, _, checked = _run(fault)
    assert not all(v["ok"] for v in checked["verdict"].values()), checked


# ---------------------------------------------------------------------------
# the readers' arithmetic, and a program without the instruments
# ---------------------------------------------------------------------------


def test_expert_gemm_cost_by_hand():
    rows = np.array([3, 0, 5, 0])
    (b1, f1), (b2, f2) = moe_window_layers.expert_gemm_cost(rows, 16, 8, 2)
    assert f1 == 2 * 8 * 16 * 16 and f2 == 2 * 8 * 8 * 16
    assert b1 == 2 * (2 * 16 * 16 + 8 * (16 + 16))
    assert b2 == 2 * (2 * 8 * 16 + 8 * (8 + 16))
    spec = {"d_model": 16, "d_expert": 8, "dtype": "bfloat16"}
    rec = {"spec": spec,
           "expert_calls": [("prefill", True, np.array([rows])),
                            ("decode", False, np.array([rows * 9]))],
           "trace": {"kernels": {"x_GroupProblemShape_y": 1e-6,
                                 "prepare_grouped_gemm_data<...>": 1e-6,
                                 "other": 5.0}}}
    want = (roofline.bound_s(b1, f1)[0] + roofline.bound_s(b2, f2)[0]) / 2e-6
    assert moe_window_layers.expert_gemm_roofline(rec) == \
        pytest.approx(100 * want)
    # rows-weighted max over mean: (5 * 4 + 45 * 4) / (8 + 72)
    assert moe_window_layers.expert_skew(rec) == pytest.approx(200 / 80)


def test_window_decode_cost_counts_the_window_only():
    nbytes, flops = moe_window_layers.window_decode_cost(
        2, 8, 2, 16, 4, 10, [5, 30], 12, 2)
    ctx = 5 + 12                                   # min(n, window)
    assert flops == 4 * ctx * 8 * 16
    pages = (2 + 1) + (3 + 1)                      # ceil(c / ps) + 1 each
    assert nbytes == 2 * 2 * 8 * 16 * 2 + 2 * ctx * 2 * 16 * 2 \
        + 4 * pages + 4 * 2
    full = roofline.paged_decode_cost(2, 8, 2, 16, 4, 10, [5, 30], 2)
    assert nbytes < full[0] and flops < full[1]
    rec = {"window_calls": [(2, 8, 2, 16, 4, 10, [5, 30], 12, 2)],
           "trace": {"kernels": {"void paged_window_split_kernel<bf16>": 1e-6,
                                 "void paged_window_merge_kernel<bf16>": 1e-6,
                                 "paged_decode_split_kernel": 9.0}}}
    assert moe_window_layers.window_decode_roofline(rec) == pytest.approx(
        100 * roofline.bound_s(nbytes, flops)[0] / 2e-6)


def test_readers_leave_out_what_a_program_without_them_lacks(monkeypatch):
    """Engines with no counter and an ``ops`` with no windowed entry (the
    parent's program): the hooks record nothing and every reading is
    None."""
    from repro_torch.kernels import ops
    monkeypatch.delattr(ops, "paged_flash_decode_window")

    class Engine:
        paged = True

    class Probes:
        profiling = recording = False

        def _patch(self, obj, name, new):
            raise AssertionError("nothing to patch")

    served = type("Served", (), {"probes": Probes(),
                                 "engines": [Engine(), Engine()]})()
    rec = {"spec": {"d_model": 8, "d_expert": 4, "dtype": "bfloat16"},
           "trace": {"kernels": {}}}
    moe_window_layers.prepare(served)
    moe_window_layers.begin(served)
    moe_window_layers.collect(served, rec)
    assert rec["expert_calls"] == [] and rec["window_calls"] == []
    for name in READERS:
        assert harness.reader(name)(rec) is None
    assert harness.reader(READERS[0])({"trace": None}) is None
