"""The readers' arithmetic on synthetic records: percentiles, means and
rates over every request and the whole window, and the profiled
sub-window's busy time and idle gaps."""
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import harness, layers, roofline, trace
from perfbench.models import dense


def _req(rid, arrival, finish, prompt=100, tokens=4, prefix=0, engine=0,
         start=None):
    return SimpleNamespace(
        rid=rid, t_arrival=arrival, t_finish=finish,
        done=finish is not None, prompt=np.zeros((1, prompt)),
        tokens=[0] * tokens, prefix_tokens=prefix, engine_id=engine,
        t_prefill_start=start if start is not None else arrival + 0.1,
        queue_s=0.1)


def _rec(reqs, **kw):
    rec = {"t0": 100.0, "close": 20.0, "seconds": 10.0, "requests": reqs,
           "setup_s": 5.0, "steps": [], "place": [], "trace": None,
           "spec": {"layers": 2, "d_model": 8, "heads": 2, "kv_heads": 1,
                    "head_dim": 4, "d_ff": 16, "vocab": 32, "gated": False,
                    "tied": True},
           "kind": dense}
    rec.update(kw)
    return rec


def test_service_over_every_request_unfinished_counted_to_close():
    reqs = [_req(i, 100.0 + i, 100.0 + i + 1.0 + i) for i in range(19)]
    reqs.append(_req(19, 110.0, None))         # still running at close
    rec = _rec(reqs)
    d = layers.delays_s(rec)
    expect = [1.0 + i for i in range(19)] + [120.0 - 110.0]
    assert np.allclose(d, expect)
    mean = harness.reader("service_mean_ms")(rec)
    assert mean == pytest.approx(np.mean(expect) * 1e3)


def test_host_times_leave_out_the_profiled_steps():
    calls = [(0.0, 0.010, False), (1.0, 0.030, False), (2.0, 0.5, True)]
    assert layers.host_ms(calls) == pytest.approx(20.0)
    rec = _rec([], place=[(0.002, False), (0.004, False), (1.0, True)])
    assert layers.place_ms(rec) == pytest.approx(3.0)


def test_step_calls_are_timed_in_the_window_only():
    """A call before the window (the warm-up's, which captures the
    graphs) or after it is set-up or drain, not a step call's host time;
    a call inside the profiled sub-window is kept, marked traced."""
    from perfbench.probes import Probes
    probes = Probes(timing=True)
    step = probes._timed(lambda x: x + 1, probes.prefill, "prefill enqueue")
    assert step(1) == 2 and probes.prefill == []
    probes.recording = True
    step(2)
    probes.profiling = True
    step(3)
    probes.profiling = probes.recording = False
    step(4)
    assert [traced for _, _, traced in probes.prefill] == [False, True]


def test_skew_and_prefix_share():
    """The largest engine's share of the placements, over every request
    placed (no cell shares prefixes, so no prefix share is read)."""
    reqs = [_req(i, 100.0, 101.0, prompt=200, engine=int(i < 3))
            for i in range(4)]
    reqs.append(_req(4, 100.0, None, engine=None))   # never placed
    rec = _rec(reqs)
    assert layers.engine_skew(rec) == pytest.approx(0.75)
    assert not hasattr(layers, "prefix_hit_share")


def test_p95_over_every_request():
    reqs = [_req(i, 100.0, 100.0 + (i + 1) / 10) for i in range(99)]
    reqs.append(_req(99, 100.0, None))         # counts to close: 20 s
    d = layers.delays_s(_rec(reqs))
    assert harness.reader("service_p95_ms")(_rec(reqs)) == pytest.approx(
        np.percentile(d, 95) * 1e3)
    assert d.max() == pytest.approx(20.0)


def test_model_flops_count_window_work_once():
    spec = _rec([])["spec"]
    r = _req(0, 100.0, 101.0, prompt=10, tokens=3, prefix=4)
    rec = _rec([r])
    # prefill of positions 4..9, decode inputs at positions 10, 11
    want = dense.sequence_flops(spec, 6 + 2,
                                sum(p + 1 for p in range(4, 12)))
    assert layers.model_flops(rec) == pytest.approx(want)
    rec["steps"] = [(0.0, 2.0, False)]
    assert layers.mfu(rec) == pytest.approx(
        100 * want / (2.0 * roofline.PEAK_FLOPS_BF16))


def _ev(name, ts, dur, cat):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur, "cat": cat}


def test_trace_busy_idle_and_gaps():
    events = [
        _ev(trace.WINDOW, 1000.0, 1000.0, "user_annotation"),
        _ev("pb:decode enqueue", 1000.0, 400.0, "user_annotation"),
        _ev("pb:collect", 1600.0, 300.0, "user_annotation"),
        _ev("k1", 1100.0, 100.0, "kernel"),
        _ev("k2", 1150.0, 100.0, "kernel"),      # overlaps k1
        _ev("k1", 1500.0, 100.0, "kernel"),
        _ev("copy", 1950.0, 100.0, "gpu_memcpy"),  # half outside
        _ev("cpu op", 1000.0, 50.0, "cpu_op"),
    ]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx((150 + 100 + 50) * 1e-6)
    assert s["kernels"]["k1"] == pytest.approx(200e-6)
    idle = dict(s["idle"])
    # gaps: 1000-1100 and 1250-1500 under decode enqueue, 1600-1950
    # under collect
    assert idle["decode enqueue"] == pytest.approx(350e-6)
    assert idle["collect"] == pytest.approx(350e-6)
    rec = _rec([], trace=s)
    assert layers.idle_share(rec) == pytest.approx(70.0)
    assert s["device_ops"][0][0] == "k1"


def test_roofline_reader_uses_only_traced_calls():
    s = {"window_s": 1.0, "busy_s": 0.5,
         "kernels": {"void flash_attention_mma<128, 1>(Args)": 1e-3}}
    call = (1, 4, 2, 64, 128, 64, None, 0, 2)
    rec = _rec([], trace=s, attn_calls=[call, call])
    nbytes, flops = roofline.flash_attention_cost(*call)
    bound = roofline.bound_s(nbytes, flops)[0]
    assert layers.flash_attention_roofline(rec) == pytest.approx(
        100 * 2 * bound / 1e-3)
    rec["attn_calls"] = []
    assert layers.flash_attention_roofline(rec) is None
