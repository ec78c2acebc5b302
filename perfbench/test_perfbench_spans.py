"""The readers of the port's own spans on synthetic records: they read
only spans that began before the profiled sub-window, give None where
there is nothing to read, and put the device's idle gaps down to the
innermost ``rt:`` range; their shared hooks switch the port's tracer on
and drain it."""
from types import SimpleNamespace

import pytest

from perfbench import harness, spans, trace
from perfbench.probes import Probes

READERS = ("step_ms.open", "select_ms.open", "chunk_fill.open",
           "lanes_held.open", "collect_wait_ms.open", "idle_in_enqueue.open")
T0 = 100.0          # the window's t0, monotonic seconds
TRACE_AT = 5.0      # the profiled sub-window began this much later


def _span(i, name, start_s, ms, parent=None, **attrs):
    s0 = int((T0 + start_s) * 1e9)
    return {"id": i, "parent": parent, "name": name, "start_ns": s0,
            "end_ns": s0 + int(ms * 1e6), "attrs": attrs}


def _rec(span_list, **trace):
    return {"t0": T0, "spans": span_list,
            "trace": {"t0": TRACE_AT, **trace}}


def _run():
    """Two steps and a placement before the sub-window; one of each in it,
    which every reader has to leave out (their numbers are far off)."""
    out = []
    for k, (at, late) in enumerate([(1.0, False), (2.0, False),
                                    (TRACE_AT + 1.0, True)]):
        b = 100 * k
        w = 50.0 if late else 1.0          # a profiled span reads slow
        out += [
            _span(b + 2, "scheduler.select", at, 2.0 * w + k, rid=k),
            _span(b + 3, "cluster.step", at + 0.1, 300.0 * w + 20 * k),
            _span(b + 4, "engine.dispatch", at + 0.1, 200.0 * w, b + 3,
                  engine=0),
            _span(b + 5, "engine.admission", at + 0.1, 1.0, b + 4,
                  engine=0, held=2 if late else 8 * (k + 1), lanes=32,
                  stop="pages"),
            _span(b + 6, "engine.prefill_chunk", at + 0.11, 80.0, b + 4,
                  engine=0, rid=k, start=0,
                  tokens=2048 if late else 1000 + 500 * k,
                  padded=0 if late else 1048 - 500 * k),
            _span(b + 7, "engine.collect", at + 0.3, 90.0 * w, b + 3,
                  engine=0),
            _span(b + 8, "engine.collect_wait", at + 0.3, 10.0 * w + k,
                  b + 7, engine=0)]
    return out


def test_readers_read_only_spans_before_the_sub_window():
    rec = _rec(_run())
    read = {m: harness.reader(m)(rec) for m in READERS}
    assert read["step_ms.open"] == pytest.approx(310.0)
    assert read["select_ms.open"] == pytest.approx(2.5)
    assert read["collect_wait_ms.open"] == pytest.approx(10.5)
    # 1000 + 1500 prompt tokens of 2 x 2048 computed
    assert read["chunk_fill.open"] == pytest.approx(100 * 2500 / 4096)
    assert read["lanes_held.open"] == pytest.approx(100 * (8 + 16) / 64)
    assert read["idle_in_enqueue.open"] is None      # no device trace


def test_spans_before_the_windows_start_are_left_out():
    """Set-up's and warm-up's spans (before t0) count for nothing."""
    warm = [_span(900, "cluster.step", -3.0, 5000.0)]
    assert spans.step_ms(_rec(warm + _run())) == pytest.approx(310.0)


@pytest.mark.parametrize("metric", READERS)
@pytest.mark.parametrize("rec", [
    {"t0": T0, "trace": None},
    {"t0": T0, "trace": {"t0": TRACE_AT, "window_s": 3.0}},
    _rec([]),
    _rec([_span(1, "cluster.step", TRACE_AT + 0.5, 300.0)]),
], ids=["untraced", "parent-program", "no-spans", "only-late-spans"])
def test_readers_give_none_with_nothing_to_read(metric, rec):
    assert harness.reader(metric)(rec) is None


def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_idle_gaps_go_to_the_innermost_rt_range():
    """A 1000 us sub-window, busy in [0, 100), [300, 400) and [900, 1000):
    the gap [100, 300) lies under a prefill chunk inside a dispatch, the
    gap [400, 900) under the dispatch alone; pb: phases are not rt:."""
    ua = "user_annotation"
    events = [
        _x("pb:window", 0, 1000, ua),
        _x("k0", 0, 100, "kernel"), _x("memcpy", 300, 100, "gpu_memcpy"),
        _x("k1", 900, 200, "kernel"),            # ends past the window
        _x("rt:engine.dispatch", 50, 900, ua),
        _x("rt:engine.prefill_chunk", 120, 150, ua),
        _x("rt:engine.decode_round", 350, 40, ua),   # no gap in it
        _x("pb:prefill enqueue", 110, 180, ua),
    ]
    idle = spans.idle_by_range(events)
    assert idle == pytest.approx({"engine.prefill_chunk": 200e-6,
                                  "engine.dispatch": 500e-6})
    rec = {"t0": T0, "trace": {"t0": TRACE_AT, "window_s": 1e-3,
                               "idle_rt": idle}}
    assert harness.reader("idle_in_enqueue.open")(rec) == \
        pytest.approx(20.0)
    # no rt: range open: the gap goes to other host work
    bare = [e for e in events if not e["name"].startswith("rt:")]
    assert spans.idle_by_range(bare) == pytest.approx(
        {"other host work": 700e-6})
    assert spans.idle_by_range(events[1:]) == {}     # no sub-window


def test_summarize_reads_rt_ranges_only_where_the_tracer_opened_them():
    ua = "user_annotation"
    events = [_x("pb:window", 0, 1000, ua), _x("k0", 0, 100, "kernel"),
              _x("rt:engine.prefill_chunk", 120, 150, ua)]
    s = trace.summarize(events)
    assert s["idle_rt"] == spans.idle_by_range(events)
    assert "idle_rt" not in trace.summarize(events[:2])


def test_hooks_switch_the_tracer_on_and_drain_it():
    from repro_torch import tracing
    for m in READERS:
        mod = harness._reader(m, harness.REPO)
        assert (mod.begin, mod.collect) == (spans.begin, spans.collect)
    probes = Probes(timing=False)
    served = SimpleNamespace(probes=probes)
    spans.begin(served)
    with tracing.span("cluster.step"):
        with tracing.span("engine.dispatch", engine=0):
            pass
    rec = {}
    spans.collect(served, rec)
    probes.restore()
    assert [s["name"] for s in rec["spans"]] == ["engine.dispatch",
                                                 "cluster.step"]
    with tracing.span("after") as sp:
        assert sp is None
    assert tracing.drain() == []


def test_child_cover_counts_direct_children_only():
    cover = spans.child_cover(_rec(_run()))
    # steps 300 and 320 ms; dispatch 200 + collect 90 each; the nested
    # admission, chunk and collect_wait are not added again
    assert cover["spans"] == 2
    assert cover["total_ms"] == pytest.approx(620.0)
    assert cover["children_ms"] == pytest.approx(580.0)
    assert spans.child_cover(_rec([])) is None
