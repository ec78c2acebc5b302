"""Readings of the port's own spans (``repro_torch.tracing``) for the
per-layer readers.

A run that traced the port holds ``rec["spans"]``, the list that
``tracing.drain()`` returned after the window, each span ``{"id",
"parent", "name", "start_ns", "end_ns", "attrs"}`` on
``time.monotonic_ns()``, the clock of the record's ``t0``.  The durations and occupancies are read over the spans
that began at or after the window's ``t0`` and before the profiled
sub-window began (``rec["trace"]["t0"]`` seconds later): the part of the
traced run that the profiler's stall has not reached.  The device's idle
time under the port's ``rt:`` ranges is read from the profiled sub-window
(``rec["trace"]["idle_rt"]``, made by :func:`idle_by_range`).

The readers' hooks fill the record: :func:`begin` switches the tracer
on after the warm-up and :func:`collect` drains it once the window has
drained; ``trace.summarize`` adds ``idle_rt``.

Every reading is None where the run holds nothing to read: a run that
did not trace, or a program without the tracer."""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

from perfbench import trace

RT = "rt:"
ENQUEUE = ("engine.prefill_chunk", "engine.decode_round")


def _tracer():
    """The port's tracer, or None in a program that has none."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing


def begin(served) -> None:
    """The span readers' ``begin`` hook: the tracer on, emptied of what
    set-up left, and off again when the probes are restored."""
    tracing = _tracer()
    if tracing is None:
        return
    tracing.drain()
    tracing.enable()
    served.probes.on_restore(tracing.disable)


def collect(served, rec: Dict) -> None:
    """The span readers' ``collect`` hook: the spans into
    ``rec["spans"]``."""
    tracing = _tracer()
    if tracing is not None:
        rec["spans"] = tracing.drain()


def early(rec: Dict, name: str) -> List[Dict]:
    """The spans named ``name`` that began in [t0, t0 + trace t0)."""
    tr = rec.get("trace")
    if not rec.get("spans") or not tr or tr.get("t0") is None:
        return []
    lo = rec["t0"] * 1e9
    hi = (rec["t0"] + tr["t0"]) * 1e9
    return [s for s in rec["spans"]
            if s["name"] == name and lo <= s["start_ns"] < hi]


def _ms(s: Dict) -> float:
    return (s["end_ns"] - s["start_ns"]) * 1e-6


def mean_ms(rec: Dict, name: str) -> Optional[float]:
    spans = early(rec, name)
    return sum(map(_ms, spans)) / len(spans) if spans else None


def step_ms(rec: Dict) -> Optional[float]:
    """Mean ``cluster.step``: one iteration over both engines."""
    return mean_ms(rec, "cluster.step")


def select_ms(rec: Dict) -> Optional[float]:
    """Mean ``scheduler.select``: the LAD-TS decision inside
    ``EdgeCluster.submit`` (draws, the chain, the read-back of the
    pick)."""
    return mean_ms(rec, "scheduler.select")


def collect_wait_ms(rec: Dict) -> Optional[float]:
    """Mean ``engine.collect_wait``: the blocking copy of a step's tokens,
    the device time the host waits for."""
    return mean_ms(rec, "engine.collect_wait")


def chunk_fill(rec: Dict) -> Optional[float]:
    """Prompt tokens over the tokens the prefill chunks computed (%)."""
    chunks = [s["attrs"] for s in early(rec, "engine.prefill_chunk")]
    total = sum(a["tokens"] + a["padded"] for a in chunks)
    if not total:
        return None
    return 100.0 * sum(a["tokens"] for a in chunks) / total


def lanes_held(rec: Dict) -> Optional[float]:
    """Mean share of the lanes held after each admission (%)."""
    adm = [s["attrs"] for s in early(rec, "engine.admission")]
    if not adm:
        return None
    return 100.0 * sum(a["held"] / a["lanes"] for a in adm) / len(adm)


def idle_in_enqueue(rec: Dict) -> Optional[float]:
    """Share of the profiled sub-window with the device idle under an
    ``rt:engine.prefill_chunk`` or ``rt:engine.decode_round`` range
    (%)."""
    tr = rec.get("trace")
    if not tr or "idle_rt" not in tr or not tr.get("window_s"):
        return None
    idle = sum(tr["idle_rt"].get(n, 0.0) for n in ENQUEUE)
    return 100.0 * idle / tr["window_s"]


def idle_by_range(events: List[Dict], prefix: str = RT) -> Dict[str, float]:
    """Idle seconds of the profiled sub-window by the innermost host range
    named ``<prefix><name>`` open at each gap's middle, as
    ``trace.summarize`` names them by ``pb:`` phase; gaps under no such
    range go to "other host work"."""
    win = [e for e in events if e.get("name") == trace.WINDOW
           and e.get("ph") == "X"]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    busy, ranges = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if e.get("cat", "") in trace.DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                busy.append((a, b))
        elif e.get("cat") == "user_annotation" \
                and e["name"].startswith(prefix):
            ranges.append((a, b, e["name"][len(prefix):]))
    edges = [w0] + [x for ab in trace._merge(busy) for x in ab] + [w1]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        open_ = [r for r in ranges if r[0] <= mid < r[1]]
        name = max(open_, key=lambda r: r[0])[2] if open_ \
            else "other host work"
        idle[name] += (b - a) * 1e-6
    return dict(idle)


def child_cover(rec: Dict, name: str = "cluster.step") -> Optional[Dict]:
    """How much of the early ``name`` spans their direct children cover:
    ``{"spans", "total_ms", "children_ms", "cover"}``."""
    parents = early(rec, name)
    if not parents:
        return None
    ids = {s["id"] for s in parents}
    kids = [s for s in rec["spans"] if s["parent"] in ids]
    total = sum(map(_ms, parents))
    covered = sum(map(_ms, kids))
    return {"spans": len(parents), "total_ms": total,
            "children_ms": covered,
            "cover": covered / total if total else None}
