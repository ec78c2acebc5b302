"""The profiled sub-window: device busy time, idle gaps named by what the
host was doing, and kernel time by name, read from ``torch.profiler``'s
Chrome trace (CUDA activity through CUPTI)."""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "pb:window"


class SubWindow:
    """Starts and stops the profiler around whole cluster steps; the
    trace is exported and read once the window has closed."""

    def __init__(self):
        self.prof = None
        self._range = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()

    def stop(self) -> None:
        """Stop recording (cheap): the trace is read after the window."""
        self._range.__exit__(None, None, None)
        self.prof.stop()

    def read(self) -> Dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return summarize(events)


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events: List[Dict]) -> Dict:
    """From Chrome-trace events (times in microseconds): ``window_s``,
    ``busy_s`` (the union of device operations inside the window),
    ``kernels`` (seconds by device-operation name), ``idle`` (idle
    seconds by the innermost ``pb:`` host phase open at each gap's
    middle), ``device_ops`` / ``idle_gaps`` (the ten largest of each)
    and, where the port's tracer opened ``rt:`` ranges, ``idle_rt``
    (``spans.idle_by_range``)."""
    from perfbench.spans import RT, idle_by_range   # they read this module
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X"]
    if not win:
        raise RuntimeError("the profile holds no sub-window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    spans, kernels = [], defaultdict(float)
    phases = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                spans.append((a, b))
                kernels[e["name"]] += (b - a) * 1e-6
        elif cat == "user_annotation" and e["name"].startswith("pb:") \
                and e["name"] != WINDOW:
            phases.append((a, b, e["name"][3:]))
    busy = _merge(spans)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    idle = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        open_ = [p for p in phases if p[0] <= mid < p[1]]
        name = max(open_, key=lambda p: p[0])[2] if open_ \
            else "other host work"
        idle[name] += (b - a) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    out = {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
           "kernels": dict(kernels), "idle": dict(idle),
           "device_ops": [[n[:160], s] for n, s in top],
           "idle_gaps": [[n, s] for n, s in gaps]}
    if any(e.get("cat") == "user_annotation"
           and e.get("name", "").startswith(RT) for e in events):
        out["idle_rt"] = idle_by_range(events)
    return out
