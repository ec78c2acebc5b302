"""Saturation stress bench of the port: ramp the Poisson arrival rate until
goodput collapses, per scheduler.

Port of ``benchmarks/stress.py``.  For each scheduler the same geometric
ladder of offered rates is replayed stage by stage (the same per-stage
traces across schedulers), each stage on a freshly reset fleet.  A stage
offers load for a fixed window (``window_s``), so its number of arrivals
scales with its rate: past the fleet's capacity the backlog, and with it
queueing delay and deadline misses, grows with offered load.  The stress
QoS mix carries deadlines tightened to the bench's time scale.  Per
stage: ``offered_rate``, ``throughput_rps`` (completed / wall),
``goodput_rps`` (on-time completions / wall), the delay percentiles,
``deadline_miss_rate``, ``abandoned`` and ``weighted_goodput``.  The
saturation stage is where goodput peaks (``saturation_rate``).  An
overlap A/B rides along: the penultimate rung replayed with
``overlap=False`` and ``overlap=True`` stepping (best of two each),
recording the wall-time speedup of dispatching every engine before
collecting any.

Each stage's record also carries the port's ``STAGE_KEYS``: the stage's
kernel launches, per-engine counters and the cluster's quarantine count;
the A/B record carries its four runs' stage records (``AB_KEYS``).
``device=`` and ``full_scale=`` are as in ``bench_closed_loop``.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch import DeviceLike, resolve_device
from repro_torch.bench.serving import (bench_fleet, bench_qos_mix,
                                       run_extras, start_run)
from repro_torch.cluster import (EdgeCluster, make_scheduler, poisson_trace,
                                 summarize)
from repro_torch.faults import RetryPolicy
from repro_torch.serving.builders import warmup
from repro_torch.workload import scaled

# the keys a stage record carries beside the reference's
STAGE_KEYS = ("launches", "engines", "quarantined")
AB_KEYS = ("runs",)
# the stress mix's deadlines (interactive, standard), tightened to the
# bench's time scale
STRESS_DEADLINES = (0.4, 1.2)


def _on_time(r) -> bool:
    return r.status == "ok" and not bool(r.missed)


def stress_qos_mix(gen_tokens: int, prompt_len: int):
    """The serving QoS mix with ``STRESS_DEADLINES`` (interactive,
    standard); batch stays deadline-free."""
    tight = dict(zip(("interactive", "standard"), STRESS_DEADLINES))
    return tuple(
        (scaled(cls, deadline_s=tight[cls.name]) if cls.name in tight
         else cls, w)
        for cls, w in bench_qos_mix(gen_tokens, prompt_len=prompt_len))


def run_stage(engines, scheduler_name: str, *, rate: float,
              num_requests: int, prompt_len: int, gen_tokens: int,
              vocab: int, mix, seed: int, overlap: bool = True) -> dict:
    """One (scheduler, offered-rate) stage on a freshly reset fleet."""
    E = len(engines)
    for e in engines:
        e.reset()
    sched = (make_scheduler(scheduler_name, E, qos=True)
             if scheduler_name in ("failure-aware", "prefix-affinity")
             else make_scheduler(scheduler_name, E))
    cluster = EdgeCluster(engines, sched, seed=seed, qos_obs=True,
                          overlap=overlap, retry=RetryPolicy())
    trace = poisson_trace(num_requests, rate=rate, prompt_len=prompt_len,
                          max_new_tokens=gen_tokens, vocab_size=vocab,
                          num_origins=E, seed=seed, qos_mix=mix)
    dev = engines[0].device
    launches0 = start_run(dev)
    t0 = time.monotonic()
    done = cluster.run(trace)
    wall = time.monotonic() - t0
    stats = summarize(done)
    on_time = sum(_on_time(r) for r in done)
    extras = run_extras(dev, engines, done, wall, launches0)
    return {
        "offered_rate": float(rate),
        "wall_s": wall,
        "overlap": overlap,
        "throughput_rps": stats["completed"] / max(wall, 1e-9),
        "goodput_rps": on_time / max(wall, 1e-9),
        "on_time": int(on_time),
        **{k: stats[k] for k in ("count", "completed", "abandoned",
                                 "failed", "p50_s", "p95_s", "p99_s",
                                 "mean_s", "deadline_miss_rate",
                                 "weighted_goodput",
                                 "prefill_tokens_saved",
                                 "prefix_hit_rate")},
        "launches": extras["launches"], "engines": extras["engines"],
        "quarantined": cluster.fault_stats["quarantined"],
    }


def detect_saturation(goodputs: Sequence[float]) -> int:
    """Stage index where goodput peaks: the saturation knee."""
    return int(np.argmax(np.asarray(goodputs, np.float64)))


def bench_stress(n_edge: int = 4, rates: Optional[Sequence[float]] = None,
                 window_s: float = 0.35, prompt_len: int = 16,
                 gen_tokens: int = 6, seed: int = 0, kv_slots: int = 2,
                 prefill_chunk: int = 8,
                 schedulers: Optional[Sequence[str]] = None,
                 device: DeviceLike = None, full_scale: bool = False,
                 log=None):
    """Ramp-to-saturation stress run on ``device``; returns (csv_rows,
    json_records).

    Each stage offers ``rate`` arrivals/s for ``window_s`` seconds, so
    its size is ``rate * window_s`` clamped to [3, 192].  The overlap A/B
    replays the penultimate rung.  The defaults are the reference's quick
    ladder (8 to 2048 req/s, JSQ and round-robin)."""
    dev = resolve_device(device)
    if rates is None:
        rates = (8.0, 32.0, 128.0, 512.0, 2048.0)
    if schedulers is None:
        schedulers = ("jsq", "round-robin")

    def stage_size(rate: float) -> int:
        return int(max(3, min(round(rate * window_s), 192)))

    mix = stress_qos_mix(gen_tokens, prompt_len)
    max_len = 3 * (prompt_len + gen_tokens)
    t0 = time.monotonic()
    engines, vocab = bench_fleet(n_edge, max_len, kv_slots, prefill_chunk,
                                 dev, full_scale)
    # warm every prompt length the QoS mix can emit: a dense engine's
    # first prefill at a new length would bill its set-up to whichever
    # stage first drew that class
    for plen in sorted({cls.prompt_len or prompt_len for cls, _ in mix}):
        warmup(engines, plen)
    if log:
        fleet = [(e.arch_id, e.cfg.num_layers, e.cfg.dtype) for e in engines]
        log(f"fleet {fleet} built and warmed in "
            f"{time.monotonic() - t0:.2f} s")

    rows: List[str] = []
    records: List[dict] = []
    for name in schedulers:
        stages = []
        for k, rate in enumerate(rates):
            n_k = stage_size(rate)
            st = run_stage(engines, name, rate=rate, num_requests=n_k,
                           prompt_len=prompt_len, gen_tokens=gen_tokens,
                           vocab=vocab, mix=mix, seed=seed + 101 * k)
            st["stage"] = k
            st["num_requests"] = n_k
            stages.append(st)
            rows.append(
                f"stress/{name}@{rate:g}rps,"
                f"{st['wall_s']/max(n_k,1)*1e6:.0f},"
                f"tput={st['throughput_rps']:.2f}rps;"
                f"goodput={st['goodput_rps']:.2f}rps;"
                f"p50={st['p50_s']:.3f}s;p95={st['p95_s']:.3f}s;"
                f"p99={st['p99_s']:.3f}s;"
                f"miss={st['deadline_miss_rate']:.2f};"
                f"shed={st['abandoned']}")
            records.append({"bench": "stress_stage", "scheduler": name,
                            "fleet": [e.arch_id for e in engines], **st})
            if log:
                log(rows[-1])
        sat = detect_saturation([s["goodput_rps"] for s in stages])
        records.append({
            "bench": "stress_summary", "scheduler": name,
            "window_s": window_s,
            "saturation_stage": sat,
            "saturation_rate": stages[sat]["offered_rate"],
            "peak_goodput_rps": stages[sat]["goodput_rps"],
            "stages": stages,
        })
        rows.append(f"stress_summary/{name},0,"
                    f"saturation_rate={stages[sat]['offered_rate']:g}rps;"
                    f"peak_goodput={stages[sat]['goodput_rps']:.2f}rps")

    # --- overlap A/B: one overload stage, overlapped against serial -----
    # (the penultimate rung: saturated enough that stepping dominates;
    # best of two filters host noise)
    ab_rate = rates[-2] if len(rates) > 1 else rates[-1]
    ab, runs = {}, []
    for overlap in (False, True):
        best = None
        for _ in range(2):
            st = run_stage(engines, schedulers[0], rate=ab_rate,
                           num_requests=stage_size(ab_rate),
                           prompt_len=prompt_len, gen_tokens=gen_tokens,
                           vocab=vocab, mix=mix, seed=seed + 9001,
                           overlap=overlap)
            runs.append(st)
            if best is None or st["wall_s"] < best["wall_s"]:
                best = st
        ab["overlap" if overlap else "serial"] = best
    speedup = (ab["serial"]["wall_s"] / max(ab["overlap"]["wall_s"], 1e-9))
    records.append({
        "bench": "stress_ab", "scheduler": schedulers[0],
        "engines": n_edge, "offered_rate": float(ab_rate),
        "serial_wall_s": ab["serial"]["wall_s"],
        "overlap_wall_s": ab["overlap"]["wall_s"],
        "overlap_speedup": speedup,
        "serial_p95_s": ab["serial"]["p95_s"],
        "overlap_p95_s": ab["overlap"]["p95_s"],
        "runs": runs,
    })
    rows.append(f"stress_ab/{schedulers[0]}@{ab_rate:g}rps,0,"
                f"serial={ab['serial']['wall_s']:.2f}s;"
                f"overlap={ab['overlap']['wall_s']:.2f}s;"
                f"speedup={speedup:.2f}x")
    if log:
        log(rows[-1])
    return rows, records
