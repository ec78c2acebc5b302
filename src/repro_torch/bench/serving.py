"""Serving benches of the port on the cluster API.

Port of ``bench_tablev``, ``bench_qos_mix``, ``bench_closed_loop`` and
``bench_chaos`` from ``benchmarks/serving.py``:

``bench_tablev``       the paper's Table V: one deep centralized engine
                       against ``n_edge`` shallow edge engines under JSQ
                       placement, makespan per request count;
``bench_closed_loop``  train LAD-TS in the QoS-enabled simulator, then
                       replay one mixed-QoS Poisson trace through a
                       heterogeneous live fleet (``FLEET_ARCHS`` cycled
                       over the edge servers: attention models on the
                       paged KV pool, xLSTM on a dense slot pool) under
                       the paper policy and each baseline, and evaluate
                       the same schedulers in the simulator on the same
                       extended Eqn-6 observation;
``bench_chaos``        the same kind of trace per scheduler while one
                       engine crashes mid-trace and recovers: completion
                       rate, retries, orphan-recovery latency, goodput
                       and the KV-accounting invariant, plus the
                       fault-enabled simulator's wrong-choice rate.

The CSV rows and record keys are the reference's; each live record also
carries the port's ``PORT_KEYS``: the run's kernel launches, per-engine
counters, generated tokens per second and, on the card, peak device
memory.

``full_scale=True`` builds the fleet at published widths, depth and
dtype (qwen2-1.5b 28 layers, starcoder2-3b 30, xlstm-350m 24, bf16);
``full_scale=False`` keeps the reference's reduced configs at depths
2/3 alternating.  Weights are random, drawn from seeds.
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.cluster import (EdgeCluster, PolicyScheduler,
                                 evaluate_scheduler, make_scheduler,
                                 poisson_trace, summarize)
from repro_torch.core.agents import AgentConfig
from repro_torch.core.diffusion import DiffusionPolicyConfig
from repro_torch.core.env import EnvParams
from repro_torch.core.trainer import train_method
from repro_torch.faults import FaultParams, RetryPolicy, single_crash
from repro_torch.kernels import ops
from repro_torch.serving.builders import build_engines, build_fleet, warmup
from repro_torch.workload import BEST_EFFORT, INTERACTIVE, STANDARD, scaled

# two arch families (attention -> paged KV pool, xLSTM -> dense slot pool)
# at different parameter scales, cycled over the edge servers
FLEET_ARCHS = ("qwen2-1.5b", "starcoder2-3b", "xlstm-350m")
# the keys a live record carries beside the reference's
PORT_KEYS = ("device", "tok_s", "launches", "engines", "peak_mem_gib")


def bench_fleet(n_edge: int, max_len: int, kv_slots: int,
                prefill_chunk: int, dev, full_scale: bool, **kw):
    """``FLEET_ARCHS`` cycled over ``n_edge`` engines (reduced configs at
    depths 2/3 alternating, or published ones), warmed up by the caller;
    returns the engines and the one vocabulary every engine tokenizes."""
    archs = [FLEET_ARCHS[i % len(FLEET_ARCHS)] for i in range(n_edge)]
    engines = build_fleet(archs, max_len,
                          depths=(None if full_scale else
                                  [2 + (i % 2) for i in range(n_edge)]),
                          seed0=1, kv_slots=kv_slots,
                          prefill_chunk=prefill_chunk,
                          max_lanes=4 * kv_slots, device=dev,
                          full_scale=full_scale, **kw)
    return engines, min(e.cfg.vocab_size for e in engines)


def start_run(dev) -> dict:
    """Launch counts before a live run (and the card's peak reset)."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    return dict(ops.launches)


def run_extras(dev, engines, done, wall: float, launches0: dict) -> dict:
    """The port's ``PORT_KEYS`` of one live run: what it launched and
    what each engine did."""
    return {
        "device": str(dev),
        "tok_s": sum(len(r.tokens) for r in done) / max(wall, 1e-9),
        "launches": {k: v - launches0[k] for k, v in ops.launches.items()},
        "engines": [{"arch": e.arch_id, "layers": e.cfg.num_layers,
                     "paged": bool(e.paged),
                     "requests": sum(r.engine_id == i for r in done),
                     "prefills": e.prefills,
                     "decode_rounds": e.decode_rounds,
                     "token_ms": e.est_token_seconds * 1e3,
                     "kv_leak": e.kv_leak}
                    for i, e in enumerate(engines)],
        "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                         if dev.type == "cuda" else None)}


def bench_tablev(num_requests=(1, 8, 32), prompt_len: int = 16,
                 gen_tokens: int = 8, n_edge: int = 4,
                 device: DeviceLike = None, full_scale: bool = False):
    """Centralized (one deep engine) vs edge cluster (``n_edge`` shallow
    engines + JSQ placement), makespan per request count, on ``device``
    (``cuda`` unless the caller asks for the CPU).  The reference's
    depths: 4 layers for the cloud, 2 / 3 alternating for the edges, of
    qwen2-1.5b reduced or, with ``full_scale``, at published width and
    dtype.  Returns (csv_rows, json_records); each record carries the
    reference's summary of the run and the port's ``PORT_KEYS``."""
    dev = resolve_device(device)
    max_len = prompt_len + gen_tokens
    cloud = build_engines("qwen2-1.5b", 1, max_len, depths=[4], device=dev,
                          full_scale=full_scale)[0]
    edges = build_engines("qwen2-1.5b", n_edge, max_len,
                          depths=[2 + (i % 2) for i in range(n_edge)],
                          seed0=1, device=dev, full_scale=full_scale)
    vocab = cloud.cfg.vocab_size
    warmup([cloud] + edges, prompt_len)

    rows: List[str] = []
    records: List[dict] = []
    for N in num_requests:
        def trace():
            return poisson_trace(N, rate=1e6, prompt_len=prompt_len,
                                 max_new_tokens=gen_tokens,
                                 min_new_tokens=gen_tokens,
                                 vocab_size=vocab, num_origins=n_edge,
                                 seed=N)

        walls = {}
        for mode, engines, sched in (
                ("centralized", [cloud], make_scheduler("round-robin", 1)),
                ("dedgeai", edges, make_scheduler("jsq", n_edge))):
            for e in engines:
                e.reset()
            launches0 = start_run(dev)
            t0 = time.monotonic()
            done = EdgeCluster(engines, sched).run(trace())
            walls[mode] = time.monotonic() - t0
            stats = summarize(done)
            records.append({"bench": "tablev", "mode": mode, "requests": N,
                            "wall_s": walls[mode], **stats,
                            **run_extras(dev, engines, done, walls[mode],
                                         launches0)})
        c, e = records[-2], records[-1]
        speedup = walls["centralized"] / max(walls["dedgeai"], 1e-9)
        rows.append(
            f"tableV_N={N}/centralized,"
            f"{walls['centralized'] / max(N, 1) * 1e6:.0f},"
            f"mean={c['mean_s']:.3f}s;p95={c['p95_s']:.3f}s")
        rows.append(
            f"tableV_N={N}/dedgeai,{walls['dedgeai'] / max(N, 1) * 1e6:.0f},"
            f"mean={e['mean_s']:.3f}s;p95={e['p95_s']:.3f}s;"
            f"speedup={speedup:.2f}x")
    return rows, records


def bench_qos_mix(gen_tokens: int, prompt_len: int = 0):
    """QoS mix rescaled to the benchmark's token scale: interactive
    requests are short (half-length prompts) and prefer the smallest
    model, batch requests carry double-length prompts and run up to 3x
    the nominal generation length with no deadline.  ``prompt_len=0``
    keeps the trace-level prompt length for every class."""
    plens = {c: None for c in ("interactive", "standard", "batch")}
    if prompt_len:
        plens = {"interactive": max(prompt_len // 2, 1),
                 "standard": None,          # trace-level default
                 "batch": 2 * prompt_len}
    return ((scaled(INTERACTIVE, z_range=(1, gen_tokens),
                    prompt_len=plens["interactive"],
                    model_pref="xlstm-350m"), 0.4),
            (scaled(STANDARD,
                    z_range=(max(gen_tokens // 2, 1), 2 * gen_tokens)), 0.4),
            (scaled(BEST_EFFORT, prompt_len=plens["batch"],
                    z_range=(gen_tokens, 3 * gen_tokens)), 0.2))


def bench_closed_loop(n_edge: int = 4, num_requests: int = 24,
                      rate: float = 96.0, prompt_len: int = 32,
                      gen_tokens: int = 8, seed: int = 0, kv_slots: int = 2,
                      prefill_chunk: int = 16, page_size: int = 8,
                      prefix_len: int = -1, prefix_frac: float = 0.75,
                      device: DeviceLike = None, full_scale: bool = False,
                      log=None):
    """Closed loop on ``device`` (``cuda`` unless the caller asks for the
    CPU): LAD-TS trained in the QoS simulator, then the sim half (every
    scheduler but prefix-affinity, which needs a KV model the slot-based
    sim lacks) and the live half (all seven, each from cold engines and
    prefix caches).  ``prefix_len=-1`` shares 3/4 of the prompt across
    ``prefix_frac`` of the trace.  ``log``, when given, gets one line per
    phase.  Returns (csv_rows, json_records)."""
    dev = resolve_device(device)
    if prefix_len < 0:
        prefix_len = (3 * prompt_len) // 4
    # per-class prompt lengths: interactive half-length, batch double;
    # max_len = 3 * (prompt + gen) below covers 2 * prompt + 3 * gen
    mix = bench_qos_mix(gen_tokens, prompt_len=prompt_len)
    # the reference's quick sim
    p = EnvParams(num_bs=n_edge, num_slots=8, max_tasks=6, qos_mix=mix)
    acfg = AgentConfig(train_after=40, replay_capacity=200,
                       diffusion=DiffusionPolicyConfig(num_steps=3))
    episodes = 3
    t0 = time.monotonic()
    _, states = train_method("lad-ts", p, acfg, episodes=episodes,
                             seed=seed, device=dev)
    if log:
        log(f"trained lad-ts in the QoS sim: {episodes} episodes, "
            f"{time.monotonic() - t0:.2f} s")

    def scheds():
        return {
            "lad-ts": PolicyScheduler("lad-ts", acfg, states,
                                      num_engines=n_edge,
                                      n_max=p.max_tasks),
            "deadline": make_scheduler("deadline", n_edge),
            "prefix-affinity": make_scheduler("prefix-affinity", n_edge,
                                              qos=True),
            "jsq": make_scheduler("jsq", n_edge),
            "round-robin": make_scheduler("round-robin", n_edge),
            "random": make_scheduler("random", n_edge),
            "local": make_scheduler("local", n_edge),
        }

    def qos_suffix(stats):
        return (f";miss={stats.get('deadline_miss_rate', 0.0):.2f}"
                f";goodput={stats.get('weighted_goodput', 0.0):.2f}")

    rows: List[str] = []
    records: List[dict] = []
    # --- the Scheduler interface against the core.env simulator ----------
    for name, s in scheds().items():
        if getattr(s, "prefix_obs", False):
            continue   # the slot-based sim has no KV model to be warm in
        t0 = time.monotonic()
        r = evaluate_scheduler(s, p, episodes=2, seed=1, device=dev)
        r.pop("carry", None)   # agent state, not JSON material
        wall = time.monotonic() - t0
        us = wall / max(r["count"], 1) * 1e6
        rows.append(f"closedloop_sim/{name},{us:.0f},"
                    f"mean={r['mean_s']:.3f}s;p95={r['p95_s']:.3f}s"
                    + qos_suffix(r))
        records.append({"bench": "closedloop_sim", "scheduler": name,
                        "wall_s": wall, **r})
        if log:
            log(rows[-1])

    # --- and against the live heterogeneous fleet --------------------------
    # engines are provisioned for requests up to max_len; batch-class
    # requests generate up to 3 * gen_tokens
    max_len = 3 * (prompt_len + gen_tokens)
    t0 = time.monotonic()
    # one trace must tokenize for every engine in the mixed fleet
    engines, vocab = bench_fleet(n_edge, max_len, kv_slots, prefill_chunk,
                                 dev, full_scale, page_size=page_size)
    warmup(engines, prompt_len)
    if log:
        fleet = [(e.arch_id, e.cfg.num_layers, e.cfg.dtype) for e in engines]
        log(f"fleet {fleet} built and warmed in "
            f"{time.monotonic() - t0:.2f} s")
    for name, s in scheds().items():
        for e in engines:
            e.reset()             # also clears each prefix cache: every
        # scheduler starts cold, so hit rates compare placement quality
        cluster = EdgeCluster(engines, s, seed=seed, qos_obs=True)
        trace = poisson_trace(num_requests, rate=rate,
                              prompt_len=prompt_len,
                              max_new_tokens=gen_tokens,
                              vocab_size=vocab,
                              num_origins=n_edge, seed=seed + 1,
                              qos_mix=mix, prefix_len=prefix_len,
                              prefix_frac=prefix_frac)
        launches0 = start_run(dev)
        t0 = time.monotonic()
        done = cluster.run(trace)
        wall = time.monotonic() - t0
        stats = summarize(done)
        us = wall / max(stats["count"], 1) * 1e6
        peak = max(e.peak_inflight for e in engines)
        rows.append(f"closedloop_live/{name},{us:.0f},"
                    f"mean={stats['mean_s']:.3f}s;"
                    f"p50={stats['p50_s']:.3f}s;"
                    f"p95={stats['p95_s']:.3f}s;"
                    f"p99={stats['p99_s']:.3f}s;"
                    f"peak_inflight={peak}" + qos_suffix(stats)
                    + f";saved={stats['prefill_tokens_saved']}"
                    f";hit={stats['prefix_hit_rate']:.2f}")
        records.append({
            "bench": "closedloop_live", "scheduler": name,
            "wall_s": wall,
            "throughput_rps": stats["count"] / max(wall, 1e-9),
            "fleet": [e.arch_id for e in engines],
            "paged": [bool(e.paged) for e in engines],
            "kv_slots": kv_slots,
            "prefill_chunk": prefill_chunk,
            "prompt_len": prompt_len,
            "page_size": page_size,
            "prefix_len": prefix_len,
            "prefix_frac": prefix_frac,
            "peak_inflight": peak,
            "engine_prefill_tokens_saved": [int(e.prefill_tokens_saved)
                                            for e in engines],
            "engine_prefix_hit_rate": [float(e.prefix_hit_rate)
                                       for e in engines],
            "cow_forks": int(sum(e.cow_forks for e in engines)),
            "prefix_evictions": int(sum(e.prefix_evictions
                                        for e in engines)),
            **stats,
            **run_extras(dev, engines, done, wall, launches0)})
        if log:
            log(rows[-1])
    return rows, records


def bench_chaos(n_edge: int = 2, num_requests: int = 16, rate: float = 48.0,
                prompt_len: int = 16, gen_tokens: int = 6, seed: int = 0,
                kv_slots: int = 2, prefill_chunk: int = 8,
                fault_seed: int = 0, device: DeviceLike = None,
                full_scale: bool = False, log=None):
    """Chaos run on ``device``: one hard mid-trace crash and recovery, per
    scheduler.

    A calibration pass (JSQ, fault-free) measures the trace's makespan;
    the chaos passes then crash one engine (drawn from ``fault_seed``) at
    0.3x that makespan and recover it 0.35x later, so every scheduler
    faces the same schedule.  Acceptance, as in the reference: every
    non-abandoned request completes (completion_rate == 1.0), retries
    stay within the policy's cap, and each engine's KV accounting returns
    to zero.  Returns (csv_rows, json_records)."""
    dev = resolve_device(device)
    mix = bench_qos_mix(gen_tokens, prompt_len=prompt_len)
    E = n_edge
    max_len = 3 * (prompt_len + gen_tokens)
    t0 = time.monotonic()
    engines, vocab = bench_fleet(E, max_len, kv_slots, prefill_chunk, dev,
                                 full_scale)
    warmup(engines, prompt_len)
    if log:
        fleet = [(e.arch_id, e.cfg.num_layers, e.cfg.dtype) for e in engines]
        log(f"fleet {fleet} built and warmed in "
            f"{time.monotonic() - t0:.2f} s")

    def trace():
        return poisson_trace(num_requests, rate=rate,
                             prompt_len=prompt_len,
                             max_new_tokens=gen_tokens, vocab_size=vocab,
                             num_origins=E, seed=seed + 1, qos_mix=mix)

    # --- calibration: the fault-free makespan anchors the schedule -------
    for e in engines:
        e.reset()
    t0 = time.monotonic()
    EdgeCluster(engines, make_scheduler("jsq", E), seed=seed).run(trace())
    makespan = time.monotonic() - t0
    crash_t = 0.3 * makespan
    downtime = 0.35 * makespan
    victim = int(np.random.default_rng(fault_seed).integers(E))
    if log:
        log(f"calibration makespan {makespan:.3f} s: engine {victim} "
            f"crashes at {crash_t:.3f} s for {downtime:.3f} s")

    rows: List[str] = []
    records: List[dict] = []
    scheds = {
        "failure-aware": make_scheduler("failure-aware", E, qos=True),
        "deadline": make_scheduler("deadline", E),
        "jsq": make_scheduler("jsq", E),
        "round-robin": make_scheduler("round-robin", E),
    }
    for name, s in scheds.items():
        for e in engines:
            e.reset()
        inj = single_crash(engine=victim, t_s=crash_t,
                           downtime_s=downtime, num_engines=E)
        cluster = EdgeCluster(engines, s, seed=seed, faults=inj,
                              retry=RetryPolicy())
        launches0 = start_run(dev)
        t0 = time.monotonic()
        done = cluster.run(trace())
        wall = time.monotonic() - t0
        stats = summarize(done)
        fs = cluster.fault_stats
        rec_s = fs["orphan_recovery_s"]
        leak = [int(e.kv_leak) for e in engines]
        rows.append(
            f"chaos_live/{name},{wall/max(num_requests,1)*1e6:.0f},"
            f"cr={stats['completion_rate']:.3f};"
            f"completed={stats['completed']};failed={stats['failed']};"
            f"abandoned={stats['abandoned']};retries={stats['retries']};"
            f"orphans={fs['orphaned']};"
            f"goodput={stats.get('weighted_goodput', 0.0):.2f};"
            f"kv_leak={sum(leak)}")
        records.append({
            "bench": "chaos_live", "scheduler": name, "wall_s": wall,
            "makespan_calib_s": makespan,
            "goodput_rps": stats["completed"] / max(wall, 1e-9),
            "fault_schedule": inj.describe(), "fault_seed": fault_seed,
            "orphan_recovery_mean_s": (float(np.mean(rec_s))
                                       if rec_s else 0.0),
            "kv_leak": leak,
            **{k: v for k, v in fs.items() if k != "orphan_recovery_s"},
            **stats,
            **run_extras(dev, engines, done, wall, launches0)})
        if log:
            log(rows[-1])

    # --- the fault-enabled simulator twin: wrong-choice rate -------------
    p = EnvParams(num_bs=E, num_slots=8, max_tasks=5,
                  fault=FaultParams(p_down=0.15, p_up=0.5))
    for name in ("failure-aware", "jsq", "round-robin"):
        s = make_scheduler(name, E)
        t0 = time.monotonic()
        r = evaluate_scheduler(s, p, episodes=2, seed=seed, device=dev)
        r.pop("carry", None)
        wall = time.monotonic() - t0
        rows.append(f"chaos_sim/{name},{wall/max(r['count'],1)*1e6:.0f},"
                    f"mean={r['mean_s']:.3f}s;"
                    f"wrong={r['wrong_choice_rate']:.3f}")
        records.append({"bench": "chaos_sim", "scheduler": name,
                        "wall_s": wall, "p_down": p.fault.p_down,
                        "p_up": p.fault.p_up, **r})
        if log:
            log(rows[-1])
    return rows, records
