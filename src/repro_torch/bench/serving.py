"""Closed-loop serving bench of the port.

Port of ``bench_qos_mix`` and ``bench_closed_loop`` from
``benchmarks/serving.py``: train LAD-TS in the QoS-enabled simulator,
then replay one mixed-QoS Poisson trace through a heterogeneous live
fleet (``FLEET_ARCHS`` cycled over the edge servers: attention models on
the paged KV pool, xLSTM on a dense slot pool) under the paper policy and
each baseline, and evaluate the same schedulers in the simulator on the
same extended Eqn-6 observation.  The CSV rows and record keys are the
reference's; each live record also carries the run's kernel launches,
per-engine counters, generated tokens per second and, on the card, peak
device memory.

``full_scale=True`` builds the fleet at published widths, depth and
dtype (qwen2-1.5b 28 layers, starcoder2-3b 30, xlstm-350m 24, bf16);
``full_scale=False`` keeps the reference's reduced configs at depths
2/3 alternating.  Weights are random, drawn from seeds.
"""
from __future__ import annotations

import time
from typing import List

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.cluster import (EdgeCluster, PolicyScheduler,
                                 evaluate_scheduler, make_scheduler,
                                 poisson_trace, summarize)
from repro_torch.core.agents import AgentConfig
from repro_torch.core.diffusion import DiffusionPolicyConfig
from repro_torch.core.env import EnvParams
from repro_torch.core.trainer import train_method
from repro_torch.kernels import ops
from repro_torch.serving.builders import build_fleet, warmup
from repro_torch.workload import BEST_EFFORT, INTERACTIVE, STANDARD, scaled

# two arch families (attention -> paged KV pool, xLSTM -> dense slot pool)
# at different parameter scales, cycled over the edge servers
FLEET_ARCHS = ("qwen2-1.5b", "starcoder2-3b", "xlstm-350m")


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
    archs = [FLEET_ARCHS[i % len(FLEET_ARCHS)] for i in range(n_edge)]
    # engines are provisioned for requests up to max_len; batch-class
    # requests generate up to 3 * gen_tokens
    max_len = 3 * (prompt_len + gen_tokens)
    t0 = time.monotonic()
    engines = build_fleet(archs, max_len,
                          depths=(None if full_scale else
                                  [2 + (i % 2) for i in range(n_edge)]),
                          seed0=1, kv_slots=kv_slots,
                          prefill_chunk=prefill_chunk,
                          page_size=page_size,
                          max_lanes=4 * kv_slots, device=dev,
                          full_scale=full_scale)
    # one trace must tokenize for every engine in the mixed fleet
    vocab = min(e.cfg.vocab_size for e in engines)
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
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        launches0 = dict(ops.launches)
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
            # the port's additions: what the run launched and did
            "device": str(dev),
            "tok_s": sum(len(r.tokens) for r in done) / max(wall, 1e-9),
            "launches": {k: v - launches0[k]
                         for k, v in ops.launches.items()},
            "engines": [{"arch": e.arch_id, "layers": e.cfg.num_layers,
                         "paged": bool(e.paged),
                         "requests": sum(r.engine_id == i for r in done),
                         "prefills": e.prefills,
                         "decode_rounds": e.decode_rounds,
                         "token_ms": e.est_token_seconds * 1e3,
                         "kv_leak": e.kv_leak}
                        for i, e in enumerate(engines)],
            "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                             if dev.type == "cuda" else None)})
        if log:
            log(rows[-1])
    return rows, records
