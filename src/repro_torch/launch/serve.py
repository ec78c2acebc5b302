"""Serving launcher of the port: an edge cluster of serving engines.

Port of ``repro/launch/serve.py``.  Replays a Poisson arrival trace
through N continuous-batching engines with a scheduler placing each
request, and prints the same per-request and summary lines:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --edges 2 --scheduler jsq --requests 8 --tokens 16 --rate 4

All-attention archs (``qwen2-1.5b``, ``starcoder2-3b``, ``starcoder2-7b``,
``minitron-8b``, the MoE ``dbrx-132b``, and ``mellum2-12b``, whose
sliding-window layers read their window of the pool beside its full
layers) serve from the paged KV pool;
the windowed MoE ``mixtral-8x22b``, ``recurrentgemma-9b``
(RG-LRU and local-attention layers), ``xlstm-350m``, the vision
``llava-next-mistral-7b`` (each request's patch embeddings in front of
its prompt) and the audio ``musicgen-large`` (4 codebook streams, int8
KV caches, sinusoidal positions) from dense slot pools, as the
reference's engines pick.  The vision tower and the audio codec are
stubs, as in the reference: each request's patches are drawn on the
device from a generator seeded from ``(--seed, rid)``.

``--scheduler lad-ts`` (or ``d2sac-ts``, ``sac-ts``, ``dqn-ts``) first
trains the policy in the simulator on the serving device (matching the
engine count, ``--train-episodes`` episodes), then serves with it — the
closed loop of paper Fig. 10.  Engines run on ``cuda`` unless ``--device
cpu`` is given.  Without ``--full-scale`` they serve the reference's
reduced configs; ``--full-scale`` keeps the published widths, depth and
dtype.

``--qos`` switches on the mixed-QoS workload: the trace mixes
interactive / standard / batch classes (``DEFAULT_MIX``), engines drain
in priority/EDF order, learned policies train on the QoS-extended
observation, ``--scheduler deadline`` becomes available, and the summary
adds the deadline-miss rate, priority-weighted goodput and a line per
class.

``--chaos`` switches on the fault layer (``repro_torch.faults``): a
schedule drawn from ``--fault-seed`` (one crash and one slowdown over the
trace's expected span plus 2 s) crashes and slows engines mid-trace,
orphaned requests are retried with backoff, learned policies train in
the fault-enabled simulator (availability observation and wrong-choice
penalty), ``--scheduler failure-aware`` masks DOWN engines, and the
summary adds the terminal-status breakdown (completion rate, retries,
failed, abandoned, orphans).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch import DeviceLike
from repro_torch.cluster.live import EdgeCluster
from repro_torch.cluster.request import poisson_trace, summarize
from repro_torch.cluster.schedulers import (BASELINES, PolicyScheduler,
                                            make_scheduler)
from repro_torch.configs import get_config, reduced
from repro_torch.core.agents import AgentConfig
from repro_torch.core.diffusion import DiffusionPolicyConfig
from repro_torch.core.env import EnvParams
from repro_torch.core.trainer import LEARNED, train_method
from repro_torch.faults import (FaultInjector, FaultParams, FaultSpec,
                                RetryPolicy)
from repro_torch.kernels import ops
from repro_torch.serving.builders import build_engines, warmup
from repro_torch.workload import DEFAULT_MIX


def build_scheduler(name: str, n_edge: int, train_episodes: int, seed: int,
                    device: DeviceLike = None, qos: bool = False,
                    chaos: bool = False):
    """A baseline by name, or a learned policy trained in the simulator on
    ``device`` first (``n_edge`` stations, 8 slots of up to 6 tasks, a
    3-step chain, ``DEFAULT_MIX`` with ``qos`` and the default
    ``FaultParams`` with ``chaos``), as the reference's launcher trains
    it."""
    if name == "deadline" and not qos:
        raise SystemExit("--scheduler deadline needs the QoS-extended "
                         "observation; pass --qos")
    if name == "failure-aware":
        return make_scheduler(name, n_edge, qos=qos)
    if name == "prefix-affinity":
        return make_scheduler(name, n_edge, qos=qos, fault=chaos)
    if name not in LEARNED:
        return make_scheduler(name, n_edge)
    p = EnvParams(num_bs=n_edge, num_slots=8, max_tasks=6,
                  qos_mix=DEFAULT_MIX if qos else (),
                  fault=FaultParams() if chaos else None)
    acfg = AgentConfig(train_after=40, replay_capacity=200,
                       diffusion=DiffusionPolicyConfig(num_steps=3))
    print(f"[serve] training {name} in-sim for {train_episodes} episodes "
          f"({n_edge} edge servers"
          f"{', fault-enabled' if chaos else ''})...")
    _, states = train_method(name, p, acfg, episodes=train_episodes,
                             seed=seed, device=device)
    return PolicyScheduler(name, acfg, states, num_engines=n_edge,
                           n_max=p.max_tasks)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--edges", type=int, default=2)
    ap.add_argument("--scheduler", default="jsq",
                    help=" | ".join(BASELINES + LEARNED))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--kv-slots", type=int, default=4)
    ap.add_argument("--train-episodes", type=int, default=3,
                    help="in-sim training episodes of a learned scheduler")
    ap.add_argument("--qos", action="store_true",
                    help="mixed interactive/standard/batch QoS trace + "
                         "extended scheduler observation")
    ap.add_argument("--chaos", action="store_true",
                    help="inject a deterministic fault schedule (one "
                         "crash + one slowdown) and retry orphans")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the --chaos fault schedule")
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="share a seeded system-prompt prefix of this many "
                         "tokens across --prefix-frac of the trace")
    ap.add_argument("--prefix-frac", type=float, default=0.75)
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable the paged engines' prefix cache")
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--full-scale", action="store_true",
                    help="published widths, depth and dtype instead of "
                         "the reduced smoke config")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    """Serve one trace; prints per-request lines and a summary line and
    returns ``summarize()``'s dict, plus ``engines`` (per-engine layers,
    memory model, prefill passes, decode rounds, measured ms per decode
    token and KV leak), ``fault_stats`` and ``fault_schedule`` (the
    cluster's fault counters and the injector's schedule; empty without
    ``--chaos``), ``placements`` (the scheduler's decisions: first tries
    and retries),
    ``launches`` (kernel launches of the serving run, the cluster's
    scheduler warm-up included), ``train_s`` (seconds spent building the
    scheduler: a learned one's in-sim training), ``wall_s`` and ``tok_s``
    (generated tokens per second of the run)."""
    args = _parser().parse_args(argv)
    t0 = time.perf_counter()
    scheduler = build_scheduler(args.scheduler, args.edges,
                                args.train_episodes, args.seed,
                                device=args.device, qos=args.qos,
                                chaos=args.chaos)
    train_s = time.perf_counter() - t0

    max_tokens = (max(args.tokens, *(c.z_range[1] for c, _ in DEFAULT_MIX))
                  if args.qos else args.tokens)
    # the engine config's patches sit in front of every prompt
    cfg = get_config(args.arch)
    n_patches = (cfg if args.full_scale else reduced(cfg)).vision_patches
    engines = build_engines(args.arch, args.edges,
                            args.prompt_len + max_tokens + n_patches,
                            kv_slots=args.kv_slots, sample=args.sample,
                            prefix_cache=(False if args.no_prefix_cache
                                          else None),
                            device=args.device, full_scale=args.full_scale)
    cfg0 = engines[0].cfg
    warmup(engines, args.prompt_len)
    launches0 = dict(ops.launches)

    injector = retry = None
    if args.chaos:
        # horizon = expected trace span + service tail headroom
        horizon = args.requests / max(args.rate, 1e-9) + 2.0
        injector = FaultInjector.from_spec(
            FaultSpec(crashes=1, slowdowns=1), args.edges,
            horizon_s=horizon, seed=args.fault_seed)
        retry = RetryPolicy()
        for ev in injector.describe():
            print(f"[serve] fault @{ev['t_s']:.2f}s engine={ev['engine']} "
                  f"{ev['kind']}")
    cluster = EdgeCluster(engines, scheduler, seed=args.seed,
                          qos_obs=args.qos, faults=injector, retry=retry)
    trace = poisson_trace(args.requests, rate=args.rate,
                          prompt_len=args.prompt_len,
                          max_new_tokens=args.tokens,
                          vocab_size=cfg0.vocab_size,
                          num_origins=args.edges, seed=args.seed,
                          num_codebooks=cfg0.num_codebooks,
                          qos_mix=DEFAULT_MIX if args.qos else None,
                          prefix_len=args.prefix_len,
                          prefix_frac=args.prefix_frac)
    if cfg0.vision_patches:
        dev = engines[0].device
        for r in trace:
            gen = torch.Generator(device=dev).manual_seed(
                args.seed * 1_000_003 + r.rid)
            r.patches = torch.randn(
                (1, cfg0.vision_patches, cfg0.vision_dim), generator=gen,
                device=dev)
    t0 = time.perf_counter()
    done = cluster.run(trace)
    wall = time.perf_counter() - t0
    for r in sorted(done, key=lambda r: r.rid):
        if not r.done:          # failed / abandoned: no timestamps
            print(f"[serve] req {r.rid}: {r.status} ({r.fail_reason})")
            continue
        tps = (f"tok/s={len(r.tokens)/r.decode_s:.1f}"
               if r.decode_s > 0 else "tok/s=n/a")
        retried = f" attempts={r.attempts}" if r.attempts > 1 else ""
        print(f"[serve] req {r.rid}: engine={r.engine_id} "
              f"queue={r.queue_s*1e3:.1f}ms "
              f"prefill={r.prefill_s*1e3:.1f}ms "
              f"decode={r.decode_s*1e3:.1f}ms "
              f"service={r.service_s*1e3:.1f}ms {tps}{retried}")
    st = summarize(done)
    line = (f"[serve] {scheduler.name}: n={st['count']} "
            f"mean={st['mean_s']*1e3:.1f}ms p95={st['p95_s']*1e3:.1f}ms "
            f"max={st['max_s']*1e3:.1f}ms")
    if st["prefill_tokens_saved"]:
        line += (f" prefix_saved={st['prefill_tokens_saved']}tok"
                 f" hit={st['prefix_hit_rate']:.2f}")
    if args.chaos:
        fs = cluster.fault_stats
        line += (f" cr={st['completion_rate']:.3f}"
                 f" retries={st['retries']}"
                 f" failed={st['failed']} abandoned={st['abandoned']}"
                 f" orphans={fs['orphaned']}")
    if args.qos:
        line += (f" miss={st['deadline_miss_rate']:.2f}"
                 f" goodput={st['weighted_goodput']:.2f}")
        for name, cs in st.get("classes", {}).items():
            print(f"[serve]   class {name}: n={cs['count']} "
                  f"p50={cs['p50_s']*1e3:.1f}ms "
                  f"p95={cs['p95_s']*1e3:.1f}ms "
                  f"miss={cs['deadline_miss_rate']:.2f}")
    print(line)
    st["engines"] = [{"layers": e.cfg.num_layers, "paged": e.paged,
                      "prefills": e.prefills,
                      "decode_rounds": e.decode_rounds,
                      "token_ms": e.est_token_seconds * 1e3,
                      "kv_leak": e.kv_leak} for e in engines]
    st["fault_stats"] = dict(cluster.fault_stats)
    st["fault_schedule"] = injector.describe() if injector else []
    st["placements"] = sum(r.attempts for r in done)
    st["launches"] = {k: v - launches0[k] for k, v in ops.launches.items()}
    st["train_s"] = train_s
    st["wall_s"] = wall
    st["tok_s"] = sum(len(r.tokens) for r in done) / wall if wall else 0.0
    return st


if __name__ == "__main__":
    main()
