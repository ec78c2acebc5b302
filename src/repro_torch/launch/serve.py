"""Serving launcher of the port: an edge cluster of paged engines.

Port of ``repro/launch/serve.py``.  Replays a Poisson arrival trace
through N continuous-batching engines with a baseline scheduler placing
each request, and prints the same per-request and summary lines:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --edges 2 --scheduler jsq --requests 8 --tokens 16 --rate 4

Engines run on ``cuda`` unless ``--device cpu`` is given.  Without
``--full-scale`` they serve the reference's reduced configs;
``--full-scale`` keeps the published widths, depth and dtype.  ``--qos``,
``--chaos`` and the learned schedulers are not ported yet.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

from repro_torch.cluster.live import EdgeCluster
from repro_torch.cluster.request import poisson_trace, summarize
from repro_torch.cluster.schedulers import make_scheduler
from repro_torch.kernels import ops
from repro_torch.serving.builders import build_engines, warmup


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--edges", type=int, default=2)
    ap.add_argument("--scheduler", default="jsq",
                    help="jsq | round-robin | random | local")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--kv-slots", type=int, default=4)
    ap.add_argument("--qos", action="store_true", help="not yet ported")
    ap.add_argument("--chaos", action="store_true", help="not yet ported")
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
    decode rounds, measured ms per decode token and KV leak),
    ``launches`` (kernel launches after warm-up), ``wall_s`` and
    ``tok_s`` (generated tokens per second of the run)."""
    args = _parser().parse_args(argv)
    if args.qos or args.chaos:
        raise SystemExit("--qos and --chaos are not yet ported to "
                         "repro_torch (ROADMAP.md A4)")
    try:
        scheduler = make_scheduler(args.scheduler, args.edges)
    except NotImplementedError as exc:
        raise SystemExit(f"--scheduler {args.scheduler}: not yet ported "
                         f"({exc})") from exc

    engines = build_engines(args.arch, args.edges,
                            args.prompt_len + args.tokens,
                            kv_slots=args.kv_slots, sample=args.sample,
                            prefix_cache=(False if args.no_prefix_cache
                                          else None),
                            device=args.device, full_scale=args.full_scale)
    vocab = engines[0].cfg.vocab_size
    warmup(engines, args.prompt_len)
    launches0 = dict(ops.launches)

    cluster = EdgeCluster(engines, scheduler, seed=args.seed)
    trace = poisson_trace(args.requests, rate=args.rate,
                          prompt_len=args.prompt_len,
                          max_new_tokens=args.tokens, vocab_size=vocab,
                          num_origins=args.edges, seed=args.seed,
                          prefix_len=args.prefix_len,
                          prefix_frac=args.prefix_frac)
    t0 = time.perf_counter()
    done = cluster.run(trace)
    wall = time.perf_counter() - t0
    for r in sorted(done, key=lambda r: r.rid):
        tps = (f"tok/s={len(r.tokens)/r.decode_s:.1f}"
               if r.decode_s > 0 else "tok/s=n/a")
        print(f"[serve] req {r.rid}: engine={r.engine_id} "
              f"queue={r.queue_s*1e3:.1f}ms "
              f"prefill={r.prefill_s*1e3:.1f}ms "
              f"decode={r.decode_s*1e3:.1f}ms "
              f"service={r.service_s*1e3:.1f}ms {tps}")
    st = summarize(done)
    line = (f"[serve] {scheduler.name}: n={st['count']} "
            f"mean={st['mean_s']*1e3:.1f}ms p95={st['p95_s']*1e3:.1f}ms "
            f"max={st['max_s']*1e3:.1f}ms")
    if st["prefill_tokens_saved"]:
        line += (f" prefix_saved={st['prefill_tokens_saved']}tok"
                 f" hit={st['prefix_hit_rate']:.2f}")
    print(line)
    st["engines"] = [{"layers": e.cfg.num_layers,
                      "decode_rounds": e.decode_rounds,
                      "token_ms": e.est_token_seconds * 1e3,
                      "kv_leak": e.kv_leak} for e in engines]
    st["launches"] = {k: v - launches0[k] for k, v in ops.launches.items()}
    st["wall_s"] = wall
    st["tok_s"] = sum(len(r.tokens) for r in done) / wall if wall else 0.0
    return st


if __name__ == "__main__":
    main()
