"""Find a latency cell's knee on the card, once, by a sweep of rates.

    python3 perfbench/sweep.py --workload <cell> --rates 2,4,6,8,12,16 \\
        --seconds 20 --seed <n>

One set-up, then for each rate a fresh cluster on the reset engines
serves the cell's mix at that rate for ``--seconds``, drained as a run
drains.  Prints one JSON line per rate: requests, unfinished, mean and
p95 service, the mean of the first, middle and last third of arrivals
(a queue that grows shows as the last third well above the middle one;
the first third carries the start), the drain's seconds.  The knee is
the highest rate whose queue stays steady: every request finished and
the last third within 1.2x of the middle third.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]


def main() -> None:
    import numpy as np

    from perfbench import harness, layers
    from repro_torch.cluster.live import EdgeCluster

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    cell = harness.load_cell(args.workload)
    rates = [float(r) for r in args.rates.split(",")]
    opts = harness.Options(seed=args.seed, seconds=args.seconds)
    served = harness.setup(cell, opts)
    rows = []
    for rate in rates:
        served.opts = dataclasses.replace(opts, rate=rate)
        for e in served.engines:
            e.reset()
        served.cluster = EdgeCluster(served.engines, served.scheduler,
                                     seed=args.seed)
        reqs = harness.requests(cell, served.opts, served.spec["vocab"],
                                len(served.engines))
        rec = harness.serve(served, reqs, time.perf_counter())
        rec["requests"] = reqs[:rec["submitted"]]
        d = layers.delays_s(rec)
        third = max(len(d) // 3, 1)
        row = {"rate": rate, "requests": len(d),
               "unfinished": int(sum(not r.done for r in reqs)),
               "mean_ms": float(d.mean() * 1e3),
               "p95_ms": float(np.percentile(d, 95) * 1e3),
               "first_third_ms": float(d[:third].mean() * 1e3),
               "middle_third_ms": float(d[third:-third].mean() * 1e3),
               "last_third_ms": float(d[-third:].mean() * 1e3),
               "drain_s": rec["close"] - rec["seconds"],
               "engine_skew": layers.engine_skew(rec)}
        row["steady"] = (row["unfinished"] == 0 and row["last_third_ms"]
                         <= 1.2 * row["middle_third_ms"])
        rows.append(row)
        served.probes.placements.clear()
        print(json.dumps(row), flush=True)
    steady = [r["rate"] for r in rows if r["steady"]]
    print(json.dumps({"knee": max(steady) if steady else None,
                      "rate_at_0.8": 0.8 * max(steady) if steady else None}))


if __name__ == "__main__":
    main()
