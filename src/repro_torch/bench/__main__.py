"""Bench runner of the port, the counterpart of ``benchmarks/run.py``:
one bench per paper table / figure, printed as ``name,us_per_call,derived``
CSV.

  PYTHONPATH=src python -m repro_torch.bench --only fig5,tablev,kernels \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.bench --scale paper --only fig5
  PYTHONPATH=src python -m repro_torch.bench --only closedloop,kernels \\
      --out-dir bench_out [--trajectory]
  PYTHONPATH=src python -m repro_torch.bench closedloop --device cpu \\
      [--full-scale] [--out closedloop.json]

Mapping to the paper:
  fig5     -> Fig. 5   learning curves + convergence episodes
  fig6a    -> Fig. 6a  delay vs number of tasks
  fig6b    -> Fig. 6b  delay vs ES capacity
  fig7a    -> Fig. 7a  delay vs quality demand z
  fig7b    -> Fig. 7b  delay vs number of BSs
  fig8     -> Fig. 8   denoising steps I / entropy temperature alpha
  tablev   -> Table V  centralized vs distributed serving makespan
  closedloop, chaos, stress -> the systems benches (``bench/serving.py``,
              ``bench/stress.py``)
  kernels  -> the four kernels against their plain versions
  roofline -> the dry run's roofline terms per (arch x shape x mesh)

Every bench runs on ``cuda`` unless ``--device cpu`` is given.
``--scale quick|paper`` sizes fig5-8 (the reference's quick environment
or Table III); the serving benches take ``--full-scale`` instead (the
fleet at published widths, depth and dtype).  ``--out-dir`` writes
``BENCH_<name>.json`` for every bench with records, and ``--trajectory``
appends the run's headline numbers to ``BENCH_trajectory.json`` there.
The single positional form runs one bench and ``--out`` writes its
records.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

BENCHES = ("fig5", "fig6a", "fig6b", "fig7a", "fig7b", "fig8", "tablev",
           "closedloop", "chaos", "kernels", "roofline", "stress")
SERVING = ("tablev", "closedloop", "chaos", "stress")
# the reference's sweep values per scale (benchmarks/run.py)
SWEEPS = {"fig6a": ("max_tasks", (10, 30, 50, 70), (4, 8, 12)),
          "fig6b": ("f_hi", (30, 50, 70), (20, 40)),
          "fig7a": ("z_hi", (5, 10, 15, 20), (5, 15)),
          "fig7b": ("num_bs", (10, 20, 30, 40), (4, 8))}


def run_bench(name: str, args) -> tuple:
    """(csv rows, records or None) of bench ``name``."""
    dev = args.device
    if name in SERVING:
        if name == "stress":
            from repro_torch.bench.stress import bench_stress as fn
        else:
            from repro_torch.bench import serving
            fn = {"tablev": serving.bench_tablev,
                  "closedloop": serving.bench_closed_loop,
                  "chaos": serving.bench_chaos}[name]
        return fn(device=dev, full_scale=args.full_scale)
    if name == "kernels":
        from repro_torch.bench.kernels import bench_kernels
        return bench_kernels(device=dev)
    if name == "roofline":
        from repro_torch.bench.roofline import bench_roofline
        return bench_roofline(args.results), None
    from repro_torch.bench import scheduling
    records: List[dict] = []
    if name == "fig5":
        rows, _ = scheduling.bench_fig5_learning(args.scale, device=dev,
                                                 records=records)
    elif name == "fig8":
        rows = scheduling.bench_fig8_params(args.scale, device=dev,
                                            records=records)
    else:
        param, paper, quick = SWEEPS[name]
        rows = scheduling.bench_sweep(
            args.scale, param, paper if args.scale == "paper" else quick,
            device=dev, records=records)
    return rows, records


def _tolist(o):   # numpy / torch scalars and arrays
    return o.tolist() if hasattr(o, "tolist") else str(o)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.bench")
    ap.add_argument("bench", nargs="?", choices=BENCHES,
                    help="run this one bench (the same as --only NAME)")
    ap.add_argument("--only", default=None,
                    help="comma list of: " + ",".join(BENCHES))
    ap.add_argument("--scale", choices=["quick", "paper"], default="quick",
                    help="fig5-8 only")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--full-scale", action="store_true",
                    help="serving benches: the fleet at published widths, "
                         "depth and dtype")
    ap.add_argument("--results", default="results",
                    help="where roofline reads the dry-run records")
    ap.add_argument("--out", default=None,
                    help="with one bench: write its records to this path")
    ap.add_argument("--out-dir", default=None,
                    help="write BENCH_<name>.json result files here")
    ap.add_argument("--trajectory", action="store_true",
                    help="append a per-run summary (git sha, date, knee "
                         "goodput, p95, prefix savings) to "
                         "BENCH_trajectory.json in --out-dir")
    args = ap.parse_args(argv)
    if args.bench and args.only:
        ap.error("give a bench or --only, not both")
    names = ([args.bench] if args.bench else
             args.only.split(",") if args.only else list(BENCHES))
    bad = [n for n in names if n not in BENCHES]
    if bad:
        ap.error(f"unknown bench(es) {bad}; options: {list(BENCHES)}")
    if args.out and len(names) != 1:
        ap.error("--out takes one bench; use --out-dir for several")
    if args.trajectory and args.out_dir is None:
        ap.error("--trajectory requires --out-dir")

    all_records = {}

    def write(path, doc):
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=2, default=_tolist)
        print(f"# wrote {path}", file=sys.stderr)

    def emit(name, records):
        all_records[name] = records
        if args.out:
            write(args.out, {"bench": name, "full_scale": args.full_scale,
                             "records": records})
        if args.out_dir is not None:
            os.makedirs(args.out_dir, exist_ok=True)
            write(os.path.join(args.out_dir, f"BENCH_{name}.json"),
                  {"bench": name, "scale": args.scale,
                   "full_scale": args.full_scale, "records": records})

    rows = []
    t0 = time.time()
    for name in names:
        r, recs = run_bench(name, args)
        rows += r
        if recs is not None:
            emit(name, recs)

    print("name,us_per_call,derived")
    for r in rows:
        print(r)
    print(f"# total bench wall time: {time.time() - t0:.1f}s",
          file=sys.stderr)
    if args.trajectory:
        append_trajectory(args.out_dir, args.scale, all_records)


def _git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or "unknown"
    except Exception:   # noqa: BLE001 — no git in the environment
        return "unknown"


def append_trajectory(out_dir: str, scale: str, all_records: dict) -> None:
    """Append this run's headline numbers to ``BENCH_trajectory.json``:
    the git sha and date and, per scheduler, the stress knee goodput (and
    p95 at the knee), the closed-loop mean / p95 with prefix savings and
    the chaos completion rate; the same entry as the reference's."""
    entry = {"git_sha": _git_sha(), "scale": scale,
             "date_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
             "benches": sorted(all_records)}
    stress = [r for r in all_records.get("stress", [])
              if r.get("bench") == "stress_stage"]
    if stress:
        knees = {}
        for name in sorted({r["scheduler"] for r in stress}):
            stages = [r for r in stress if r["scheduler"] == name]
            knee = max(stages, key=lambda r: r["goodput_rps"])
            knees[name] = {"knee_goodput_rps": knee["goodput_rps"],
                           "knee_offered_rate": knee["offered_rate"],
                           "knee_p95_s": knee["p95_s"]}
        entry["stress"] = knees
    closed = [r for r in all_records.get("closedloop", [])
              if r.get("bench") == "closedloop_live"]
    if closed:
        entry["closedloop"] = {
            r["scheduler"]: {"mean_s": r["mean_s"], "p95_s": r["p95_s"],
                             "prefill_tokens_saved":
                                 r.get("prefill_tokens_saved", 0),
                             "prefix_hit_rate":
                                 r.get("prefix_hit_rate", 0.0)}
            for r in closed}
    chaos = [r for r in all_records.get("chaos", [])
             if r.get("bench") == "chaos_live"]
    if chaos:
        entry["chaos"] = {r["scheduler"]: r["completion_rate"]
                          for r in chaos}

    path = os.path.join(out_dir, "BENCH_trajectory.json")
    doc = {"bench": "trajectory", "runs": []}
    if os.path.exists(path):
        try:
            with open(path) as f:
                prev = json.load(f)
            if isinstance(prev.get("runs"), list):
                doc = prev
        except (OSError, ValueError):
            pass            # corrupt trajectory: restart it, don't crash
    doc["runs"].append(entry)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"# appended run {entry['git_sha']} to {path} "
          f"({len(doc['runs'])} runs)", file=sys.stderr)


if __name__ == "__main__":
    main()
