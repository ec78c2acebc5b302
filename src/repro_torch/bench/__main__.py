"""Bench runner of the port: prints ``name,us_per_call,derived`` CSV.

  PYTHONPATH=src python -m repro_torch.bench closedloop --device cpu
  PYTHONPATH=src python -m repro_torch.bench chaos --device cpu
  PYTHONPATH=src python -m repro_torch.bench stress --device cpu
  PYTHONPATH=src python -m repro_torch.bench closedloop --full-scale \\
      --out closedloop.json

``closedloop``, ``chaos`` and ``stress`` mirror ``python -m
benchmarks.run --only closedloop|chaos|stress`` at the reference's quick
scale; they run on ``cuda`` unless ``--device cpu`` is given.  ``--out``
writes the records as JSON (``{"bench", "full_scale", "records"}``, the
records shaped as the reference's ``BENCH_<name>.json`` records);
nothing is written otherwise.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

BENCHES = ("closedloop", "chaos", "stress")


def _bench(name: str):
    if name == "stress":
        from repro_torch.bench import stress
        return stress.bench_stress
    from repro_torch.bench import serving
    return {"closedloop": serving.bench_closed_loop,
            "chaos": serving.bench_chaos}[name]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.bench")
    ap.add_argument("bench", choices=BENCHES)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--full-scale", action="store_true",
                    help="the fleet at published widths, depth and dtype")
    ap.add_argument("--out", default=None,
                    help="write the JSON records to this path")
    args = ap.parse_args(argv)

    t0 = time.time()
    rows, records = _bench(args.bench)(device=args.device,
                                       full_scale=args.full_scale)
    print("name,us_per_call,derived")
    for r in rows:
        print(r)
    print(f"# total bench wall time: {time.time() - t0:.1f}s",
          file=sys.stderr)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"bench": args.bench, "full_scale": args.full_scale,
                       "records": records}, fh, indent=2,
                      default=lambda o: o.tolist() if hasattr(o, "tolist")
                      else str(o))
        print(f"# wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
