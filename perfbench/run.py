"""Run one cell of the port's benchmark on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Prints one JSON line, the last of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` and ``check`` (each
number compared, beside its limit); with ``--trace 1`` also
``breakdown``.  Exits non-zero and prints no result without a CUDA card,
with fewer cards than the cell asks for, or when JAX or the JAX package
was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# every build cache at a fixed path inside the checkout
CACHE = REPO / ".perfbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
# one process with few threads: the host-side work is one Python thread
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(REPO), str(REPO / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card; no result", file=sys.stderr)
        return 2
    from perfbench import harness
    opts = harness.Options(seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace))
    try:
        line = harness.run(args.workload, opts, T_START)
    except Exception:  # noqa: BLE001 — report and fail the run
        traceback.print_exc()
        return 1
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: loaded {bad}; no result", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
