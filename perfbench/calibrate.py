"""Read the check's two readings of a cell on the card: the program's
numbers on many seeds and the control's on the same requests.

    python3 perfbench/calibrate.py --workload <cell> --seeds 101,102,... \\
        --seconds 15

For each seed, in one process: a full set-up from the seed, a window of
``--seconds`` at the cell's own load, then the check's numbers of the
program (``logit_gap`` of its served tokens, ``denoise_err`` of its
placements) and of the control, the reference computed one step below
the configured precision on the same sample (``logit_gap`` of the token
the float8 reference puts first at each position, ``denoise_err`` of the
chain in bfloat16).  Prints one JSON line per seed; the limits in
``limits/<cell>.json`` are set from these (PERF.md gives the readings).
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]


def main() -> None:
    import torch

    from perfbench import check, harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--sample", type=int, default=None)
    args = ap.parse_args()
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        opts = harness.Options(seed=seed, seconds=args.seconds,
                               sample=args.sample)
        served = harness.setup(cell, opts)
        reqs = harness.requests(cell, opts, served.spec["vocab"],
                                cell.conf["serve"]["engines"])
        rec = harness.settle(served, reqs, harness.serve(served, reqs, t))
        k = opts.sample or cell.limits.get("sample", 16)
        sample = check.pick_sample(harness.finished(rec), k, seed)
        row = {"seed": seed, "finished": len(harness.finished(rec)),
               "sampled": len(sample),
               "sampled_tokens": int(sum(len(r.tokens) for r in sample)),
               "placements": len(rec["placements"])}
        t1 = time.perf_counter()
        row["logit_gap"] = check.logit_gap(cell.kind, served.weights,
                                           served.spec, sample)
        row["ref_s"] = time.perf_counter() - t1
        row["control_logit_gap"] = check.logit_gap(
            cell.kind, served.weights, served.spec, sample,
            precision="fp8")
        sch = cell.conf["scheduler"]
        prog = check.denoise_err(rec["placements"], rec["requests"],
                                 served.actor, sch)
        row["denoise_err"] = prog["denoise_err"]
        row["place_disagree"] = prog["place_disagree"]
        row["control_denoise_err"] = check.control_denoise_err(
            rec["placements"], rec["requests"], served.actor, sch)
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
        del served, rec, reqs, sample
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    main()
