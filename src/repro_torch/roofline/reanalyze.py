"""Re-derive roofline records from saved per-op tallies (no retrace).

Port of ``repro/roofline/reanalyze.py``: the reference re-reads saved
HLO, the port the counting pass's tallies that ``repro_torch.launch.
dryrun --save-counts DIR`` keeps (one gzipped JSON a combo), through the
same :func:`repro_torch.launch.dryrun.analyse`.

  PYTHONPATH=src python -m repro_torch.roofline.reanalyze \\
      --counts-dir results/torch_counts --out results/torch_dryrun_1x1.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import gzip
import json
import os

from repro_torch.configs import get_config, get_shape
from repro_torch.launch.dryrun import analyse, parse_overrides
from repro_torch.launch.specs import mesh_shape
from repro_torch.models.transformer import config_for_shape

SUFFIX = ".counts.json.gz"


def reanalyze_file(path: str) -> dict:
    with gzip.open(path, "rt") as f:
        counts = json.load(f)
    shape = get_shape(counts["shape"])
    cfg = config_for_shape(get_config(counts["arch"]), shape)
    over = parse_overrides(f"{k}={v}" for k, v in
                           counts.get("overrides", {}).items())
    if over:
        cfg = dataclasses.replace(cfg, **over)
    return analyse(cfg, shape, mesh_shape(counts["mesh"]), counts,
                   counts["trace_s"], tag=counts.get("tag"), overrides=over)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.roofline.reanalyze")
    ap.add_argument("--counts-dir", default="results/torch_counts")
    ap.add_argument("--out", default=None)
    ap.add_argument("--mesh", default=None, help="filter, e.g. 16x16")
    args = ap.parse_args(argv)
    recs = []
    for path in sorted(glob.glob(os.path.join(args.counts_dir,
                                              "*" + SUFFIX))):
        if args.mesh and not path.endswith(f"__{args.mesh}{SUFFIX}"):
            continue
        rec = reanalyze_file(path)
        recs.append(rec)
        coll = rec["collective_s"]
        print(f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s} "
              f"{rec['bottleneck']:10s} c={rec['compute_s']:.2e} "
              f"m={rec['memory_s']:.2e} "
              f"x={coll:.2e}")
    if args.out:
        with open(args.out, "w") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
