"""Render markdown tables from the port's dry-run JSONL records.

Port of ``repro/roofline/report.py``, over ``results/torch_dryrun_*.jsonl``
(``repro_torch.launch.dryrun``), never the reference's
``results/dryrun_*.jsonl``.

  PYTHONPATH=src python -m repro_torch.roofline.report [--results results/]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

from repro_torch.launch.specs import MESHES


def load(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    recs = []
    with open(path) as f:
        for line in f:
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return recs


def latest_by_combo(recs: List[dict], tag: Optional[str] = None
                    ) -> Dict[tuple, dict]:
    out = {}
    for r in recs:
        if "bottleneck" not in r:
            continue
        if tag is not None and r.get("tag") != tag:
            continue
        out[(r["arch"], r["shape"])] = r
    return out


def fmt_bytes(b) -> str:
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def dryrun_table(recs: Dict[tuple, dict]) -> str:
    lines = ["| arch | shape | trace | args/rank (all ranks) | fits 80 GB "
             "| FLOPs | bytes | collectives |",
             "|---|---|---|---|---|---|---|---|"]
    for (arch, shape), r in sorted(recs.items()):
        coll = r.get("collective_bytes")
        lines.append(
            f"| {arch} | {shape} | {r.get('trace_s', '?')}s "
            f"| {fmt_bytes(r.get('argument_bytes'))} "
            f"({fmt_bytes(r.get('argument_bytes_total'))}) "
            f"| {'yes' if r.get('fits_hbm') else 'no'} "
            f"| {r['flops']:.3e} | {fmt_bytes(r['bytes'])} "
            f"| {fmt_bytes(coll)} |")
    return "\n".join(lines)


def roofline_table(recs: Dict[tuple, dict]) -> str:
    lines = ["| arch | shape | compute (s) | memory (s) | collective (s) "
             "| bottleneck | useful |",
             "|---|---|---|---|---|---|---|"]
    for (arch, shape), r in sorted(recs.items()):
        u = r.get("useful_ratio")
        c = r.get("collective_s")
        lines.append(
            f"| {arch} | {shape} | {r['compute_s']:.2e} "
            f"| {r['memory_s']:.2e} | {c:.2e} "
            f"| **{r['bottleneck']}** "
            f"| {'-' if u is None else f'{u:.2f}'} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.roofline.report")
    ap.add_argument("--results", default="results")
    ap.add_argument("--tag", default=None)
    args = ap.parse_args(argv)
    for mesh, shape in MESHES.items():
        recs = latest_by_combo(load(os.path.join(
            args.results, f"torch_dryrun_{mesh}.jsonl")), args.tag)
        if not recs:
            continue
        title = (f"{mesh} ({shape.size} H100 rank(s)"
                 f"{'; rank 0' if shape.size > 1 else ''})")
        print(f"\n### Dry run — {title}: {len(recs)} combos\n")
        print(dryrun_table(recs))
        print(f"\n### Roofline — {title}, H100 peaks\n")
        print(roofline_table(recs))


if __name__ == "__main__":
    main()
