"""Roofline summary from the port's dry-run records.

Port of ``benchmarks/roofline.py``: reads ``torch_dryrun_<mesh>.jsonl``
(written by ``python -m repro_torch.launch.dryrun --all --mesh <mesh>``)
and emits one CSV row per (arch x shape x mesh): the three roofline
terms over the H100's peaks, the bottleneck, whether one rank's
arguments fit 80 GB, and the MODEL_FLOPS / counted FLOPs ratio.
"""
from __future__ import annotations

import os
from typing import List

from repro_torch.launch.specs import MESHES
from repro_torch.roofline.report import latest_by_combo, load


def bench_roofline(results: str = "results") -> List[str]:
    rows = []
    for tag in MESHES:
        fname = f"torch_dryrun_{tag}.jsonl"
        seen = latest_by_combo(load(os.path.join(results, fname)))
        for (arch, shape), r in sorted(seen.items()):
            coll = r["collective_s"]
            dom = {"compute": r["compute_s"], "memory": r["memory_s"],
                   "collective": coll}[r["bottleneck"]]
            ratio = r.get("useful_ratio")
            rows.append(
                f"roofline_{tag}/{arch}/{shape},{dom * 1e6:.1f},"
                f"bottleneck={r['bottleneck']};"
                f"compute={r['compute_s']:.2e};"
                f"memory={r['memory_s']:.2e};"
                f"collective={coll:.2e};"
                f"fits={int(r['fits_hbm'])};"
                f"useful={'' if ratio is None else f'{ratio:.2f}'}")
        if not seen:
            rows.append(f"roofline_{tag}/missing,0,"
                        "run `python -m repro_torch.launch.dryrun --all "
                        f"--mesh {tag}` first")
    return rows
