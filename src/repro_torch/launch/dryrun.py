"""Dry run: what each (architecture x input shape x mesh) asks of a card.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each step on a TPU mesh and reads XLA's memory and cost analyses.  The
port runs the real step function once on fake tensors instead
(``launch/specs.py``: shapes and dtypes, no storage) under the counting
pass of ``roofline/analysis.py``, and records:

  * argument bytes, all ranks' and one rank's under the partition specs
    (``launch/sharding.py``), and whether one rank's fit an 80 GB card;
  * the FLOPs and bytes of the step (roofline inputs), with one
    iteration of each repeated Python loop counted trip-count times;
  * the three roofline terms over the H100's peaks (``launch/mesh.py``),
    one rank's share of the work, and the bottleneck.

The counting pass is the one part of the port that never runs on the
card: its tensors are fake CPU tensors, so no device is needed or used.
The kernel wrappers take their plain versions there, counted as the
kernels run (their FLOPs; only their outputs written).  A mesh needs
only its axis sizes.  Collective bytes are those the port's own
collectives take (``c10d`` ops in the count): on ``1x1`` a MoE config
runs the port's mesh path on a one-rank group (the placed layers'
gathers and sums included), anything else issues none; a one-rank group
crosses no link, so the collective term is 0 there.  The port places
every weight and dense cache on a mesh (``launch/sharding.py``), but the
counting pass traces one global program, not one rank's, and there is
no HLO to read, so on meshes of more than one rank the record carries
``collective_bytes: null`` and the reason (ROADMAP.md A7c).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh 1x1|16x16|2x16x16]

Records go to ``results/torch_dryrun_<mesh>.jsonl`` unless ``--out``;
``--save-counts DIR`` keeps each combo's per-op tallies (gzipped JSON)
for ``repro_torch.roofline.reanalyze``.
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import gzip
import json
import os
import time
import traceback
from typing import Optional

from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_shape
from repro_torch.launch import sharding
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, NVLINK_BW,
                                     PEAK_FLOPS_BF16, make_smoke_mesh)
from repro_torch.launch.specs import (_batch_axes, argument_bytes,
                                      input_specs, mesh_shape)
from repro_torch.models.transformer import config_for_shape
from repro_torch.roofline import analysis as ra
from repro_torch.train.steps import (make_decode_step, make_prefill_step,
                                     make_train_step)

NO_COLLECTIVES = ("the counting pass traces one global program, not a "
                  "rank's, and has no HLO to read: the placement's "
                  "collectives on this mesh are not counted (ROADMAP.md "
                  "A7c)")
ONE_RANK = ("one rank: the collectives run on a one-rank group and move "
            "nothing over a link; collective_bytes counts what they hand "
            "over, and the collective term is 0")


def step_for_shape(cfg, shape):
    if shape.kind == "train":
        return make_train_step(cfg)
    if shape.kind == "prefill":
        return make_prefill_step(cfg)
    # decode: greedy token, no generator
    fn = make_decode_step(cfg, sample=False)
    return lambda params, batch, states: fn(params, batch, states)


def _mesh_context(cfg, shape, mesh):
    """A MoE config on a one-rank mesh runs the port's mesh path, as
    ``ServeEngine(mesh=)`` and the train step on the smoke mesh do: inside
    the 1 x 1 smoke mesh's sharding context (a one-rank gloo group on the
    CPU, whose collectives take fake tensors).  Anything else runs as on
    one card: larger meshes have no process group here."""
    if cfg.moe is None or mesh is None or mesh.size != 1:
        return contextlib.nullcontext()
    smoke = make_smoke_mesh("cpu")
    return sharding.use(sharding.ShardingContext(
        smoke, rules={"batch": _batch_axes(smoke, shape.global_batch)}))


def trace(cfg, shape, mesh) -> dict:
    """One step of ``cfg`` at ``shape`` under the counting pass: the
    per-op tallies (the collectives as ``c10d.*`` ops) and the argument
    bytes (all ranks, one rank)."""
    fake = FakeTensorMode()
    args, kwargs, specs = input_specs(cfg, shape, mesh, fake)
    total, rank = argument_bytes(args, specs, mesh)
    ctx = _mesh_context(cfg, shape, mesh)      # real tensors: out of fake
    with fake, ctx:
        _, tallies = ra.count_ops(step_for_shape(cfg, shape), *args,
                                  **kwargs)
    return {"tallies": tallies, "argument_bytes_total": total,
            "argument_bytes": rank}


def trace_one(arch: str, shape_name: str, mesh_tag: str = "1x1",
              arch_overrides=None):
    """The counterpart of the reference's ``lower_one``: returns
    (cfg, shape, mesh, counts)."""
    shape = get_shape(shape_name)
    cfg = config_for_shape(get_config(arch), shape)
    if arch_overrides:
        cfg = dataclasses.replace(cfg, **arch_overrides)
    mesh = mesh_shape(mesh_tag)
    return cfg, shape, mesh, trace(cfg, shape, mesh)


def analyse(cfg, shape, mesh, counts: dict, trace_s: float,
            save_counts_dir: Optional[str] = None, tag=None,
            overrides: Optional[dict] = None) -> dict:
    """The record of one combo from its counts (see the module
    docstring).  One rank's work: the FLOPs and written bytes split
    evenly over the ranks, its own argument bytes.  ``save_counts_dir``
    keeps the counts for ``roofline/reanalyze.py``."""
    chips = mesh.size
    extra = {}
    if tag:
        extra["tag"] = tag
    if overrides:
        extra["overrides"] = {k: str(v) for k, v in overrides.items()}
    if save_counts_dir:
        os.makedirs(save_counts_dir, exist_ok=True)
        path = os.path.join(save_counts_dir, f"{cfg.name}__{shape.name}__"
                            f"{mesh.tag}.counts.json.gz")
        with gzip.open(path, "wt") as f:
            json.dump({"arch": cfg.name, "shape": shape.name,
                       "mesh": mesh.tag, "trace_s": trace_s,
                       "tallies": counts["tallies"],
                       "argument_bytes_total": counts["argument_bytes_total"],
                       "argument_bytes": counts["argument_bytes"],
                       **extra}, f)
    tot = ra.totals(counts["tallies"])
    flops = float(tot["flops"])
    bytes_ = float(tot["written_bytes"] + counts["argument_bytes_total"])
    flops_rank = flops / chips
    bytes_rank = tot["written_bytes"] / chips + counts["argument_bytes"]
    colls = {k: v for k, v in counts["tallies"].items()
             if k.startswith("c10d.")}
    coll = sum(v[2] for v in colls.values()) if chips == 1 else None
    mflops = ra.model_flops(cfg, shape)
    # one rank's collectives cross no link: no time on NVLink
    terms = ra.roofline_terms(flops_rank, bytes_rank,
                              None if coll is None else 0, chips,
                              PEAK_FLOPS_BF16, HBM_BW, NVLINK_BW)
    rec = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh.tag,
        "chips": chips,
        "trace_s": round(trace_s, 1),
        "n_ops": tot["n_ops"],
        "flops": flops,
        "bytes": bytes_,
        "written_bytes": tot["written_bytes"],
        "argument_bytes_total": counts["argument_bytes_total"],
        "argument_bytes": counts["argument_bytes"],
        "fits_hbm": counts["argument_bytes"] <= HBM_BYTES,
        "flops_per_rank": flops_rank,
        "bytes_per_rank": bytes_rank,
        "collective_bytes": coll,
        "collective_by_kind": (None if coll is None else
                               {k: v[2] for k, v in colls.items()}),
        "n_collectives": (None if coll is None else
                          sum(v[0] for v in colls.values())),
        "model_flops": mflops,
        "useful_ratio": (mflops / flops) if flops else None,
        **terms,
    }
    rec["collective_note"] = NO_COLLECTIVES if coll is None else ONE_RANK
    rec.update(extra)
    return rec


def run_one(arch: str, shape_name: str, mesh_tag: str = "1x1",
            verbose: bool = True, arch_overrides=None, tag=None,
            save_counts_dir=None) -> dict:
    t0 = time.time()
    cfg, shape, mesh, counts = trace_one(arch, shape_name, mesh_tag,
                                         arch_overrides=arch_overrides)
    trace_s = time.time() - t0
    rec = analyse(cfg, shape, mesh, counts, trace_s,
                  save_counts_dir=save_counts_dir, tag=tag,
                  overrides=arch_overrides)
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} mesh={mesh.tag} "
              f"trace={trace_s:.1f}s ops={rec['n_ops']} "
              f"flops={rec['flops']:.4e} bytes={rec['bytes']:.4e} "
              f"args/rank={rec['argument_bytes']}", flush=True)
    return rec


def skip_reason(arch: str, shape_name: str):
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if shape.kind == "decode" and shape.seq_len > 65536:
        if not cfg.is_subquadratic():
            return "full attention without long-context variant"
    return None


def parse_overrides(items) -> dict:
    overrides = {}
    for item in items:
        k, v = item.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None,
                    choices=[s.name for s in SHAPES])
    ap.add_argument("--mesh", default="1x1",
                    choices=["1x1", "16x16", "2x16x16"])
    ap.add_argument("--multi-pod", action="store_true",
                    help="the same as --mesh 2x16x16")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) for the chosen mesh")
    ap.add_argument("--out", default=None,
                    help="append JSONL records here (default "
                         "results/torch_dryrun_<mesh>.jsonl)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default=None,
                    help="label for this run's records (perf iterations)")
    ap.add_argument("--save-counts", default=None,
                    help="directory to store each combo's per-op tallies "
                         "(gzipped JSON), so the roofline can be re-derived "
                         "without retracing")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="ModelConfig override, e.g. --set microbatches=4 "
                         "--set remat=False (perf iterations)")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.overrides)
    mesh_tag = "2x16x16" if args.multi_pod else args.mesh
    out = args.out or os.path.join("results", f"torch_dryrun_{mesh_tag}"
                                   ".jsonl")

    if args.all:
        combos = [(a, s.name) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        combos = [(args.arch, args.shape)]

    done = set()
    if args.skip_existing and os.path.exists(out):
        with open(out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"]))
                except (ValueError, KeyError):
                    pass

    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    failures = []
    t0 = time.time()
    for arch, shape_name in combos:
        if (arch, shape_name, mesh_tag) in done:
            print(f"[dryrun] skip existing {arch} x {shape_name}")
            continue
        reason = skip_reason(arch, shape_name)
        if reason:
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                   "skipped": reason}
            print(f"[dryrun] SKIP {arch} x {shape_name}: {reason}")
        else:
            try:
                rec = run_one(arch, shape_name, mesh_tag,
                              arch_overrides=overrides or None,
                              tag=args.tag,
                              save_counts_dir=args.save_counts)
                coll = rec["collective_s"]
                print(f"[dryrun] OK {arch} x {shape_name}: "
                      f"bottleneck={rec['bottleneck']} "
                      f"compute={rec['compute_s']:.3e}s "
                      f"memory={rec['memory_s']:.3e}s collective="
                      f"{'n/a' if coll is None else f'{coll:.3e}s'} "
                      f"fits={rec['fits_hbm']}", flush=True)
            except Exception as e:  # noqa: BLE001 — recorded, then exit 1
                traceback.print_exc()
                failures.append((arch, shape_name, str(e)))
                rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                       "error": str(e)[:2000]}
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    print(f"[dryrun] {len(combos)} combos in {time.time() - t0:.1f}s; "
          f"records in {out}")
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for a, s, e in failures:
            print(f"  {a} x {s}: {e[:200]}")
        raise SystemExit(1)
    print("[dryrun] all combinations traced successfully")


if __name__ == "__main__":
    main()
