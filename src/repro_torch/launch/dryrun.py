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
kernels run (their FLOPs; only their outputs written), and each call's
shapes are kept (``kernel_calls``).

On ``1x1`` the pass traces the one card's step: a MoE config runs the
port's mesh path on a one-rank group (the placed layers' gathers and
sums included), anything else issues no collective; a one-rank group
crosses no link, so the collective term is 0 there.  On a mesh of more
than one rank (16x16, 2x16x16) it traces rank 0's own program, as the
reference reads its per-device SPMD module: :func:`rank_zero` starts a
fake process group of the mesh's size in this process (torch's ``fake``
c10d backend: every collective returns outputs of the right shape and
moves nothing), the step runs inside the mesh's ``ShardingContext`` on
rank 0's blocks (params by ``sharding.place_params``, a decode's slot
pool by ``sharding.pool_pspecs``, its rows of the tokens), and the
record is that rank's: its FLOPs, bytes written and argument bytes, and
its collectives, each counted as the reference counts an HLO collective:
its output bytes on the rank, times the trip count of the loop it sits
in.  The collective term is those bytes over ``NVLINK_BW``.

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

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_shape
from repro_torch.launch import sharding
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, NVLINK_BW,
                                     PEAK_FLOPS_BF16, make_production_mesh,
                                     make_smoke_mesh)
from repro_torch.launch.specs import (_batch_axes, argument_bytes,
                                      input_specs, mesh_shape)
from repro_torch.models.transformer import config_for_shape
from repro_torch.roofline import analysis as ra
from repro_torch.serving.compiled import make_pool_decode
from repro_torch.train.optimizer import AdamWState
from repro_torch.train.steps import (make_decode_step, make_prefill_step,
                                     make_train_step)

ONE_RANK = ("one rank: the collectives run on a one-rank group and move "
            "nothing over a link; collective_bytes counts what they hand "
            "over, and the collective term is 0")
RANK_ZERO = ("rank 0's own program on a fake process group of the mesh's "
             "size: its FLOPs, bytes and collectives; collective_bytes "
             "sums each collective's output bytes on the rank, times its "
             "loop's trip count")


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
    CPU, whose collectives take fake tensors).  Anything else on one rank
    runs as on one card."""
    if cfg.moe is None or mesh is None or mesh.size != 1:
        return contextlib.nullcontext()
    smoke = make_smoke_mesh("cpu")
    return sharding.use(sharding.ShardingContext(
        smoke, rules={"batch": _batch_axes(smoke, shape.global_batch)}))


def _fake_store():
    """A ``FakeStore`` for torch's ``fake`` c10d backend, which registers
    itself when its module is imported.  That module is part of torch's
    own test suite (``torch.testing._internal``), with no stability
    promise; the port is tested with it on torch 2.11 and 2.13."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"the per-rank dry run needs torch's fake process group "
            f"(torch.testing._internal.distributed.fake_pg.FakeStore), "
            f"which torch {torch.__version__} does not provide: {e}") from e
    return FakeStore()


@contextlib.contextmanager
def rank_zero(mesh, device="cpu"):
    """Rank 0 of a fake process group of ``mesh.size`` ranks in this
    process (torch's ``fake`` c10d backend: each collective gives outputs
    of the right shape, uninitialised, and moves nothing), and the
    port's :class:`~repro_torch.launch.mesh.Mesh` of ``mesh``'s axes on
    it over ``device``.  The group is started here and destroyed on
    exit; a process that already has a default group cannot hold a
    second one and gets a ``ValueError``."""
    store = _fake_store()
    if dist.is_initialized():
        raise ValueError(
            f"rank 0 of {mesh.size} ranks needs a fake process group of its "
            f"own, but this process already has one of world size "
            f"{dist.get_world_size()}: run the dry run in a process "
            f"without a group")
    dist.init_process_group("fake", rank=0, world_size=mesh.size,
                            store=store)
    try:
        yield make_production_mesh(shape=mesh.sizes, axes=mesh.axis_names,
                                   device=device)
    finally:
        dist.destroy_process_group()


def _axes_tuple(axes):
    return () if axes is None else (axes if isinstance(axes, tuple)
                                    else (axes,))


def rank_program(cfg, shape, mesh, args):
    """(step, its args) of rank 0 on ``mesh`` (a live mesh, rank 0 of
    its group), from the shape's whole ``args`` (``input_specs``' fake
    tensors, called inside their fake mode, or real ones of the same
    structure): the params (and a train step's AdamW
    moments) as ``sharding.place_params`` hands rank 0 its blocks; a
    train step takes the whole batch, as the data-parallel step does
    (each microbatch's rows split inside it); a prefill runs rank 0's
    rows of the batch over the data axes, a decode round the engines'
    pool step (``serving.compiled.make_pool_decode``) on rank 0's block
    of the slot pool (``sharding.pool_pspecs``).  The step runs inside
    the mesh's ``ShardingContext``."""
    ctx = sharding.ShardingContext(mesh, rules={
        "batch": _batch_axes(mesh, shape.global_batch)})
    params = sharding.place_params(mesh, args[0], cfg)
    if shape.kind == "train":
        opt, batch = args[1], args[2]
        opt = AdamWState(step=opt.step,
                         mu=sharding.place_params(mesh, opt.mu, cfg),
                         nu=sharding.place_params(mesh, opt.nu, cfg))
        step = make_train_step(cfg)

        def run(*a):
            with sharding.use(ctx):
                return step(*a)

        return run, (params, opt, batch)
    if shape.kind == "prefill":
        axes = _axes_tuple(_batch_axes(mesh, shape.global_batch))
        batch = {k: sharding.my_rows(v, mesh, axes)
                 for k, v in args[1].items()}
        step = make_prefill_step(cfg)
        rows = ctx.split_rows(axes)

        def run(*a):
            with sharding.use(rows):
                return step(*a)

        return run, (params, batch)
    states = args[2]
    states = sharding.place_states(mesh, states,
                                   sharding.pool_pspecs(states, mesh))
    step = make_pool_decode(cfg, shape.global_batch, False, 1.0, mesh=mesh,
                            max_len=shape.seq_len)
    return step, (params, args[1]["tokens"], states)


def trace(cfg, shape, mesh) -> dict:
    """One step of ``cfg`` at ``shape`` under the counting pass: the
    per-op tallies (the collectives as ``c10d.*`` ops), the kernel calls'
    shapes and the argument bytes (all ranks, one rank).  On a mesh of
    more than one rank, rank 0's program (:func:`rank_program`) on a
    fake group (:func:`rank_zero`)."""
    fake = FakeTensorMode()
    args, kwargs, specs = input_specs(cfg, shape, mesh, fake)
    total, rank = argument_bytes(args, specs, mesh)
    calls: dict = {}
    if mesh is not None and mesh.size > 1:
        with rank_zero(mesh) as live:
            with fake:
                step, args = rank_program(cfg, shape, live, args)
                _, tallies = ra.count_ops(step, *args, calls=calls,
                                          **kwargs)
    else:
        ctx = _mesh_context(cfg, shape, mesh)    # real tensors: out of fake
        with fake, ctx:
            _, tallies = ra.count_ops(step_for_shape(cfg, shape), *args,
                                      calls=calls, **kwargs)
    return {"tallies": tallies, "kernel_calls": calls,
            "argument_bytes_total": total, "argument_bytes": rank}


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
    docstring).  One rank's work: on one rank the step's; on a larger
    mesh the counts are rank 0's own program's, with its own argument
    bytes.  ``save_counts_dir`` keeps the counts for
    ``roofline/reanalyze.py``."""
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
                       "kernel_calls": counts.get("kernel_calls", {}),
                       "argument_bytes_total": counts["argument_bytes_total"],
                       "argument_bytes": counts["argument_bytes"],
                       **extra}, f)
    tot = ra.totals(counts["tallies"])
    flops = float(tot["flops"])
    if chips == 1:
        bytes_ = float(tot["written_bytes"] + counts["argument_bytes_total"])
    else:                              # rank 0's program: its own bytes
        bytes_ = float(tot["written_bytes"] + counts["argument_bytes"])
    colls = {k: v for k, v in counts["tallies"].items()
             if k.startswith("c10d.")}
    coll = sum(v[2] for v in colls.values())
    mflops = ra.model_flops(cfg, shape)
    # one rank's collectives cross no link: no time on NVLink
    terms = ra.roofline_terms(flops, bytes_, 0 if chips == 1 else coll,
                              chips, PEAK_FLOPS_BF16, HBM_BW, NVLINK_BW)
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
        "flops_per_rank": flops,
        "bytes_per_rank": (float(tot["written_bytes"]
                                 + counts["argument_bytes"])),
        "collective_bytes": coll,
        "collective_by_kind": {k: v[2] for k, v in colls.items()},
        "n_collectives": sum(v[0] for v in colls.values()),
        "model_flops": mflops,
        "useful_ratio": (mflops / (flops * chips)) if flops else None,
        "kernel_calls": counts.get("kernel_calls", {}),
        **terms,
    }
    rec["collective_note"] = ONE_RANK if chips == 1 else RANK_ZERO
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
                print(f"[dryrun] OK {arch} x {shape_name}: "
                      f"bottleneck={rec['bottleneck']} "
                      f"compute={rec['compute_s']:.3e}s "
                      f"memory={rec['memory_s']:.3e}s "
                      f"collective={rec['collective_s']:.3e}s "
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
