#!/usr/bin/env python3
"""Time one of the port's kernels against another tree's, in turns, on
one card.

    python3 tools/turns.py --kernel {ladn_denoise,flash_attention_f32} \\
        --parent DIR --out FILE

``DIR`` holds an unpacked copy of another commit
(``git archive <commit> | tar -x -C DIR``).  Every run is a process of its
own that imports one tree's ``src`` and ``chip_smoke.py``, in the order
other, this, this, other.

``ladn_denoise``: a run checks ``ladn_denoise_fused`` against
``ladn_denoise_ref`` at ``chip_smoke.py``'s phase-5 shapes, times it with
``chip_smoke.time_ms`` (CUDA-graph replay, three timings), times
``ops.ladn_denoise`` called from Python (``chip_smoke.eager_ms``) and the
host enqueue of a 50-step training episode at Table III/IV.  Where the
tree has them, it also times the library's empty kernel (the launch
floor) and the act shape at I = 1, 2, 3, 5, 9 and 16.

``flash_attention_f32``: a run holds ``flash_attention`` to the plain
version (1e-4) and times it three times (``bench.kernels.time_ms``:
CUDA-graph replay) at every f32 row of this tree's ``ATTN_SHAPES`` and
``BENCH_ATTN``, with SDPA's time on the same inputs.

Each run appends one JSON object to ``FILE``; the end prints the least of
each run's timings by shape.  Needs one card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_ladn() -> dict:
    """``ladn_denoise`` of the tree on ``sys.path``: its record."""
    import dataclasses
    import torch
    import chip_smoke as cs
    from repro_torch.core import agents as ag
    from repro_torch.core import env as envlib
    from repro_torch.core import networks as nets
    from repro_torch.core.diffusion import DiffusionSchedule
    from repro_torch.core.trainer import build_episode_fn, init_agents
    from repro_torch.kernels import build, ladn_denoise, ops, ref
    build.build(ladn_denoise.SOURCE)
    rec = {"ptxas": [
        r for r in cs.ptxas_report(build.build_info["ladn_denoise"]["ptxas"])
        if "ladn" in r["kernel"]]}
    shapes = {**cs.LADN_SHAPES, **getattr(cs, "LADN_WIDE", {})}
    if hasattr(ladn_denoise, "noop"):
        rec["floor_ms"] = [cs.time_ms(ladn_denoise.noop) for _ in range(3)]
        shapes.update({f"act_I{i}": (20, 1, i, 20, 22, 20)
                       for i in (1, 2, 3, 5, 9, 16)})
    dev = torch.device("cuda")
    for name, shape in shapes.items():
        G, T, I, A, S, H = shape  # noqa: E741
        args = cs._ladn_case(*shape)
        plain = args[:-1] + (DiffusionSchedule(
            *(torch.as_tensor(a, device=dev) for a in args[-1])),)
        got = ladn_denoise.ladn_denoise_fused(*args)
        err = (got - ref.ladn_denoise_ref(*plain)).abs().max().item()
        if not err <= cs.LADN_TOL:
            raise SystemExit(f"{name}: max abs err {err}")

        def kernel():
            return ladn_denoise.ladn_denoise_fused(*args)

        row = {"err": err, "ms": [cs.time_ms(kernel) for _ in range(3)]}
        if not name.startswith("act_I"):
            gen = torch.Generator(device=dev).manual_seed(1)
            theta = nets.init_ladn(gen, S, A, (H, H), num_agents=G,
                                   device=dev)
            with torch.no_grad():
                row["ops_eager_ms"] = cs.eager_ms(lambda: ops.ladn_denoise(
                    theta, args[0], args[1], args[2], num_steps=I))
        rec[name] = row
    # every task step runs the update, so fresh agents cost what trained
    # ones do
    p, cfg = envlib.EnvParams(), ag.AgentConfig()
    gen = torch.Generator(device=dev).manual_seed(0)
    q = dataclasses.replace(p, num_slots=1)
    episode = build_episode_fn("lad-ts", q, cfg)
    states = init_agents("lad-ts", q, cfg, gen)
    ep = envlib.sample_episode(gen, q, f=envlib.sample_capacities(gen, p))
    enqueue = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, avg = episode(states, ep, gen)
        enqueue.append((time.perf_counter() - t0) * 1e3 / q.max_tasks)
        float(avg)
    rec["task_step_enqueue_ms"] = enqueue[1:]
    return rec


def time_flash_f32(shapes: dict) -> dict:
    """f32 ``flash_attention`` of the tree on ``sys.path`` at ``shapes``
    (this tree's f32 rows): its record."""
    from repro_torch.bench import kernels as bk
    from repro_torch.kernels import flash_attention
    rec = {}
    for name, spec in shapes.items():
        B, H, KV, Sq, Skv, hd, win, off, _ = spec
        q, k, v = bk.attention_case(tuple(spec))

        def kernel():
            return flash_attention.flash_attention(q, k, v, window=win,
                                                   q_offset=off)

        want = bk.attention_plain(q, k, v, win, off)
        err = (kernel() - want).abs().max().item()
        if not err <= bk.TOL["float32"]:
            raise SystemExit(f"{name}: max abs err {err}")
        library = bk.attention_library(q, k, v, win, off)
        rec[name] = {"err": err,
                     "ms": [bk.time_ms(kernel) for _ in range(3)],
                     "sdpa_ms": [bk.time_ms(library) for _ in range(3)]}
    return rec


def run(kernel: str, tree: str, shapes: dict, out: str) -> None:
    """Time one tree's kernel in this process; appends its record."""
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import torch
    import repro_torch
    if not repro_torch.__file__.startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {repro_torch.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = (time_ladn() if kernel == "ladn_denoise"
           else time_flash_f32(shapes))
    with open(out, "a") as fh:
        fh.write(json.dumps({"tree": tree, **rec}) + "\n")


def cells(rec: dict) -> list:
    """One record's least timings, by shape."""
    out = [f"{k} {min(v['ms']):.5f}"
           + (f" (sdpa {min(v['sdpa_ms']):.5f})" if "sdpa_ms" in v else "")
           for k, v in rec.items() if isinstance(v, dict) and "ms" in v]
    if "floor_ms" in rec:
        out.insert(0, f"floor {min(rec['floor_ms']):.5f}")
    if "task_step_enqueue_ms" in rec:
        out.append(f"task step enqueue "
                   f"{min(rec['task_step_enqueue_ms']):.3f}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", required=True,
                    choices=("ladn_denoise", "flash_attention_f32"))
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--shapes", default="{}", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.run:
        run(a.kernel, a.run, json.loads(a.shapes), a.out)
        return
    shapes = {}
    if a.kernel == "flash_attention_f32":
        sys.path[:0] = [os.path.join(ROOT, "src")]
        from repro_torch.bench.kernels import ATTN_SHAPES, BENCH_ATTN
        shapes = {k: v for k, v in {**ATTN_SHAPES, **BENCH_ATTN}.items()
                  if v[8] == "float32"}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    parent = os.path.abspath(a.parent)
    start = sum(1 for _ in open(a.out)) if os.path.exists(a.out) else 0
    for tree in (parent, ROOT, ROOT, parent):
        cmd = [sys.executable, os.path.abspath(__file__), "--kernel",
               a.kernel, "--parent", parent, "--out", a.out, "--run", tree,
               "--shapes", json.dumps(shapes)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=900)
        label = "parent" if tree == parent else "this"
        print(f"== {label}: exit {res.returncode}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if res.returncode:
            print(res.stdout[-2000:], res.stderr[-4000:], flush=True)
            sys.exit(1)
    with open(a.out) as fh:
        for line in list(fh)[start:]:
            rec = json.loads(line)
            label = "parent" if rec["tree"] == parent else "this"
            print(f"{label}: {card}: " + ", ".join(cells(rec)), flush=True)


if __name__ == "__main__":
    main()
