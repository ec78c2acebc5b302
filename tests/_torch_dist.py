"""Multi-rank runs for the port's tests: ``world`` CPU processes on the
``gloo`` backend, joined through a ``FileStore`` under the test's
``tmp_path``, each running one of the rank functions below.  The ranks
import torch and the port only; the reference's side of a comparison is
computed in the test process and handed over in files."""
from __future__ import annotations

import faulthandler
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 180.0):
    """``fn(rank, *args)`` on ``world`` spawned ranks; raises if a rank
    fails or the ranks outlive ``timeout`` seconds (then they are
    killed)."""
    store = os.path.join(str(tmp_path), "store")
    ctx = mp.start_processes(_entry, args=(fn, world, store, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


def _entry(rank: int, fn, world: int, store: str, args) -> None:
    faulthandler.enable()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        fn(rank, *args)
        # no rank tears its connections down while another still uses them
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------


def moe_paths_rank(rank: int, cases, out_dir: str) -> None:
    """For each (name, cfg, inputs file, mesh shape, stationary) case: this
    rank's ``place_params`` slice of the experts, ``apply_moe`` inside the
    mesh's context, and the collectives it issued, written to
    ``out_dir/<name>.<rank>.npz``."""
    import dataclasses
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import moe
    meshes = {}
    for name, cfg, inputs, shape, stationary in cases:
        data = np.load(inputs)
        p = {k: torch.from_numpy(data[k]) for k in
             ("router", "we_up", "we_down", "we_gate") if k in data}
        x = torch.from_numpy(data["x"])
        if shape not in meshes:
            meshes[shape] = make_production_mesh(
                shape=shape, axes=("data", "model"), device="cpu")
        mesh = meshes[shape]
        mine = sharding.place_params(mesh, {"layers": [{"ffn": p}]},
                                     cfg)["layers"][0]["ffn"]
        cfg = dataclasses.replace(cfg, moe_stationary_serve=stationary)
        moe.reset_collectives()
        with sharding.use(sharding.ShardingContext(mesh)):
            out, aux = moe.apply_moe(mine, cfg, x)
        np.savez(os.path.join(out_dir, f"{name}.{rank}.npz"),
                 out=out.numpy(), aux=aux.numpy(),
                 block=mine["we_up"].numpy(),
                 all_reduce=moe.collectives["all_reduce"],
                 all_gather=moe.collectives["all_gather"])


def engine_rank(rank: int, cfg, params_file: str, shape, prompts,
                n_new: int, out_dir: str, engine_kw: dict) -> None:
    """One engine of ``cfg`` per rank on a ``shape`` mesh; the greedy
    tokens of ``generate(prompts (B, S), n_new)``, (n_new, B), written to
    ``out_dir/tokens.<rank>.json``."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.serving.engine import ServeEngine
    params = torch.load(params_file, weights_only=True)
    mesh = make_production_mesh(shape=shape, axes=("data", "model"),
                                device="cpu")
    eng = ServeEngine(cfg, params, device="cpu", mesh=mesh, **engine_kw)
    res = eng.generate(np.asarray(prompts, np.int32), n_new)
    toks = np.stack([np.asarray(t) for t in res.tokens]).tolist()
    with open(os.path.join(out_dir, f"tokens.{rank}.json"), "w") as fh:
        json.dump({"tokens": toks, "kv_leak": eng.kv_leak}, fh)


def moe_grads_rank(rank: int, cases, out_dir: str) -> None:
    """For each (name, cfg, inputs file, mesh shape, stationary, placed)
    case: ``apply_moe`` inside the mesh's context on inputs that need a
    gradient, then the backward of ``sum(out * w) + c * aux`` (``w`` and
    ``c`` from the file).  The experts are this rank's ``place_params``
    block when ``placed``, else the whole (E, d, f) stacks.  Writes the
    gradients of x, the router and the expert weights (as held), and the
    forward's collective counts, to ``out_dir/<name>.<rank>.npz``."""
    import dataclasses
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import moe
    meshes = {}
    for name, cfg, inputs, shape, stationary, placed in cases:
        data = np.load(inputs)
        p = {k: torch.from_numpy(data[k]) for k in
             ("router", "we_up", "we_down", "we_gate") if k in data}
        if shape not in meshes:
            meshes[shape] = make_production_mesh(
                shape=shape, axes=("data", "model"), device="cpu")
        mesh = meshes[shape]
        if placed:
            p = sharding.place_params(mesh, {"layers": [{"ffn": p}]},
                                      cfg)["layers"][0]["ffn"]
        p = {k: v.clone().requires_grad_() for k, v in p.items()}
        x = torch.from_numpy(data["x"]).requires_grad_()
        cfg = dataclasses.replace(cfg, moe_stationary_serve=stationary)
        moe.reset_collectives()
        with sharding.use(sharding.ShardingContext(mesh)):
            out, aux = moe.apply_moe(p, cfg, x)
        counts = dict(moe.collectives)
        loss = (out * torch.from_numpy(data["w"])).sum() + float(
            data["c"]) * aux
        loss.backward()
        np.savez(os.path.join(out_dir, f"{name}.{rank}.npz"),
                 out=out.detach().numpy(), x=x.grad.numpy(),
                 **{k: v.grad.numpy() for k, v in p.items()}, **counts)


def train_step_rank(rank: int, cases, out_dir: str) -> None:
    """For each (name, cfg, params file, batch file, mesh shape, AdamW
    keywords) case: the port's ``make_grad_step`` and ``make_train_step``
    inside the mesh's context, every rank holding the whole params;
    writes the gradients and the new params, flattened in leaf order, to
    ``out_dir/<name>.<rank>.npz``."""
    from repro_torch.core.optim import tree_leaves
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import optimizer as opt
    from repro_torch.train.steps import make_grad_step, make_train_step
    meshes = {}
    for name, cfg, params_file, batch_file, shape, opt_kw in cases:
        params = torch.load(params_file, weights_only=True)
        batch = torch.load(batch_file, weights_only=True)
        if shape not in meshes:
            meshes[shape] = make_production_mesh(
                shape=shape, axes=("data", "model"), device="cpu")
        with sharding.use(sharding.ShardingContext(meshes[shape])):
            grads, _ = make_grad_step(cfg)(params, batch)
            new, _, metrics = make_train_step(
                cfg, opt.AdamWConfig(**opt_kw))(params, opt.init(params),
                                                batch)
        blobs = {f"g{i}": g.numpy() for i, g in enumerate(tree_leaves(grads))}
        blobs.update({f"p{i}": p.numpy()
                      for i, p in enumerate(tree_leaves(new))})
        np.savez(os.path.join(out_dir, f"{name}.{rank}.npz"),
                 loss=float(metrics["loss"]), **blobs)
