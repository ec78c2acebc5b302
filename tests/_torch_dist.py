"""Multi-rank runs for the port's tests: ``world`` CPU processes on the
``gloo`` backend, joined through a ``FileStore`` under the test's
``tmp_path``, each running one of the rank functions below.  The ranks
import torch and the port only; the reference's side of a comparison is
computed in the test process and handed over in files."""
from __future__ import annotations

import contextlib
import faulthandler
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 180.0):
    """``fn(rank, *args)`` on ``world`` spawned ranks; raises if a rank
    fails or the ranks outlive ``timeout`` seconds (then they are
    killed)."""
    with ranks_running(fn, world, tmp_path, *args, timeout=timeout):
        pass


@contextlib.contextmanager
def ranks_running(fn, world: int, tmp_path, *args, timeout: float = 180.0):
    """:func:`run_ranks` around the ``with`` body: the ranks start on
    entry, the body runs in the test process meanwhile, and the exit
    waits for them (raising as :func:`run_ranks` does)."""
    store = os.path.join(str(tmp_path), "store")
    ctx = mp.start_processes(_entry, args=(fn, world, store, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        yield
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
    # a rank that has finished leaves without the interpreter's teardown,
    # where a gloo thread has aborted a finished rank ("terminate called
    # without an active exception" after its work and the barrier)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


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
    inside the mesh's context, every rank holding its placed blocks of
    the params and the whole batch; writes the gradients and the new
    params, gathered whole and flattened in leaf order, to
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
        mesh = meshes[shape]
        params = sharding.place_params(mesh, params, cfg)
        with sharding.use(sharding.ShardingContext(mesh)):
            grads, _ = make_grad_step(cfg)(params, batch)
            new, _, metrics = make_train_step(
                cfg, opt.AdamWConfig(**opt_kw))(params, opt.init(params),
                                                batch)
        grads = sharding.unplace_params(mesh, grads, cfg)
        new = sharding.unplace_params(mesh, new, cfg)
        blobs = {f"g{i}": g.numpy() for i, g in enumerate(tree_leaves(grads))}
        blobs.update({f"p{i}": p.numpy()
                      for i, p in enumerate(tree_leaves(new))})
        np.savez(os.path.join(out_dir, f"{name}.{rank}.npz"),
                 loss=float(metrics["loss"]), **blobs)


def _mesh_of(meshes: dict, shape):
    from repro_torch.launch.mesh import make_production_mesh
    if shape not in meshes:
        meshes[shape] = make_production_mesh(shape=shape,
                                             axes=("data", "model"),
                                             device="cpu")
    return meshes[shape]


def _flat(tree, prefix: str = "") -> dict:
    """``{path: numpy array}`` of a tree of tensors (dicts and lists)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree.detach().numpy()}


def placement_rank(rank: int, cases, out_dir: str) -> None:
    """For each (name, cfg, params file, mesh shape, slots, max_len)
    case: this rank's ``place_params`` blocks, whether
    ``unplace_params`` gives the params back exactly, and this rank's
    ``place_states`` block of a dense slot pool of ``slots`` x
    ``max_len``, written to ``out_dir/<name>.<rank>.npz`` (leaves under
    ``p:<path>`` and ``s:<path>``)."""
    from repro_torch.launch import sharding
    from repro_torch.models.transformer import init_layer_states
    meshes = {}
    for name, cfg, params_file, shape, slots, max_len in cases:
        params = torch.load(params_file, weights_only=True)
        mesh = _mesh_of(meshes, shape)
        placed = sharding.place_params(mesh, params, cfg)
        back = sharding.unplace_params(mesh, placed, cfg)
        same = all(np.array_equal(a, b) for a, b in
                   zip(_flat(back).values(), _flat(params).values()))
        pool = sharding.place_states(mesh, init_layer_states(
            cfg, slots, max_len, torch.device("cpu")))
        blobs = {f"p:{k}": v for k, v in _flat(placed).items()}
        blobs.update({f"s:{k}": v for k, v in _flat(pool).items()})
        np.savez(os.path.join(out_dir, f"{name}.{rank}.npz"),
                 roundtrip=same, **blobs)


def placement_serve_rank(rank: int, cases, out_dir: str) -> None:
    """For each (name, cfg, params file, mesh shape, prompts, n_new,
    engine keywords) case: a ``ServeEngine`` on the rank's placed
    params, its greedy tokens of ``generate(prompts, n_new)`` (n_new, B,
    ...), its KV left held, prefix hits and placement report, and the
    first prompt's prefill last logits through the mesh's forward,
    written to ``out_dir/<name>.<rank>.npz`` (the report as JSON); a
    paged engine adds the pages and bytes of its pool and the (src, dst)
    pages of its copy-on-write forks."""
    from repro_torch.launch import sharding
    from repro_torch.models.transformer import forward
    from repro_torch.serving.engine import ServeEngine
    meshes = {}
    for name, cfg, params_file, shape, prompts, n_new, kw in cases:
        params = torch.load(params_file, weights_only=True)
        mesh = _mesh_of(meshes, shape)
        eng = ServeEngine(cfg, params, device="cpu", mesh=mesh, **kw)
        copies = []
        if eng.paged and eng._page_copy is not None:
            copy = eng._page_copy

            def logged(states, src, dst, _copy=copy):
                copies.append((src, dst))
                return _copy(states, src, dst)

            eng._page_copy = logged
        res = eng.generate(np.asarray(prompts, np.int32), n_new)
        pool = {}
        if eng.paged:
            pool = dict(pool_pages=eng._paged_states[0]["k_pages"].shape[0],
                        pool_bytes=sum(t.numel() * t.element_size()
                                       for layer in eng._paged_states
                                       for t in layer.values()),
                        copies=np.asarray(copies, np.int64).reshape(-1, 2))
        toks = np.stack([np.asarray(t) for t in res.tokens])
        with sharding.use(sharding.ShardingContext(mesh)):
            logits = forward(eng.params, cfg,
                             {"tokens": torch.from_numpy(
                                 np.asarray(prompts[:1], np.int32))},
                             mode="prefill",
                             max_len=kw.get("max_len"))["last_logits"]
        np.savez(os.path.join(out_dir, f"{name}.{rank}.npz"),
                 tokens=toks, logits=logits.numpy(), kv_leak=eng.kv_leak,
                 prefix_hits=eng.prefix_hits,
                 report=json.dumps(eng.placement_report()), **pool)


def checkpoint_rank(rank: int, cfg, params_file: str, batch_file: str,
                    opt_kw: dict, out_dir: str) -> None:
    """One train step on the (2, 2) mesh from its placed params, saved
    with ``save_checkpoint(mesh=...)`` to ``out_dir/ckpt.npz``; then that
    file restored onto the (4, 1) mesh's placed blocks, gathered whole
    and written (params, AdamW moments, step) to
    ``out_dir/restored.<rank>.npz``."""
    from repro_torch.core.optim import tree_leaves
    from repro_torch.launch import sharding
    from repro_torch.train import optimizer as opt
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.steps import make_train_step
    meshes = {}
    whole = torch.load(params_file, weights_only=True)
    batch = torch.load(batch_file, weights_only=True)
    mesh = _mesh_of(meshes, (2, 2))
    params = sharding.place_params(mesh, whole, cfg)
    with sharding.use(sharding.ShardingContext(mesh)):
        params, state, _ = make_train_step(cfg, opt.AdamWConfig(**opt_kw))(
            params, opt.init(params), batch)
    path = os.path.join(out_dir, "ckpt.npz")
    save_checkpoint(path, params, cfg, state, step=1, mesh=mesh)
    dist.barrier()
    other = _mesh_of(meshes, (4, 1))
    like = sharding.place_params(other, whole, cfg)
    got, got_state, step = restore_checkpoint(path, like, cfg,
                                              opt.init(like), mesh=other)
    back = sharding.unplace_params(other, got, cfg)
    mu = sharding.unplace_params(other, got_state.mu, cfg)
    np.savez(os.path.join(out_dir, f"restored.{rank}.npz"), step=step,
             **{f"p{i}": p.numpy() for i, p in enumerate(tree_leaves(back))},
             **{f"m{i}": p.numpy() for i, p in enumerate(tree_leaves(mu))})


def each(rank: int, calls) -> None:
    """Every ``(fn, args)`` of ``calls`` on this rank in turn:
    ``fn(rank, *args)``."""
    for fn, args in calls:
        fn(rank, *args)


def recurrent_block_rank(rank: int, cases, out_dir: str) -> None:
    """For each (name, cfg, inputs file, mesh shape) case: ``cfg``'s layer
    0 mixer (RG-LRU or mLSTM) on this rank's ``place_params`` block of
    the file's params, inside the mesh's context and with no gradient:
    the prompt's scan (RG-LRU: the time loop and the prefix scan) and
    one decode step from the file's whole state, placed by
    ``state_pspecs`` with the batch whole.  Writes the outputs and this
    rank's states to ``out_dir/<name>.<rank>.npz``."""
    from repro_torch.launch import sharding
    from repro_torch.models import rglru, xlstm
    meshes = {}
    for name, cfg, inputs, shape in cases:
        data = np.load(inputs)
        p = {k[2:]: torch.from_numpy(data[k]) for k in data.files
             if k.startswith("p:")}
        st = {k[2:]: torch.from_numpy(data[k]) for k in data.files
              if k.startswith("s:")}
        mesh = _mesh_of(meshes, shape)
        placed = sharding.place_params(mesh, {"mixer": p}, cfg)["mixer"]
        spec = sharding.state_pspecs([st], mesh, batch_axes=None)
        st = sharding.place_states(mesh, [st], spec)[0]
        x, xt = (torch.from_numpy(data[k]) for k in ("x", "xt"))
        out = {}
        with torch.no_grad(), sharding.use(sharding.ShardingContext(mesh)):
            if cfg.layer_pattern()[0].mixer == "rglru":
                y, s = rglru.rglru_scan(placed, cfg, x)
                ya, sa = rglru.rglru_scan(placed, cfg, x,
                                          use_assoc_scan=True)
                out.update(assoc=ya.numpy(), assoc_h=sa["h"].numpy())
                y1, s1 = rglru.rglru_step(placed, cfg, xt, st)
            else:
                y, s = xlstm.mlstm_scan(placed, cfg, x)
                y1, s1 = xlstm.mlstm_step(placed, cfg, xt, st)
        out.update(scan=y.numpy(), step=y1.numpy(),
                   **{f"scan_{k}": v.numpy() for k, v in s.items()},
                   **{f"step_{k}": v.numpy() for k, v in s1.items()})
        np.savez(os.path.join(out_dir, f"{name}.{rank}.npz"), **out)


def dry_count_rank(rank: int, cases, out_dir: str) -> None:
    """For each (name, cfg, shape) case: rank 0's program of the dry run
    (``launch.dryrun.rank_program``) on this real gloo mesh, on real
    tensors of the dry run's shapes (zeros) and with the loop shortcut
    off, under the counting pass; rank 0 writes its collective tallies
    and its placed params' bytes to ``out_dir/<name>.json``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun, sharding, specs
    from repro_torch.roofline import analysis as ra
    from repro_torch.train.optimizer import AdamWState
    meshes = {}

    def real(tree):
        if isinstance(tree, torch.Tensor):
            return torch.zeros(tree.shape, dtype=tree.dtype)
        if isinstance(tree, AdamWState):
            return AdamWState(*(real(t) for t in tree))
        if isinstance(tree, dict):
            return {k: real(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(real(v) for v in tree)
        return tree

    for name, cfg, shape, mesh_shape in cases:
        mesh = _mesh_of(meshes, mesh_shape)
        fake = FakeTensorMode()
        args, kwargs, _ = specs.input_specs(cfg, shape, specs.MeshShape(
            ("data", "model"), mesh_shape), fake)
        args = real(args)
        placed = sharding.place_params(mesh, args[0], cfg)
        held = []
        sharding._walk(placed, lambda _, t: held.append(
            t.numel() * t.element_size()))
        step, args = dryrun.rank_program(cfg, shape, mesh, args)
        _, tallies = ra.count_ops(step, *args, shortcut=False, **kwargs)
        if rank == 0:
            with open(os.path.join(out_dir, f"{name}.json"), "w") as fh:
                json.dump({"collectives": {k: v for k, v in tallies.items()
                                           if k.startswith("c10d.")},
                           "placed_bytes": sum(held)}, fh)
