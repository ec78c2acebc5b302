"""Training launcher of the port.

Port of ``repro/launch/train.py``: random weights from seed 0, the
synthetic pipeline (``repro_torch.data.pipeline``), AdamW with a warm-up
of a tenth of the steps, and the reference's log lines, plus tokens/s, the
card's peak memory and an eval loss on a held-out batch:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --smoke --steps 20 --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given.  ``--smoke`` trains
the reduced config; without it the published width, depth and dtype.
``--mesh smoke`` runs inside the one-rank 1 x 1 ``("data", "model")``
mesh (``launch.mesh.make_smoke_mesh``: NCCL on the card) on placed
params (``launch.sharding.place_params``), where every layer takes its
mesh path; a job of several ranks builds its mesh with
``make_production_mesh`` and calls the same steps (``train.steps``).
``--checkpoint PATH`` writes the final params and optimizer state in the
reference's format.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models.transformer import init_params
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.steps import make_eval_step, make_train_step

EVAL_STEP = 999     # the held-out batch the reference's loss test takes


def main(argv: Optional[List[str]] = None) -> dict:
    """Train; returns {"losses" (the logged steps' losses), "first_loss",
    "eval_loss", "tokens_per_s", "peak_bytes" (None off the card),
    "params", "opt_state"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", choices=["none", "smoke"], default="none")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    if cfg.vision_patches and args.seq_len <= cfg.vision_patches:
        args.seq_len = cfg.vision_patches + 64
    opt_cfg = opt_lib.AdamWConfig(learning_rate=args.lr,
                                  warmup_steps=max(args.steps // 10, 1),
                                  total_steps=args.steps)
    dc = DataConfig(batch=args.batch, seq_len=args.seq_len)
    mesh = make_smoke_mesh(dev) if args.mesh == "smoke" else None
    ctx = sharding.ShardingContext(mesh) if mesh is not None else None

    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    if mesh is not None:
        params = sharding.place_params(mesh, params, cfg)
    opt_state = opt_lib.init(params)
    step_fn = make_train_step(cfg, opt_cfg)
    n_params = sum(p.numel() for p in opt_lib.tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"batch={dc.batch} seq={dc.seq_len} on {dev}", flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    losses = []
    with sharding.use(ctx):
        t_start = time.time()
        for step in range(args.steps):
            batch = synth_batch(cfg, dc, step, dev)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])
                losses.append(loss)
                print(f"[train] step {step:4d} loss={loss:8.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.2f} "
                      f"({time.time() - t_start:.1f}s)", flush=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elapsed = time.time() - t_start
        held_out = synth_batch(cfg, dc, max(EVAL_STEP, args.steps), dev)
        eval_loss = float(make_eval_step(cfg)(params, held_out))
    tokens_per_s = args.steps * dc.batch * dc.seq_len / max(elapsed, 1e-9)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    print(f"[train] eval loss={eval_loss:8.4f}; {tokens_per_s:.1f} tokens/s"
          + ("" if peak is None else
             f", peak memory {peak / 2 ** 30:.2f} GiB"), flush=True)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, cfg, opt_state, args.steps,
                        mesh=mesh)
        print(f"[train] saved {args.checkpoint}")
    return {"losses": losses, "first_loss": losses[0] if losses else None,
            "eval_loss": eval_loss, "tokens_per_s": tokens_per_s,
            "peak_bytes": peak, "params": params, "opt_state": opt_state}


if __name__ == "__main__":
    main()
