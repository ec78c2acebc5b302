"""The reference's per-architecture train smoke test on the port (one
step of every arch's reduced config: finite, loss > 0, params moved), and
the training launcher on the CPU writing a checkpoint that the reference
restores."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from _torch_train import one_thread
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models.transformer import init_params as jax_init_params
from repro.train import optimizer as jopt
from repro.train.checkpoint import restore_checkpoint as jax_restore
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.convert import params_to_jax
from repro_torch.core.optim import tree_leaves
from repro_torch.launch import train as train_launcher
from repro_torch.models.transformer import forward, init_params
from repro_torch.train import optimizer as opt
from repro_torch.train.steps import make_train_step

_one_thread = pytest.fixture(autouse=True)(one_thread)

B, S = 2, 48


def _batch(cfg, rng):
    """The reference's smoke batch: random tokens, next-token labels and,
    for vision configs, patches in front of the text with the loss masked
    to the text."""
    text = S - cfg.vision_patches
    out = {}
    if cfg.vision_patches:
        out["patches"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.vision_patches, cfg.vision_dim)).astype(np.float32))
    if cfg.num_codebooks:
        toks = rng.integers(0, cfg.vocab_size,
                            (B, cfg.num_codebooks, text + 1))
        out["tokens"] = torch.from_numpy(toks[..., :-1].astype(np.int32))
        out["labels"] = torch.from_numpy(toks[..., 1:].astype(np.int32))
        return out
    toks = rng.integers(0, cfg.vocab_size, (B, text + 1)).astype(np.int32)
    out["tokens"] = torch.from_numpy(toks[:, :-1])
    if cfg.vision_patches:
        lab = np.zeros((B, S), np.int32)
        lab[:, cfg.vision_patches:] = toks[:, 1:]
        mask = np.zeros((B, S), np.float32)
        mask[:, cfg.vision_patches:] = 1.0
        out["labels"], out["mask"] = (torch.from_numpy(lab),
                                      torch.from_numpy(mask))
    else:
        out["labels"] = torch.from_numpy(toks[:, 1:])
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_train_step(arch):
    cfg = reduced(get_config(arch))
    cfg = dataclasses.replace(cfg, vision_patches=16 if cfg.vision_patches
                              else 0)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    step = make_train_step(cfg, opt.AdamWConfig(learning_rate=1e-3,
                                                warmup_steps=1,
                                                total_steps=10))
    batch = _batch(cfg, np.random.default_rng(0))
    new, _, metrics = step(params, opt.init(params), batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0, arch
    moved = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree_leaves(params), tree_leaves(new)))
    assert moved > 0
    for leaf in tree_leaves(new):
        assert bool(torch.isfinite(leaf.float()).all()), arch
        assert not leaf.requires_grad
    with torch.no_grad():
        h = forward(new, cfg, batch, mode="train")["hidden"]
    assert h.shape == (B, S, cfg.d_model)


def test_launcher_trains_and_writes_a_checkpoint_the_reference_restores(
        tmp_path, capsys):
    path = os.path.join(tmp_path, "ckpt.npz")
    out = train_launcher.main(["--arch", "qwen2-1.5b", "--smoke", "--steps",
                               "3", "--batch", "2", "--seq-len", "32",
                               "--log-every", "1", "--device", "cpu",
                               "--checkpoint", path])
    log = capsys.readouterr().out
    assert log.count("[train] step") == 3 and "tokens/s" in log
    assert len(out["losses"]) == 3 and np.isfinite(out["eval_loss"])
    jcfg = jax_reduced(jax_get_config("qwen2-1.5b"))
    like = jax_init_params(jax.random.key(1), jcfg)
    params, state, step = jax_restore(path, like, jopt.init(like))
    assert step == 3 and int(state.step) == 3
    tcfg = reduced(get_config("qwen2-1.5b"))
    want = params_to_jax(out["params"], tcfg, "flat")
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_launcher_trains_a_moe_config_on_the_smoke_mesh(capsys):
    """``--mesh smoke``: the 1 x 1 mesh's one-rank gloo group on the CPU,
    where a MoE config's layers take the sharded path."""
    from repro_torch.models import moe
    moe.reset_collectives()
    out = train_launcher.main(["--arch", "mixtral-8x22b", "--smoke",
                               "--steps", "2", "--batch", "2", "--seq-len",
                               "16", "--mesh", "smoke", "--device", "cpu"])
    assert all(np.isfinite(x) for x in out["losses"])
    assert moe.collectives["all_reduce"] > 0
    assert out["peak_bytes"] is None
