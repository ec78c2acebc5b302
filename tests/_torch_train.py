"""Helpers shared by the port's training tests: one reference train step
on converted parameters and the comparisons of gradient and parameter
trees (the reference's through ``params_from_jax``)."""
from __future__ import annotations


import jax
import numpy as np
import torch

from _torch_parity import CPU, configs, params_pair
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import synth_batch as jax_synth_batch
from repro.models.transformer import forward as jax_forward
from repro.train import optimizer as jopt
from repro.train.losses import chunked_ce_loss as jax_ce
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.convert import params_from_jax
from repro_torch.core.optim import tree_leaves
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.train import optimizer as opt
from repro_torch.train.steps import make_grad_step, make_train_step

# eps 1e-4, not the default 1e-8: at 1e-8 Adam's first update is
# lr * g / |g| to within eps, which turns gradient entries at float-noise
# level (the key bias's gradient is zero in exact arithmetic) into +-lr
# steps of either sign; at 1e-4 the update is a smooth function of the
# gradient, so comparing updated params checks the step, not that noise.
# The optimizer alone is held to the reference at the default eps
# (test_torch_losses_optim.py).
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, eps=1e-4)


def train_case(arch: str, batch: int = 2, seq_len: int = 32, **overrides):
    """(jcfg, tcfg, jparams, tparams, jax batch, port batch) of a reduced
    ``arch`` (vision configs with 16 patches in front of the text)."""
    jcfg, tcfg = configs(arch=arch, **overrides)
    if tcfg.vision_patches:
        seq_len += tcfg.vision_patches
    jp, tp = params_pair(jcfg, tcfg)
    jb = jax_synth_batch(jcfg, JDataConfig(batch=batch, seq_len=seq_len), 0)
    tb = synth_batch(tcfg, DataConfig(batch=batch, seq_len=seq_len), 0,
                     "cpu")
    return jcfg, tcfg, jp, tp, jb, tb


def reference_step(jcfg, jp, jb, opt_kw=OPT):
    """The reference's (total loss, grads, new params, metrics) of one
    step: ``jax.value_and_grad`` of its loss, and its train step."""
    def loss_fn(p):
        out = jax_forward(p, jcfg, jb, mode="train")
        return jax_ce(p, jcfg, out["hidden"], jb["labels"],
                      jb.get("mask")) + out["aux"]

    total, grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    step = jax.jit(jax_make_train_step(jcfg, jopt.AdamWConfig(**opt_kw)))
    new, _, metrics = step(jp, jopt.init(jp), jb)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return float(total), np_(grads), np_(new), {k: float(v) for k, v
                                                in metrics.items()}


def port_state(params):
    return opt.init(params), opt.AdamWConfig(**OPT)


def assert_close_trees(got, want_np, tcfg, rtol: float):
    """Port tree ``got`` against the reference's numpy tree: per leaf,
    max |a - b| within ``rtol`` of max |b| (and of 1e-12 for zero
    leaves)."""
    want = params_from_jax(want_np, tcfg, CPU)
    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.shape == b.shape
        err = float((a.float() - b.float()).abs().max())
        scale = max(float(b.float().abs().max()), 1e-12)
        worst = max(worst, err / scale)
    assert worst <= rtol, worst


def one_thread():
    """Pin torch to one intra-op thread (a generator for a fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check_one_step(arch: str, overrides: dict) -> None:
    """One step of ``arch`` on the reference and the port: total loss
    within 1e-5, gradients, metrics and new params within 1e-4."""
    jcfg, tcfg, jp, tp, jb, tb = train_case(arch, **overrides)
    total, grads, new, metrics = reference_step(jcfg, jp, jb)
    g, m = make_grad_step(tcfg)(tp, tb)
    np.testing.assert_allclose(float(m["total_loss"]), total, rtol=1e-5)
    assert_close_trees(g, grads, tcfg, 1e-4)
    state, ocfg = port_state(tp)
    got, state, tm = make_train_step(tcfg, ocfg)(tp, state, tb)
    for k in ("loss", "aux_loss", "total_loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), metrics[k], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert int(state.step) == 1
    assert_close_trees(got, new, tcfg, 1e-4)
