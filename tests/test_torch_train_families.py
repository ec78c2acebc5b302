"""One port train step against the reference's for the MoE (mixtral,
one routing group), codebook (musicgen) and patch (llava, 16 patches)
families, as ``test_torch_train_step.py`` holds the others; microbatched
accumulation against one batch; and the reference's end-to-end check
that a reduced qwen2-1.5b's loss falls over 40 steps."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_train import check_one_step, one_thread, train_case
from repro_torch.core.optim import tree_leaves
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.models.transformer import init_params
from repro_torch.train import optimizer as opt
from repro_torch.train.steps import (make_eval_step, make_grad_step,
                                     make_train_step, microbatches)

_one_thread = pytest.fixture(autouse=True)(one_thread)

CASES = {"mixtral": "mixtral-8x22b", "musicgen": "musicgen-large",
         "llava": "llava-next-mistral-7b"}


@pytest.mark.parametrize("case", list(CASES))
def test_one_train_step_matches_the_reference(case):
    check_one_step(CASES[case], {})


@pytest.mark.parametrize("arch,k", [("qwen2-1.5b", 2), ("qwen2-1.5b", 4),
                                    ("llava-next-mistral-7b", 2)])
def test_microbatches_accumulate_to_the_whole_batch(arch, k):
    """k microbatches (f32 accumulation, divided by k) give the one-batch
    loss and gradients; the count follows the reference's rule."""
    _, tcfg, _, tp, _, tb = train_case(arch, batch=4)
    split = dataclasses.replace(tcfg, microbatches=k)
    assert microbatches(split, 4) == k and microbatches(split, 3) == (
        1 if k == 2 else 3)
    g1, m1 = make_grad_step(tcfg)(tp, tb)
    gk, mk = make_grad_step(split)(tp, tb)
    np.testing.assert_allclose(float(mk["total_loss"]),
                               float(m1["total_loss"]), rtol=1e-6)
    for a, b in zip(tree_leaves(gk), tree_leaves(g1)):
        assert a.dtype == torch.float32
        scale = max(float(b.abs().max()), 1e-12)
        assert float((a - b).abs().max()) <= 1e-5 * scale


def test_training_reduces_loss():
    """The reference's test_system check on the port: 40 steps of reduced
    qwen2-1.5b, the eval loss of a held-out batch 0.2 below the first."""
    _, cfg, _, _, _, _ = train_case("qwen2-1.5b")
    dc = DataConfig(batch=4, seq_len=64)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    state = opt.init(params)
    step = make_train_step(cfg, opt.AdamWConfig(
        learning_rate=3e-3, warmup_steps=2, total_steps=40,
        weight_decay=0.0))
    first = None
    for s in range(40):
        params, state, m = step(params, state, synth_batch(cfg, dc, s, "cpu"))
        if first is None:
            first = float(m["loss"])
    final = float(make_eval_step(cfg)(params,
                                      synth_batch(cfg, dc, 999, "cpu")))
    assert final < first - 0.2, (first, final)


def test_eval_step_takes_no_gradient():
    _, tcfg, _, tp, _, tb = train_case("qwen2-1.5b")
    leaf = tp["layers"][0]["mixer"]["wq"].requires_grad_()
    loss = make_eval_step(tcfg)(tp, tb)
    leaf.requires_grad_(False)
    assert loss.grad_fn is None and loss.dim() == 0
