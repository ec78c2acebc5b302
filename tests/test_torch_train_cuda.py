"""Training on the card (``chip_smoke.py`` phase 21a at a reduced width):
one train step's loss and gradients on ``cuda``, where attention's
forward is the CUDA kernel and its backward the plain chunked attention,
against the same step on the CPU's plain path; the kernel inside the
autograd Function against ``ops.flash_attention`` under ``no_grad``, bit
for bit; and the direct wrapper refusing inputs that need a gradient.
Imports no JAX, so it runs on the GPU machine:
``python3 -m pytest -q -m cuda tests/test_torch_train_cuda.py``."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.optim import tree_leaves, tree_map
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.kernels import ops
from repro_torch.models.transformer import init_params
from repro_torch.train.steps import make_grad_step


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_cuda_train_step_grads_match_the_cpu(remat):
    """Reduced qwen2-1.5b (2 layers, f32), batch 4 in 2 microbatches:
    loss within 1e-4 and every gradient within 1e-3 of its leaf's largest
    entry; ``flash_attention`` launched layers x microbatches times, twice
    that with remat (the checkpointed forward runs again in the
    backward)."""
    dev = _needs_card()
    cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")),
                              microbatches=2, remat=remat)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    batch = synth_batch(cfg, DataConfig(batch=4, seq_len=128), 0, dev)
    ops.reset_launches()
    grads, metrics = make_grad_step(cfg)(params, batch)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == 2 * 2 * (2 if remat else 1)
    cpu = torch.device("cpu")
    want_g, want = make_grad_step(cfg)(
        tree_map(lambda t: t.to(cpu), params),
        {k: v.to(cpu) for k, v in batch.items()})
    got, ref = float(metrics["total_loss"]), float(want["total_loss"])
    assert abs(got - ref) <= 1e-4 * abs(ref)
    for a, b in zip(tree_leaves(grads), tree_leaves(want_g)):
        scale = max(b.abs().max().item(), 1e-12)
        assert (a.cpu() - b).abs().max().item() <= 1e-3 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_function_forward_is_the_kernel(dtype):
    """The Function's forward is the kernel's output bit for bit; its
    gradient is the plain chunked attention's; the direct wrapper raises
    on inputs that need a gradient while grad mode is on."""
    dev = _needs_card()
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
               .transpose(1, 2) for s in ((2, 96, 8, 64), (2, 96, 2, 64),
                                         (2, 96, 2, 64)))
    with torch.no_grad():
        want = ops.flash_attention(q, k, v, window=40)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    ops.reset_launches()
    got = ops.flash_attention_grad(*leaves, window=40)
    assert ops.launches["flash_attention"] == 1
    assert got.grad_fn is not None
    assert torch.equal(got.detach(), want)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(*leaves, window=40)
    w = torch.randn(got.shape, generator=gen, device=dev).to(dtype)
    grads = torch.autograd.grad((got.float() * w.float()).sum(), leaves)
    plain = [t.detach().float().requires_grad_() for t in (q, k, v)]
    from repro_torch.kernels import ref
    out = ref.attention_ref(*plain, window=40)
    want_g = torch.autograd.grad((out * w.float()).sum(), plain)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for a, b in zip(grads, want_g):
        scale = b.abs().max().item()
        assert (a.float() - b).abs().max().item() <= tol * scale
