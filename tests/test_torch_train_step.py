"""One port train step against the reference's, per block family: the
total loss within 1e-5, the gradients (``jax.value_and_grad`` of the
reference's loss, through ``params_from_jax``) and the updated params
within 1e-4 of the largest entry per leaf.  Reduced configs in f32 (2
layers, d 256).  Also the RG-LRU recurrence's grad-safe loop and the
flash-attention autograd Function's plumbing on the CPU."""
import numpy as np
import pytest
import torch

from _torch_train import check_one_step, one_thread, train_case
from repro_torch.kernels import ops, ref
from repro_torch.models import rglru

_one_thread = pytest.fixture(autouse=True)(one_thread)

CASES = {"qwen2": ("qwen2-1.5b", {}),
         "recurrentgemma_loop": ("recurrentgemma-9b", {}),
         "recurrentgemma_assoc": ("recurrentgemma-9b",
                                  {"use_assoc_scan": True}),
         "xlstm": ("xlstm-350m", {})}


@pytest.mark.parametrize("case", list(CASES))
def test_one_train_step_matches_the_reference(case):
    check_one_step(*CASES[case])


def test_rglru_scan_grad_loop_matches_serving_loop_and_scan():
    """With a gradient to take the time loop stacks its h_t; its output
    equals the in-place serving loop's and the prefix scan's, and its
    gradient the prefix scan's."""
    _, tcfg, _, tp, _, _ = train_case("recurrentgemma-9b")
    p = tp["layers"][0]["mixer"]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 24, tcfg.d_model)).astype(np.float32))
    with torch.no_grad():
        serve, st = rglru.rglru_scan(p, tcfg, x)
    outs, grads = [], []
    for assoc in (False, True):
        xg = x.clone().requires_grad_()
        out, st_g = rglru.rglru_scan(p, tcfg, xg, use_assoc_scan=assoc)
        (out * torch.linspace(-1, 1, out.shape[-1])).sum().backward()
        outs.append(out.detach())
        grads.append(xg.grad)
    torch.testing.assert_close(outs[0], serve, rtol=0, atol=0)
    torch.testing.assert_close(st_g["h"].detach(), st["h"], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(outs[1], serve, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-5)


def test_flash_attention_function_backward_is_the_plain_gradient(
        monkeypatch):
    """The autograd Function's plumbing on the CPU, with the plain
    version standing in for the kernel: forward as the wrapper's, the
    gradient of q, k and v that of ``chunked_causal_attention``, and one
    counted launch per forward."""
    monkeypatch.setattr(ops._flash, "flash_attention", ref.attention_ref)
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 20, 4, 16), (2, 20, 2, 16), (2, 20, 2, 16)))
    w = torch.from_numpy(rng.standard_normal((2, 4, 20, 16)).astype(
        np.float32))
    got, want = [], []
    for fn, out in ((ops._FlashAttention.apply, got), (None, want)):
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        args = (qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2))
        ops.reset_launches()
        if fn is None:
            o = ref.attention_ref(*args, window=8)
        else:
            o = fn(*args, True, 8, 0)
            assert ops.launches["flash_attention"] == 1
        (o * w).sum().backward()
        out += [o.detach(), qs.grad, ks.grad, vs.grad]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
