"""On the card (marked ``cuda``; skips without one): a CUDA tensor never
takes a kernel's plain version, with the dry run's counting hooks in the
wrappers, and the kernel bench labels its rows ``cuda``.  Imports no
JAX, so it runs on the card's machine."""
import pytest
import torch

from repro_torch.bench import kernels as kbench


@pytest.mark.cuda
def test_a_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """With every plain version made to raise, the wrappers still serve
    CUDA tensors (the kernels launch and count) and the kernel bench
    labels its rows ``cuda``; the dry run's counting hooks do not reroute
    them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import ops, ref

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor took the plain version")

    dev = torch.device("cuda")
    q, k, v = kbench.attention_case(kbench.ATTN_SHAPES["qwen2_chunk"],
                                    device=dev)
    qd, kc, vc, lens = kbench.flash_decode_case(
        kbench.DECODE_SHAPES["rg_round"], device=dev)
    pq, kp, vp, tbl, plens = kbench.paged_decode_case(
        kbench.PAGED_SHAPES["serve"], torch.bfloat16, device=dev)
    want = {"flash_attention": ref.attention_ref(q, k, v, q_offset=64),
            "flash_decode": ref.decode_ref(qd, kc, vc, lens)}
    for name in ("attention_ref", "decode_ref", "paged_decode_ref",
                 "ladn_denoise_ref"):
        monkeypatch.setattr(ref, name, refuse)
    ops.reset_launches()
    got = {"flash_attention": ops.flash_attention(q, k, v, q_offset=64),
           "flash_decode": ops.flash_decode(qd, kc, vc, lens)}
    ops.paged_flash_decode(pq, kp, vp, tbl, plens)
    # inside a counting pass too: the kernel launches, nothing is tallied
    # as the plain version
    from repro_torch.roofline.analysis import count_ops
    _, tallies = count_ops(ops.flash_attention, q, k, v, q_offset=64)
    assert "kernel.flash_attention" not in tallies
    assert ops.launches["flash_attention"] == 2
    assert ops.launches["flash_decode"] == 1
    assert ops.launches["paged_flash_decode"] == 1
    for name, out in got.items():
        assert (out.float() - want[name].float()).abs().max().item() < 2e-2
    monkeypatch.undo()
    rows, records = kbench.bench_kernels()
    assert len(records) > 50
    assert all(r["mode"] == "cuda" and r["ok"] for r in records)
    assert all(r.endswith("mode=cuda") for r in rows)
