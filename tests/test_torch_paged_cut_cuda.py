"""The paged split pass alone on the card
(``ops.paged_flash_decode_partials``, the ``repro_paged_decode_partials``
entry of ``csrc/paged_decode.cu``) against its plain version, and, over
one page block, merged by ``ops.decode_merge`` bit for bit equal to the
one-call ``ops.paged_flash_decode``; over four page blocks merged within
the tolerance of the plain decode.  Imports no JAX, so it runs on the
GPU machine:
``python3 -m pytest -q -m cuda tests/test_torch_paged_cut_cuda.py``."""
import pytest
import torch

from repro_torch.kernels import decode_attention, ops, ref
from repro_torch.models import attention

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _case(B, H, KV, hd, ps, W, lens, dtype, seed=0):
    """A pool of B * W + 1 pages (page 0 null), each lane's pages drawn
    without replacement, its table padded with the null page."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    P = B * W + 1
    q = torch.randn((B, H, hd), generator=g, device=dev).to(dtype)
    kp = torch.randn((P, KV, ps, hd), generator=g, device=dev).to(dtype)
    vp = torch.randn((P, KV, ps, hd), generator=g, device=dev).to(dtype)
    perm = 1 + torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        seed))
    tables = perm.reshape(B, W).to(torch.int32)
    for b, n in enumerate(lens):
        tables[b, -(-n // ps):] = 0
    lengths = torch.tensor(lens, dtype=torch.int32)
    return q, kp, vp, tables.to(dev), lengths.to(dev)


SHAPES = [(8, 12, 2, 128, 16, 16, (97, 240, 16, 1, 129, 200, 64, 3)),
          (6, 48, 8, 128, 16, 8, (0, 128, 77, 1, 100, 128))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES, ids=["qwen2", "dbrx"])
def test_partials_entry_equals_its_plain_version(shape, dtype):
    """The entry's partials = ``ref.paged_decode_partials_ref`` (an empty
    split's m = -inf, l = 0, acc = 0), and over the whole pool as one
    block the merge of them is the one-call kernel's output exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    q, kp, vp, tables, L = _case(*shape, dtype)
    B, _, KV, _, ps, W = shape[:6]
    per, n = decode_attention.split_plan(B, KV, W * ps, ps)
    acc, m, l = ops.paged_flash_decode_partials(q, kp, vp, tables, L)
    pa, pm, pl = ref.paged_decode_partials_ref(q, kp, vp, tables, L,
                                               per_split=per, n_splits=n)
    assert torch.equal(torch.isinf(m), torch.isinf(pm))
    empty = torch.isinf(m)
    assert not acc[empty].any() and not l[empty].any()
    assert (acc - pa).abs().max().item() <= TOL[dtype] * pa.abs().max()
    out = ops.decode_merge(acc, m, l, dtype)
    assert torch.equal(out, ops.paged_flash_decode(q, kp, vp, tables, L))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_four_page_blocks_merge_to_the_plain_decode(dtype):
    """The pool dealt to 4 ranks by page block, each rank's partials over
    its compacted table, concatenated and merged = the plain decode over
    the whole pool; dropping one rank's partials is caught."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    q, kp, vp, tables, L = _case(*SHAPES[0], dtype)
    ps = kp.shape[2]
    kp, vp = kp[:-1].contiguous(), vp[:-1].contiguous()   # 128 pages
    tables = torch.clamp(tables, max=kp.shape[0] - 1)
    D, Pl = 4, kp.shape[0] // 4
    parts = []
    for d in range(D):
        table, length = attention._owned_table(tables, L, ps, d * Pl, Pl)
        parts.append(ops.paged_flash_decode_partials(
            q, kp[d * Pl:(d + 1) * Pl], vp[d * Pl:(d + 1) * Pl], table,
            length))
    want = ref.paged_decode_ref(q, kp, vp, tables, L).float()
    acc, m, l = (torch.cat([p[i] for p in parts], 2) for i in range(3))
    out = ops.decode_merge(acc, m, l, dtype).float()
    assert (out - want).abs().max().item() <= TOL[dtype]
    acc, m, l = (torch.cat([p[i] for p in parts[1:]], 2) for i in range(3))
    dropped = ops.decode_merge(acc, m, l, dtype).float()
    assert (dropped - want).abs().max().item() > TOL[dtype]
