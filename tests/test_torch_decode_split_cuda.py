"""``flash_decode``'s two passes apart on the card: the split-only entry
(``ops.flash_decode_partials``) and the merge-only entry
(``ops.decode_merge``) against the one-call kernel and the plain
versions, whole and over a ring cut in slices as a mesh's "model" ranks
hold it, and a dense engine on the 1 x 1 NCCL mesh, whose rings take the
two passes, against the meshless engine.  Imports no JAX, so it runs on
the GPU machine:
``python3 -m pytest -q -m cuda tests/test_torch_decode_split_cuda.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention, ops, ref

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _case(B, H, KV, S, hd, lens, dtype, seed=0):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, KV, S, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, KV, S, hd), generator=g, device=dev).to(dtype)
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (4, 16, 1, 160, 256, (129, 145, 160, 131)),   # recurrentgemma's round
    (4, 32, 8, 672, 128, (641, 655, 672, 645)),   # llava's
    (3, 12, 2, 64, 128, (64, 1, 0))])              # a lane of length 0
def test_split_entries_equal_the_one_call_kernel(shape, dtype):
    """The split pass then the merge pass give the one-call kernel's
    output (the same arithmetic) and the plain decode's within the
    tolerance; the partials equal the plain partials, an empty split's
    m = -inf, l = 0, acc = 0; a lane of length 0 gives zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    q, k, v, L = _case(*shape, dtype)
    B, _, KV, S = shape[:4]
    per, n = decode_attention.split_plan(B, KV, S, decode_attention.TILE)
    acc, m, l = ops.flash_decode_partials(q, k, v, L)
    out = ops.decode_merge(acc, m, l, dtype)
    torch.testing.assert_close(out, ops.flash_decode(q, k, v, L), rtol=0,
                               atol=TOL[dtype])
    live = L > 0
    want = ref.decode_ref(q, k, v, L).float()
    assert (out.float() - want)[live].abs().max().item() <= TOL[dtype]
    assert not out[~live].any()
    pa, pm, pl = ref.decode_partials_ref(q, k, v, L, per_split=per,
                                         n_splits=n)
    assert torch.equal(torch.isinf(m), torch.isinf(pm))
    assert not acc[torch.isinf(m)].any() and not l[torch.isinf(m)].any()
    assert (acc - pa).abs().max().item() <= TOL[dtype] * pa.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_merge_over_slices_with_an_empty_one(dtype):
    """A 160-slot ring cut into 4 slices, the last empty for every lane:
    each slice's partials concatenated and merged = the whole ring's
    plain decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    q, k, v, L = _case(4, 16, 1, 160, 256, (100, 45, 80, 119), dtype)
    M, W = 4, 40
    parts = [ops.flash_decode_partials(
        q, k[:, :, j * W:(j + 1) * W].contiguous(),
        v[:, :, j * W:(j + 1) * W].contiguous(),
        torch.clamp(L - j * W, 0, W).to(torch.int32)) for j in range(M)]
    assert torch.isinf(parts[-1][1]).all()
    acc, m, l = (torch.cat([p[i] for p in parts], 2) for i in range(3))
    out = ops.decode_merge(acc, m, l, dtype).float()
    assert torch.isfinite(out).all()
    assert (out - ref.decode_ref(q, k, v, L).float()).abs().max().item() \
        <= TOL[dtype]


@pytest.mark.cuda
def test_smoke_mesh_dense_engine_takes_the_two_passes():
    """Reduced recurrentgemma-9b (3 layers, one attention) on the 1 x 1
    NCCL mesh: the greedy tokens of the meshless engine, and one split
    and one merge launch per decode round, no one-call launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import ServeEngine
    dev = torch.device("cuda")
    cfg = dataclasses.replace(reduced(get_config("recurrentgemma-9b")),
                              num_layers=3)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(3),
                         dev)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 40),
                                                dtype=np.int32)
    want = ServeEngine(cfg, params, max_len=96, kv_slots=4,
                       device=dev).generate(prompts, 30).tokens
    ops.reset_launches()
    eng = ServeEngine(cfg, params, max_len=96, kv_slots=4, device=dev,
                      mesh=make_smoke_mesh(dev))
    got = eng.generate(prompts, 30).tokens
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert ops.launches["flash_decode"] == 0
    assert ops.launches["flash_decode_partials"] == \
        ops.launches["decode_merge"] == eng.decode_rounds
