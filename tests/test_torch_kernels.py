"""Port kernels: the plain paged decode against the JAX Pallas kernel (in
interpret mode) and the JAX oracles, the split plan and a plain mirror of
the split-K kernel's split-then-merge, the ops dispatch, and the CUDA
kernel against its plain version on a card.

Inputs are numpy arrays from a seed, fed to both packages.  Lanes have
length >= 1: at length 0 the Pallas kernel returns zeros and the jnp
oracle the mean of V (``decode_attention.py:186`` against
``ref.py:45-48``); the model never asks for length 0.

The JAX package is imported inside the parity tests only, so that the
``cuda`` tests also collect on a GPU machine without JAX
(``pytest -m cuda tests/test_torch_kernels.py``).
"""
import numpy as np
import pytest
import torch

from _torch_split import (PLANS, boundary_lengths, check_plan, graph_replay,
                          plan_for, poison_cache, split_merge_decode)
from repro_torch.kernels import decode_attention, ops, ref

TOL_F32 = 1e-5

CASES = [
    # (B, KV, H, hd, ps, npages, lengths)
    (4, 2, 8, 64, 8, 6, [1, 7, 23, 48]),      # mid-page, full, ragged
    (3, 2, 12, 32, 16, 4, [1, 64, 33]),       # qwen2's G = 6
    (2, 4, 4, 32, 8, 3, [24, 5]),             # G = 1
]


def _case(B, KV, H, hd, ps, npages, lengths, seed=0):
    """Random pool, scrambled tables, and unmapped entries past
    ceil(len/ps) holding out-of-range page ids."""
    rng = np.random.default_rng(seed)
    P = 1 + B * npages                             # page 0 = null
    tables = (1 + rng.permutation(B * npages)).reshape(B, npages)
    for b, ln in enumerate(lengths):
        n = -(-ln // ps)
        tables[b, n:] = rng.choice([-3, P, P + 17], size=npages - n)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp = rng.standard_normal((P, KV, ps, hd)).astype(np.float32)
    vp = rng.standard_normal((P, KV, ps, hd)).astype(np.float32)
    return (q, kp, vp, tables.astype(np.int32),
            np.asarray(lengths, np.int32))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=["g4", "g6", "g1"])
def test_paged_decode_ref_matches_pallas_interpret(case):
    import jax.numpy as jnp
    from repro.kernels.decode_attention import \
        paged_flash_decode as jax_paged_flash_decode
    arrays = _case(*case)
    want = jax_paged_flash_decode(*[jnp.asarray(a) for a in arrays],
                                  interpret=True)
    got = ref.paged_decode_ref(*_torch(*arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL_F32, rtol=TOL_F32)


@pytest.mark.parametrize("case", CASES, ids=["g4", "g6", "g1"])
def test_paged_decode_ref_matches_jnp_oracle(case):
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref
    arrays = _case(*case, seed=1)
    want = jax_ref.paged_decode_ref(*[jnp.asarray(a) for a in arrays])
    got = ref.paged_decode_ref(*_torch(*arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL_F32, rtol=TOL_F32)


@pytest.mark.parametrize("length", [13, [1, 30, 64]],
                         ids=["scalar", "per_lane"])
def test_decode_ref_matches_jnp_oracle(length):
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref
    rng = np.random.default_rng(2)
    B, KV, H, S, hd = 3, 2, 6, 64, 32
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, S, hd)).astype(np.float32)
    ln = np.asarray(length, np.int32)
    want = jax_ref.decode_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(ln))
    got = ref.decode_ref(*_torch(q, k, v), torch.from_numpy(ln))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL_F32, rtol=TOL_F32)


def test_ops_dispatches_cpu_tensors_to_plain_version():
    """A CPU tensor goes to the plain version and is not counted as a
    kernel launch."""
    arrays = _torch(*_case(*CASES[0], seed=3))
    before = ops.launches["paged_flash_decode"]
    got = ops.paged_flash_decode(*arrays)
    assert ops.launches["paged_flash_decode"] == before
    torch.testing.assert_close(got, ref.paged_decode_ref(*arrays),
                               atol=0.0, rtol=0.0)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """The kernel entry never serves a CPU tensor (no fallback) and
    rejects dtypes it is not instantiated for."""
    q, kp, vp, tbl, lens = _torch(*_case(*CASES[0]))
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.paged_flash_decode(q, kp, vp, tbl, lens)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        decode_attention.paged_flash_decode(q.half(), kp.half(), vp.half(),
                                            tbl, lens)


def _dense(kp, vp, tables):
    """The pool's pages gathered into (B, KV, W * ps, hd) caches, as
    ``paged_decode_ref`` reads them."""
    B, W = tables.shape
    P, KV, ps, hd = kp.shape
    tbl = tables.long().clamp(0, P - 1)
    return [x[tbl].permute(0, 2, 1, 3, 4).reshape(B, KV, W * ps, hd)
            for x in (kp, vp)]


@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("B,KV", [(1, 1), (8, 2), (64, 8)],
                         ids=["1x1", "8x2", "64x8"])
def test_split_plan_covers_every_page_once(ps, B, KV):
    """Every table width W from 1 to 2048 / ps: splits are whole pages
    and cover the W x ps positions exactly once."""
    for W in range(1, 2048 // ps + 1):
        check_plan(decode_attention, B, KV, ps, W * ps)


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("case", [(2, 12, 32, 16, 6), (4, 4, 16, 8, 9),
                                  (1, 16, 64, 32, 3)],
                         ids=["g6", "g1", "g16"])
def test_split_merge_mirror_matches_paged_decode_ref(case, plan):
    """Split-then-merge over the plan's page runs, with the partials of
    splits past a lane's length left NaN, equals the plain version:
    lengths 0, 1, at a split boundary, one past it, and full."""
    KV, H, hd, ps, npages = case
    per, n = plan_for(decode_attention.split_plan, plan, KV, npages * ps,
                      ps)
    lengths = boundary_lengths(per, npages * ps)
    q, kp, vp, tbl, lens = _torch(*_case(len(lengths), KV, H, hd, ps,
                                         npages, lengths, seed=4))
    got = split_merge_decode(q, *_dense(kp, vp, tbl), lens, per, n)
    want = ref.paged_decode_ref(q, kp, vp, tbl, lens)
    live = lens > 0
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[live], want[live], atol=TOL_F32,
                               rtol=TOL_F32)
    assert got[~live].abs().max().item() == 0.0


# (KV, H, hd, ps, npages): qwen2-1.5b's heads at the serve path's table
# width and at 2048 tokens, G = 1 at hd 64, recurrentgemma's G = 16 at
# hd 256, and the closed loop's 18 x 8-token table at qwen2-1.5b's heads
# and at starcoder2-3b's G = 12, and the crash drill's and the chaos and
# stress benches' 7 x 16-token table at both archs' heads
CUDA_CASES = {"qwen2": (2, 12, 128, 16, 15), "g1_hd64": (4, 4, 64, 8, 6),
              "g16_hd256": (1, 16, 256, 16, 10),
              "qwen2_2048": (2, 12, 128, 16, 128),
              "qwen2_closedloop": (2, 12, 128, 8, 18),
              "starcoder2_3b": (2, 24, 128, 8, 18),
              "qwen2_chaos": (2, 12, 128, 16, 7),
              "starcoder2_3b_chaos": (2, 24, 128, 16, 7)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_cuda_kernel_matches_plain_version(dtype, tol, case):
    """Lanes at and around the plan's split boundaries match the plain
    version, with the output's and the partials' memory NaN beforehand;
    length-0 lanes, and a call with every lane empty, give zeros; a
    CUDA-graph replay equals the eager call bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    dev = torch.device("cuda")
    KV, H, hd, ps, npages = CUDA_CASES[case]
    per, n_splits = decode_attention.split_plan(6, KV, npages * ps, ps)
    lengths = boundary_lengths(per, npages * ps)
    q, kp, vp, tbl, lens = [t.to(dev) for t in _torch(
        *_case(len(lengths), KV, H, hd, ps, npages, lengths))]
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)

    def call(n=lens):
        return decode_attention.paged_flash_decode(q, kp, vp, tbl, n)

    poison_cache(q, n_splits)
    got = call()
    torch.cuda.synchronize()
    want = ref.paged_decode_ref(q, kp, vp, tbl, lens)
    live = lens > 0
    assert torch.isfinite(got).all()
    assert (got[live].float() - want[live].float()).abs().max().item() <= tol
    assert got[~live].abs().max().item() == 0.0
    assert call(torch.zeros_like(lens)).abs().max().item() == 0.0
    assert torch.equal(graph_replay(call), got)
