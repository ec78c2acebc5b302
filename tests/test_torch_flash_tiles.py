"""The bf16 flash-attention kernel's tile plan and arithmetic, on the CPU.

``tile_plan`` cuts a call into blocks from shapes alone; these tests hold
it to the mask (every allowed (row, key) pair covered once, no tile loaded
that the mask refuses wholly, the per-warp skip / edge rules exact) and to
the card's limits.  A plain mirror of the kernel's arithmetic
(``tests/_torch_flash_tiles.py``: the plan's key tiles in order, f32
scores, each probability as bf16 hi + lo, f32 accumulation) is held
against ``attention_ref`` and the Pallas kernel in interpret mode.

The bf16 margin: before its last rounding to bf16 the mirror's output
agrees with the f32 oracle on the same bf16 inputs to 1e-5 (measured
2e-6 to 6e-6 at the main path's shapes), so after it the two differ by at
most one bf16 ulp of the output, under the 2e-2 gate.  With P rounded to
bf16 alone (no lo term) the pre-rounding error is 1.4e-3 to 3.1e-3 and
the rounded outputs differ by up to 1.56e-2, too little margin: the
kernel keeps the split.
"""
import numpy as np
import pytest
import torch

from _torch_flash_tiles import check_plan_covers_mask, mirror_flash_attention
from repro_torch.kernels import flash_attention as fa, ref

TOL = {"float32": 1e-4, "bfloat16": 2e-2}     # tests/test_kernels.py:45
PRE_ROUND_TOL = 1e-5                           # the mirror before rounding

# (Sq, Skv, window, q_offset, causal): ragged causal; a window that bites
# inside a key tile; a query offset with keys past the causal edge; fewer
# keys than q_offset + Sq (rows past Skv + window - 1 see no key); and
# non-causal with a window
MASKS = {
    "causal_ragged": (37, 37, None, 0, True),
    "window_in_tile": (70, 70, 13, 0, True),
    "offset_past_edge": (20, 100, None, 50, True),
    "short_kv": (30, 50, 9, 40, True),
    "noncausal_window": (25, 40, 7, 3, False),
}


def _inputs(B, H, KV, Sq, Skv, hd, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(dtype)
                 for s in ((B, H, Sq, hd), (B, KV, Skv, hd),
                           (B, KV, Skv, hd)))


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("G", [1, 6, 16])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_tile_plan_covers_the_mask_once(hd, G, mask):
    """The bf16 plans of every split (blocks of 64 and 16 rows) and the
    f32 plan: each allowed (row, key) pair once, no tile wholly
    outside the mask."""
    Sq, Skv, window, off, causal = MASKS[mask]
    B, KV = 2, 2
    H = G * KV
    kw = dict(window=window, q_offset=off, causal=causal)
    for split in fa.SPLITS:
        check_plan_covers_mask(fa, fa.mma_plan(B, KV, Sq, G, Skv, hd, split),
                               B, H, KV, Sq, Skv, **kw)
    f32 = fa.tile_plan(B, H, KV, Sq, Skv, hd, torch.float32, **kw)
    assert not f32.mma
    check_plan_covers_mask(fa, f32, B, H, KV, Sq, Skv, **kw)


# (B, H, KV, Sq, Skv, hd, window, q_offset) -> (rows, blocks) in bf16:
# chip_smoke.py phase 9's shapes, then extremes
PLAN_CASES = {
    "rg_prefill": ((1, 16, 1, 128, 128, 256, 2048, 0), (16, 128)),
    "rg_4096": ((1, 16, 1, 4096, 4096, 256, 2048, 0), (64, 1024)),
    "qwen2_chunk": ((1, 12, 2, 64, 240, 128, None, 64), (16, 48)),
    "qwen2_chunk_2048": ((1, 12, 2, 64, 2048, 128, None, 1984), (16, 48)),
    "one_token": ((1, 1, 1, 1, 1, 64, None, 0), (16, 1)),
    "g64_hd256": ((4, 64, 1, 300, 300, 256, None, 0), (64, 1200)),
    "long_batch": ((64, 32, 8, 8192, 8192, 128, None, 0), (64, 262144)),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_tile_plan_fits_the_card(case):
    """Grid and shared memory within an H100's limits (232,448 bytes a
    block) for every split, the split by the rule (the smallest that keeps
    a wave of 132 blocks, else 4), one stage only when every key fits one
    tile, the mask's arguments leaving the plan as it is, and the f32 plan
    the CUDA-core kernel's grid."""
    (B, H, KV, Sq, Skv, hd, window, off), (rows, blocks) = PLAN_CASES[case]
    G = H // KV
    plan = fa.tile_plan(B, H, KV, Sq, Skv, hd, torch.bfloat16, window, off)
    assert (plan.rows, plan.blocks) == (rows, blocks)
    assert plan.mma and plan.threads == 128 and plan.split * rows == 64
    assert plan.bk == plan.split * fa.warp_keys(hd, plan.split)
    assert plan.stages == (1 if Skv <= plan.bk else 2)
    assert fa.tile_plan(B, H, KV, Sq, Skv, hd, torch.bfloat16, 1, 7,
                        False) == plan
    others = {s: fa.mma_plan(B, KV, Sq, G, Skv, hd, s) for s in fa.SPLITS}
    assert all(p.smem <= fa.MAX_SMEM and p.blocks < 2 ** 31
               for p in others.values())
    assert all(others[s].blocks < fa.WAVE for s in fa.SPLITS
               if s < plan.split)
    assert plan.split == fa.SPLITS[-1] or blocks >= fa.WAVE
    f32 = fa.tile_plan(B, H, KV, Sq, Skv, hd, torch.float32, window, off)
    assert f32.blocks == B * KV * -(-Sq // (64 // G))
    assert f32.smem <= fa.MAX_SMEM and f32.threads == 256


def test_tile_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="head_dim"):
        fa.tile_plan(1, 4, 2, 8, 8, 96, torch.bfloat16)
    with pytest.raises(ValueError, match="KV heads"):
        fa.tile_plan(1, 130, 2, 8, 8, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="window"):
        fa.tile_plan(1, 4, 2, 8, 8, 64, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="q_offset"):
        fa.tile_plan(1, 4, 2, 8, 8, 64, torch.bfloat16, None, -1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.tile_plan(1, 4, 2, 8, 8, 64, torch.float16)
    assert fa.tile_plan(1, 4, 2, 0, 8, 64, torch.bfloat16).blocks == 0


# (B, H, KV, Sq, Skv, hd, window, q_offset): hd 64 / 128 / 256 at
# G 1 / 6 / 16, windows inside a tile, offsets, rows with no key
MIRROR_CASES = {
    "g16_hd256_window": (1, 16, 1, 40, 40, 256, 11, 0),
    "g6_hd128_offset": (1, 12, 2, 24, 150, 128, None, 120),
    "g1_hd64_ragged": (2, 3, 3, 77, 77, 64, None, 0),
    "g6_hd64_short_kv": (1, 6, 1, 30, 20, 64, 6, 4),
    "g16_hd128_window_offset": (1, 16, 1, 20, 90, 128, 33, 66),
}


@pytest.mark.parametrize("case", list(MIRROR_CASES))
def test_mirror_matches_attention_ref(case):
    """The kernel's arithmetic at every split against the f32 oracle on
    the same bf16 inputs: within PRE_ROUND_TOL before the last rounding,
    within the bf16 gate after it; rows with no valid key are zeros (the
    oracle's mean of V there is not compared)."""
    B, H, KV, Sq, Skv, hd, window, off = MIRROR_CASES[case]
    q, k, v = _inputs(B, H, KV, Sq, Skv, hd, seed=Sq + Skv)
    want = ref.attention_ref(q.float(), k.float(), v.float(), window=window,
                             q_offset=off)
    pos = off + torch.arange(Sq)[:, None]
    keys = torch.arange(Skv)[None]
    seen = keys <= pos
    if window is not None:
        seen &= keys > pos - window
    live = seen.any(1)
    for split in fa.SPLITS:
        plan = fa.mma_plan(B, KV, Sq, H // KV, Skv, hd, split)
        kw = dict(window=window, q_offset=off, plan=plan)
        got = mirror_flash_attention(fa, q, k, v, round_out=False, **kw)
        err = (got - want)[:, :, live].abs().max().item()
        assert err <= PRE_ROUND_TOL, split
        if not live.all():
            assert got[:, :, ~live].abs().max().item() == 0.0
        rounded = mirror_flash_attention(fa, q, k, v, **kw)
        assert rounded.dtype == torch.bfloat16
        diff = rounded.float() - want.to(torch.bfloat16).float()
        assert diff[:, :, live].abs().max().item() <= TOL["bfloat16"]


@pytest.mark.parametrize("B,H,KV,S,hd,win", [(1, 4, 2, 128, 64, 32),
                                             (1, 16, 1, 64, 256, None),
                                             (2, 6, 1, 128, 128, 50)],
                         ids=["g2_window", "g16_hd256", "g6_window"])
def test_mirror_matches_pallas_interpret(B, H, KV, S, hd, win):
    """The Pallas kernel (interpret mode, f32 on the same bf16-valued
    inputs) against the mirror before its last rounding."""
    from repro.kernels.flash_attention import \
        flash_attention as jax_flash_attention
    import jax.numpy as jnp
    q, k, v = _inputs(B, H, KV, S, S, hd, seed=hd + S)
    want = jax_flash_attention(*(jnp.asarray(t.float().numpy())
                                 for t in (q, k, v)),
                               window=win, bq=32, bk=32, interpret=True)
    got = mirror_flash_attention(fa, q, k, v, window=win, round_out=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PRE_ROUND_TOL, rtol=PRE_ROUND_TOL)
