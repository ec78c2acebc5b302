"""The flash-attention kernels' tile plan and arithmetic, on the CPU.

``tile_plan`` cuts a call into blocks from shapes alone, in bf16 and in
f32; these tests hold it to the mask (every allowed (row, key) pair
covered once, no tile loaded that the mask refuses wholly, the per-warp
skip / edge rules exact) and to the card's limits.  A plain mirror of
each kernel's arithmetic (``tests/_torch_flash_tiles.py``: the plan's key
tiles in order, f32 scores, f32 accumulation; bf16: each probability as
bf16 hi + lo; f32: every product as 3xTF32) is held against
``attention_ref`` and the Pallas kernel in interpret mode.  A ``cuda``
test holds the f32 kernel to its mirror on the card.

The bf16 margin: before its last rounding to bf16 the mirror's output
agrees with the f32 oracle on the same bf16 inputs to 1e-5 (measured
2e-6 to 6e-6 at the main path's shapes), so after it the two differ by at
most one bf16 ulp of the output, under the 2e-2 gate.  With P rounded to
bf16 alone (no lo term) the pre-rounding error is 1.4e-3 to 3.1e-3 and
the rounded outputs differ by up to 1.56e-2, too little margin: the
kernel keeps the split.

The f32 margin: with each operand split into tf32 hi + lo (rounded as
``cvt.rna`` rounds) and each product taken as hi * hi + hi * lo + lo *
hi, the mirror agrees with the f32 oracle to 6.7e-7 to 2.2e-6 at
``MIRROR_CASES`` (either split) and the main-path shapes below, under
the 1e-4 gate by 45x or more.  With one TF32 product (hi * hi alone) the
error at those main-path shapes is 8.1e-4 to 1.37e-3, over the gate at
every one of them: the kernel takes three.
The f32 tests record these readings, and the ``cuda`` test the kernel's
distance from its mirror, as properties of the junit report
(``pytest --junitxml=FILE``).
"""
import numpy as np
import pytest
import torch

from _torch_flash_tiles import check_plan_covers_mask, mirror_flash_attention
from _torch_split import graph_replay
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
    """The plans of every split (blocks of 64 and 16 rows) in bf16 and in
    f32, whose tiles differ: each allowed (row, key) pair once, no tile
    wholly outside the mask, the per-warp skip / edge rules exact."""
    Sq, Skv, window, off, causal = MASKS[mask]
    B, KV = 2, 2
    H = G * KV
    kw = dict(window=window, q_offset=off, causal=causal)
    for dtype in (torch.bfloat16, torch.float32):
        for split in fa.SPLITS:
            plan = fa.mma_plan(B, KV, Sq, G, Skv, hd, split, dtype)
            check_plan_covers_mask(fa, plan, B, H, KV, Sq, Skv, **kw)
        plan = fa.tile_plan(B, H, KV, Sq, Skv, hd, dtype, **kw)
        assert plan in [fa.mma_plan(B, KV, Sq, G, Skv, hd, s, dtype)
                        for s in fa.SPLITS]


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


# f32 (tensor cores, 3xTF32): keys a warp takes from each tile, by (hd,
# split); Q as tf32 hi and lo, K and V tiles twice bf16's bytes
F32_WARP_KEYS = {(64, 1): 64, (128, 1): 16, (256, 1): 16,
                 (64, 4): 16, (128, 4): 8, (256, 4): 8}
# a block that leaves room for a second on an SM (its 228 KB, less 1 KB
# the card keeps for each block)
TWO_BLOCKS = 115_712


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_tile_plan_fits_the_card(case):
    """Grid and shared memory within an H100's limits (232,448 bytes a
    block) for every split and both dtypes, the split by the rule (the
    smallest that keeps a wave of 132 blocks, else 4), one stage only when
    every key fits one tile, the mask's arguments leaving the plan as it
    is; the f32 plan the bf16 plan's grid and threads, with the most keys
    a warp whose two stages leave room for a second block on an SM where
    any do (at hd 256 none do: the most that fit one)."""
    (B, H, KV, Sq, Skv, hd, window, off), (rows, blocks) = PLAN_CASES[case]
    G = H // KV
    plan = fa.tile_plan(B, H, KV, Sq, Skv, hd, torch.bfloat16, window, off)
    assert (plan.rows, plan.blocks) == (rows, blocks)
    assert plan.threads == 128 and plan.split * rows == 64
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
    assert (f32.rows, f32.blocks, f32.threads) == (rows, blocks, 128)
    keys = F32_WARP_KEYS[hd, f32.split]
    assert f32.bk == f32.split * keys
    assert f32.stages == (1 if Skv <= f32.bk else 2)
    assert fa.tile_plan(B, H, KV, Sq, Skv, hd, torch.float32, 1, 7,
                        False) == f32
    for s in fa.SPLITS:
        p = fa.mma_plan(B, KV, Sq, G, Skv, hd, s, torch.float32)
        assert p.smem <= fa.MAX_SMEM and p.blocks < 2 ** 31
        w = F32_WARP_KEYS[hd, s]
        assert fa.warp_keys(hd, s, torch.float32) == w
        # the most keys whose two stages leave room for a second block;
        # at hd 256, where none do, the most that fit one
        two = fa.walk_smem(hd, s, w, 2, torch.float32)
        bigger = fa.walk_smem(hd, s, 2 * w, 2, torch.float32)
        if hd < 256:
            assert two <= TWO_BLOCKS and (w == 64 or bigger > TWO_BLOCKS)
        else:
            assert two <= fa.MAX_SMEM < bigger
            assert fa.walk_smem(hd, s, 8, 2, torch.float32) > TWO_BLOCKS


def test_tile_plan_refuses_what_no_kernel_takes():
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="head_dim"):
            fa.tile_plan(1, 4, 2, 8, 8, 96, dtype)
        with pytest.raises(ValueError, match="KV heads"):
            fa.tile_plan(1, 130, 2, 8, 8, 64, dtype)
        with pytest.raises(ValueError, match="window"):
            fa.tile_plan(1, 4, 2, 8, 8, 64, dtype, 0)
        with pytest.raises(ValueError, match="q_offset"):
            fa.tile_plan(1, 4, 2, 8, 8, 64, dtype, None, -1)
        assert fa.tile_plan(1, 4, 2, 0, 8, 64, dtype).blocks == 0
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.tile_plan(1, 4, 2, 8, 8, 64, torch.float16)


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


def _record(request, name, value):
    """A reading, as a property of this test in the junit report (the
    node's user properties: what ``record_property`` writes, without its
    warning under the xunit2 family)."""
    request.node.user_properties.append((name, value))


def _live_rows(Sq, Skv, window, off):
    pos = off + torch.arange(Sq)[:, None]
    keys = torch.arange(Skv)[None]
    seen = keys <= pos
    if window is not None:
        seen &= keys > pos - window
    return seen.any(1)


@pytest.mark.parametrize("case", list(MIRROR_CASES))
def test_tf32_mirror_matches_attention_ref(case, request):
    """The f32 kernel's arithmetic (3xTF32) at every split against the
    f32 oracle: within the f32 gate, with the margin the module docstring
    states; rows with no valid key are zeros."""
    B, H, KV, Sq, Skv, hd, window, off = MIRROR_CASES[case]
    q, k, v = _inputs(B, H, KV, Sq, Skv, hd, seed=Sq + Skv,
                      dtype=torch.float32)
    want = ref.attention_ref(q, k, v, window=window, q_offset=off)
    live = _live_rows(Sq, Skv, window, off)
    for split in fa.SPLITS:
        plan = fa.mma_plan(B, KV, Sq, H // KV, Skv, hd, split, torch.float32)
        got = mirror_flash_attention(fa, q, k, v, window=window,
                                     q_offset=off, plan=plan)
        assert got.dtype == torch.float32
        err = (got - want)[:, :, live].abs().max().item()
        _record(request, f"mirror_oracle_split{split}", err)
        assert err <= TOL["float32"] and err <= PRE_ROUND_TOL, split
        if not live.all():
            assert got[:, :, ~live].abs().max().item() == 0.0


@pytest.mark.parametrize("B,H,KV,S,hd,win", [(1, 4, 2, 128, 64, 32),
                                             (1, 16, 1, 64, 256, None),
                                             (2, 6, 1, 128, 128, 50)],
                         ids=["g2_window", "g16_hd256", "g6_window"])
def test_tf32_mirror_matches_pallas_interpret(B, H, KV, S, hd, win):
    """The Pallas kernel (interpret mode) against the f32 kernel's
    arithmetic on the same f32 inputs."""
    from repro.kernels.flash_attention import \
        flash_attention as jax_flash_attention
    import jax.numpy as jnp
    q, k, v = _inputs(B, H, KV, S, S, hd, seed=hd + S, dtype=torch.float32)
    want = jax_flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                               window=win, bq=32, bk=32, interpret=True)
    got = mirror_flash_attention(fa, q, k, v, window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL["float32"], rtol=TOL["float32"])


# main-path f32 shapes (B, H, KV, Sq, Skv, hd, window, q_offset): the
# default entry point's recurrentgemma-9b prefill and qwen2-1.5b chunk,
# the crash drill's 16-token recurrentgemma prefill
ONE_PRODUCT_CASES = {
    "serve_reduced_rg_f32": (1, 4, 1, 32, 32, 64, 64, 0),
    "serve_reduced_qwen2_f32": (1, 4, 2, 64, 128, 64, None, 0),
    "crash_rg_gate_f32": (1, 16, 1, 16, 16, 256, 2048, 0),
}


@pytest.mark.parametrize("case", list(ONE_PRODUCT_CASES))
def test_one_tf32_product_misses_the_f32_gate(case, request):
    """Why the kernel takes three products: with hi * hi alone (the lo
    terms dropped, one TF32 product for Q K^T and one for P V) the same
    arithmetic misses the 1e-4 gate at main-path shapes; with all three
    it meets it."""
    B, H, KV, Sq, Skv, hd, window, off = ONE_PRODUCT_CASES[case]
    q, k, v = _inputs(B, H, KV, Sq, Skv, hd, seed=Sq + Skv,
                      dtype=torch.float32)
    want = ref.attention_ref(q, k, v, window=window, q_offset=off)
    kw = dict(window=window, q_offset=off)
    one = mirror_flash_attention(fa, q, k, v, split_p=False, **kw)
    three = mirror_flash_attention(fa, q, k, v, **kw)
    err = {"one_product_oracle": (one - want).abs().max().item(),
           "mirror_oracle": (three - want).abs().max().item()}
    for name, x in err.items():
        _record(request, name, x)
    assert err["one_product_oracle"] > TOL["float32"]
    assert err["mirror_oracle"] <= TOL["float32"]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")


# the f32 kernel against its mirror on the same inputs: the tf32 splits
# are the same, the f32 sums are not (the tensor cores' accumulation; a
# mirror summing in the kernel's k8 order, on the card, came no closer):
# 8.3e-7 to 3.6e-6 at MIRROR_CASES on an NVIDIA H100 80GB HBM3 at 700 W
# (the test below, its junit properties), as far as the kernel is from
# the oracle
KERNEL_MIRROR_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MIRROR_CASES))
def test_cuda_tf32_kernel_matches_mirror(case, request):
    """The f32 kernel on the card against its CPU mirror (three products:
    within ``KERNEL_MIRROR_TOL``; one product: past the gate, so the
    kernel takes all three) and the f32 oracle (the gate), eagerly and in
    a CUDA-graph replay."""
    _needs_card()
    B, H, KV, Sq, Skv, hd, window, off = MIRROR_CASES[case]
    q, k, v = _inputs(B, H, KV, Sq, Skv, hd, seed=Sq + Skv,
                      dtype=torch.float32)
    kw = dict(window=window, q_offset=off)
    mirror = mirror_flash_attention(fa, q, k, v, **kw)
    one = mirror_flash_attention(fa, q, k, v, split_p=False, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    dev = torch.device("cuda")
    qd, kd, vd = (t.to(dev) for t in (q, k, v))

    def call():
        return fa.flash_attention(qd, kd, vd, **kw)

    got = call()
    torch.cuda.synchronize()
    live = _live_rows(Sq, Skv, window, off)
    outs = {"eager": got.cpu(), "graph": graph_replay(call).cpu()}
    for how, out in outs.items():
        err = {"mirror": (out - mirror).abs().max().item(),
               "one_product": (out - one).abs().max().item(),
               "oracle": (out - want)[:, :, live].abs().max().item()}
        for name, x in err.items():
            _record(request, f"kernel_{name}_{how}", x)
        assert err["mirror"] <= KERNEL_MIRROR_TOL
        assert err["one_product"] > TOL["float32"]
        assert err["oracle"] <= TOL["float32"]
