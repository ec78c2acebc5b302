"""Port attention kernels: the plain ``attention_ref`` and ``decode_ref``
against the JAX oracles and the Pallas kernels (in interpret mode), the
query-offset variant against both packages' chunked attention, the split
plan and a plain mirror of split-K ``flash_decode``, the ops dispatch, and
the CUDA kernels against their plain versions on a card.

Inputs are numpy arrays from a seed, fed to both packages.  The JAX
package is imported inside the parity tests only, so that the ``cuda``
tests also collect on a GPU machine without JAX
(``pytest -m cuda tests/test_torch_flash.py``).
"""
import numpy as np
import pytest
import torch

from _torch_split import (PLANS, boundary_lengths, check_plan, graph_replay,
                          plan_for, poison_cache, split_merge_decode)
from repro_torch.kernels import decode_attention, flash_attention, ops, ref

TOL = {"float32": 1e-4, "bfloat16": 2e-2}     # tests/test_kernels.py:45

# (B, H, KV, S, hd, window, dtype): the reference's ATTN_CASES
ATTN_CASES = [
    (2, 4, 2, 256, 64, None, "float32"),
    (1, 4, 4, 512, 128, None, "float32"),
    (2, 8, 2, 256, 128, 64, "float32"),
    (1, 2, 1, 128, 64, 32, "float32"),
    (1, 8, 8, 256, 64, None, "bfloat16"),
    (2, 2, 2, 384, 128, 128, "bfloat16"),
]
# (B, H, KV, S, hd, length, dtype): the reference's DECODE_CASES
DECODE_CASES = [
    (2, 8, 2, 1024, 64, 1024, "float32"),
    (1, 4, 1, 512, 128, 300, "float32"),
    (3, 16, 8, 256, 128, 77, "float32"),
    (2, 4, 4, 512, 64, 512, "bfloat16"),
    (1, 2, 1, 256, 128, 1, "float32"),      # single valid token
]


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(a, dtype):
    """The same numbers as a JAX array and a torch tensor of ``dtype``."""
    import jax.numpy as jnp
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _attn_inputs(B, H, KV, Sq, Skv, hd, seed):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (B, H, Sq, hd)), _normal(rng, (B, KV, Skv, hd)),
            _normal(rng, (B, KV, Skv, hd)))


# ---------------------------------------------------------------------------
# flash attention: plain version against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,KV,S,hd,win,dtype", ATTN_CASES)
def test_attention_ref_matches_jax_oracle(B, H, KV, S, hd, win, dtype):
    from repro.kernels import ref as jax_ref
    arrays = _attn_inputs(B, H, KV, S, S, hd, seed=S + hd)
    (jq, tq), (jk, tk), (jv, tv) = [_pair(a, dtype) for a in arrays]
    want = jax_ref.attention_ref(jq, jk, jv, window=win)
    got = ref.attention_ref(tq, tk, tv, window=win)
    assert got.dtype == tq.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("B,H,KV,S,hd,win", [(1, 2, 1, 128, 64, 32),
                                             (2, 4, 2, 256, 64, None)],
                         ids=["window", "causal"])
def test_attention_ref_matches_pallas_interpret(B, H, KV, S, hd, win):
    from repro.kernels.flash_attention import \
        flash_attention as jax_flash_attention
    arrays = _attn_inputs(B, H, KV, S, S, hd, seed=7)
    (jq, tq), (jk, tk), (jv, tv) = [_pair(a, "float32") for a in arrays]
    want = jax_flash_attention(jq, jk, jv, window=win, bq=128, bk=128,
                               interpret=True)
    _close(ref.attention_ref(tq, tk, tv, window=win), want, "float32")


@pytest.mark.parametrize("window", [None, 12])
def test_attention_ref_q_offset_matches_chunked_attention(window):
    """Query i at position q_offset + i: the paged prefill chunk's
    function, held against both packages' chunked causal attention
    (which take the (B, S, H, hd) layout)."""
    from repro.models import attention as jax_attention
    from repro_torch.models import attention
    q, k, v = _attn_inputs(1, 4, 2, 16, 48, 16, seed=11)
    qs, ks, vs = (a.transpose(0, 2, 1, 3).copy() for a in (q, k, v))
    kw = dict(window=window, q_offset=24, q_chunk=8, kv_chunk=16)
    want = jax_attention.chunked_causal_attention(*(_pair(a, "float32")[0]
                                                    for a in (qs, ks, vs)),
                                                  **kw)
    port = attention.chunked_causal_attention(
        *(torch.from_numpy(a) for a in (qs, ks, vs)), **kw)
    got = ref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                            window=window, q_offset=24)
    _close(got.transpose(1, 2), want, "float32")
    _close(got.transpose(1, 2), port.numpy(), "float32")


# ---------------------------------------------------------------------------
# flash decode: plain version against the reference
# ---------------------------------------------------------------------------


def _decode_inputs(B, H, KV, S, hd, seed):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (B, H, hd)), _normal(rng, (B, KV, S, hd)),
            _normal(rng, (B, KV, S, hd)))


@pytest.mark.parametrize("B,H,KV,S,hd,L,dtype", DECODE_CASES)
def test_decode_ref_matches_pallas_interpret(B, H, KV, S, hd, L, dtype):
    import jax.numpy as jnp
    from repro.kernels.decode_attention import flash_decode as jax_decode
    arrays = _decode_inputs(B, H, KV, S, hd, seed=S + L)
    (jq, tq), (jk, tk), (jv, tv) = [_pair(a, dtype) for a in arrays]
    want = jax_decode(jq, jk, jv, jnp.int32(L), bk=128, interpret=True)
    _close(ref.decode_ref(tq, tk, tv, L), want, dtype)


def test_decode_ref_per_lane_lengths_match_pallas_interpret():
    import jax.numpy as jnp
    from repro.kernels.decode_attention import flash_decode as jax_decode
    arrays = _decode_inputs(3, 4, 2, 256, 64, seed=5)
    lengths = np.asarray([10, 128, 256], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = [_pair(a, "float32") for a in arrays]
    want = jax_decode(jq, jk, jv, jnp.asarray(lengths), bk=64,
                      interpret=True)
    _close(ref.decode_ref(tq, tk, tv, torch.from_numpy(lengths)), want,
           "float32")


# ---------------------------------------------------------------------------
# split-K flash decode: the plan and a plain mirror of split-then-merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,KV", [(1, 1), (4, 1), (8, 2), (64, 8)],
                         ids=["1x1", "4x1", "8x2", "64x8"])
def test_split_plan_covers_every_position_once(B, KV):
    """Every ring depth S from 1 to 2048: splits are whole tiles and
    cover the S positions exactly once."""
    for S in range(1, 2049):
        check_plan(decode_attention, B, KV, decode_attention.TILE, S)


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("KV,H,S,hd", [(1, 16, 160, 32), (2, 12, 256, 16),
                                       (4, 4, 96, 64)],
                         ids=["g16", "g6", "g1"])
def test_split_merge_mirror_matches_decode_ref(KV, H, S, hd, plan):
    """Split-then-merge over the plan's tiles, with the partials of splits
    past a lane's length left NaN, equals the plain version: lengths 0, 1,
    at a split boundary, one past it, and full."""
    per, n = plan_for(decode_attention.split_plan, plan, KV, S,
                      decode_attention.TILE)
    lengths = torch.tensor(boundary_lengths(per, S), dtype=torch.int32)
    q, k, v = (torch.from_numpy(a) for a in _decode_inputs(
        len(lengths), H, KV, S, hd, seed=8))
    got = split_merge_decode(q, k, v, lengths, per, n)
    want = ref.decode_ref(q, k, v, lengths)
    live = lengths > 0
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[live], want[live], atol=1e-5, rtol=1e-5)
    assert got[~live].abs().max().item() == 0.0


# ---------------------------------------------------------------------------
# ops dispatch and the kernel wrappers' refusals
# ---------------------------------------------------------------------------


def test_ops_route_cpu_tensors_to_the_plain_versions():
    """CPU tensors go to the plain versions and count no launch."""
    q, k, v = (torch.from_numpy(a)
               for a in _attn_inputs(1, 4, 2, 9, 20, 64, seed=1))
    before = dict(ops.launches)
    got = ops.flash_attention(q, k, v, window=6, q_offset=11)
    torch.testing.assert_close(
        got, ref.attention_ref(q, k, v, window=6, q_offset=11),
        atol=0.0, rtol=0.0)
    dq, dk, dv = (torch.from_numpy(a)
                  for a in _decode_inputs(3, 4, 2, 16, 64, seed=2))
    lengths = torch.tensor([1, 16, 9], dtype=torch.int32)
    torch.testing.assert_close(ops.flash_decode(dq, dk, dv, lengths),
                               ref.decode_ref(dq, dk, dv, lengths),
                               atol=0.0, rtol=0.0)
    assert ops.launches == before


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The kernel entries never serve a CPU tensor (no fallback) and
    reject dtypes they are not instantiated for."""
    q, k, v = (torch.from_numpy(a)
               for a in _attn_inputs(1, 4, 2, 8, 8, 64, seed=3))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q, k, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention.flash_attention(q.half(), k.half(), v.half())
    dq, dk, dv = (torch.from_numpy(a)
                  for a in _decode_inputs(2, 4, 2, 8, 64, seed=4))
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.flash_decode(dq, dk, dv, 3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        decode_attention.flash_decode(dq.half(), dk.half(), dv.half(), 3)


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on a card)
# ---------------------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")


# (B, H, KV, Sq, Skv, hd, window, q_offset): the main path's shapes (with
# the closed loop's last 16-token chunk of a 64-token prompt at qwen2's
# heads and at starcoder2-3b's G 12), then hd 64 / 128 / 256 at G 1 / 6 / 16 with a window
# that bites inside a key tile, a deep query offset, and rows with no
# valid key (Sq past Skv + window - 1)
ATTN_CUDA_CASES = {
    "rg": (1, 16, 1, 128, 128, 256, 2048, 0),
    "qwen2-chunk": (1, 12, 2, 64, 240, 128, None, 64),
    "qwen2-closedloop-chunk": (1, 12, 2, 16, 144, 128, None, 48),
    "starcoder2-chunk": (1, 24, 2, 16, 144, 128, None, 48),
    "ragged": (2, 4, 4, 37, 37, 64, 5, 0),
    # the dense prefills of llava-next-mistral-7b (576 patches + a
    # 64-token prompt) and musicgen-large (MHA at hd 64, 128 tokens)
    "llava-prefill": (1, 32, 8, 640, 640, 128, None, 0),
    "musicgen-prefill": (1, 32, 32, 128, 128, 64, None, 0),
    # the crash drill's paged qwen2 chunk against a 7 x 16-token table and
    # recurrentgemma's dense 64- and 16-token prompts; the chaos and
    # stress benches' 8-token chunks at qwen2's and starcoder2-3b's heads
    "qwen2-crash-chunk": (1, 12, 2, 16, 112, 128, None, 48),
    "rg-crash-prefill": (1, 16, 1, 64, 64, 256, 2048, 0),
    "rg-crash-gate": (1, 16, 1, 16, 16, 256, 2048, 0),
    "qwen2-chaos-chunk": (1, 12, 2, 8, 112, 128, None, 8),
    "starcoder2-chaos-chunk": (1, 24, 2, 8, 112, 128, None, 8),
}
for _hd in (64, 128, 256):
    for _G in (1, 6, 16):
        ATTN_CUDA_CASES[f"hd{_hd}_g{_G}_window"] = (2, 2 * _G, 2, 150, 150,
                                                   _hd, 13, 0)
        ATTN_CUDA_CASES[f"hd{_hd}_g{_G}_offset"] = (1, 2 * _G, 2, 40, 700,
                                                   _hd, None, 650)
        ATTN_CUDA_CASES[f"hd{_hd}_g{_G}_empty_rows"] = (1, _G, 1, 60, 20,
                                                       _hd, 8, 0)
    # split 1 with every key in one tile (one stage)
    ATTN_CUDA_CASES[f"hd{_hd}_one_tile"] = (17, 16, 1, 32, 32, _hd, None, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ATTN_CUDA_CASES))
def test_cuda_flash_attention_matches_plain_version(case, dtype):
    """The kernel against ``attention_ref`` on rows with a valid key; rows
    with none give zeros though the output memory was NaN beforehand; a
    CUDA-graph replay equals the eager call bit for bit."""
    _needs_card()
    B, H, KV, Sq, Skv, hd, win, off = ATTN_CUDA_CASES[case]
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dev, dt)
               for a in _attn_inputs(B, H, KV, Sq, Skv, hd, seed=9))
    # the model passes (B, S, H, hd) projections as transposed views
    q = q.transpose(1, 2).contiguous().transpose(1, 2)

    def call():
        return flash_attention.flash_attention(q, k, v, window=win,
                                               q_offset=off)

    # NaN where the wrapper's output will be allocated
    torch.full((B, Sq, H, hd), float("nan"), dtype=dt, device=dev)
    got = call()
    torch.cuda.synchronize()
    want = ref.attention_ref(q, k, v, window=win, q_offset=off)
    pos = off + torch.arange(Sq, device=dev)[:, None]
    keys = torch.arange(Skv, device=dev)[None]
    seen = keys <= pos
    if win is not None:
        seen &= keys > pos - win
    live = seen.any(1)
    assert torch.isfinite(got).all()
    err = (got[:, :, live].float() - want[:, :, live].float()).abs().max()
    assert err.item() <= TOL[dtype]
    if not live.all():
        assert got[:, :, ~live].abs().max().item() == 0.0
    assert torch.equal(graph_replay(call), got)


# (H, KV, S, hd): recurrentgemma's dense round and its full 2048 ring,
# qwen2's G = 6 at hd 128, G = 1 at hd 64, and the dense rounds of
# llava-next-mistral-7b (a 672-slot ring) and musicgen-large (160 slots),
# and the crash drill's 76-slot recurrentgemma ring
DECODE_CUDA_CASES = {"rg_round": (16, 1, 160, 256),
                     "rg_crash_ring": (16, 1, 76, 256),
                     "rg_ring_2048": (16, 1, 2048, 256),
                     "g6_hd128": (12, 2, 256, 128),
                     "g1_hd64": (4, 4, 96, 64),
                     "llava_round": (32, 8, 672, 128),
                     "musicgen_round": (32, 32, 160, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DECODE_CUDA_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_decode_matches_plain_version(dtype, case):
    """Lanes at and around the plan's split boundaries match the plain
    version, with the output's and the partials' memory NaN beforehand;
    length-0 lanes, and a call with every lane empty, give zeros; a
    CUDA-graph replay equals the eager call bit for bit."""
    _needs_card()
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    H, KV, S, hd = DECODE_CUDA_CASES[case]
    per, n_splits = decode_attention.split_plan(6, KV, S,
                                                decode_attention.TILE)
    lengths = torch.tensor(boundary_lengths(per, S), dtype=torch.int32,
                           device=dev)
    q, k, v = (torch.from_numpy(a).to(dev, dt) for a in _decode_inputs(
        len(lengths), H, KV, S, hd, seed=6))

    def call(n=lengths):
        return decode_attention.flash_decode(q, k, v, n)

    poison_cache(q, n_splits)
    got = call()
    torch.cuda.synchronize()
    want = ref.decode_ref(q, k, v, lengths)
    live = lengths > 0
    assert torch.isfinite(got).all()
    err = (got[live].float() - want[live].float()).abs().max().item()
    assert err <= TOL[dtype]
    assert got[~live].abs().max().item() == 0.0
    assert call(torch.zeros_like(lengths)).abs().max().item() == 0.0
    assert torch.equal(graph_replay(call), got)
