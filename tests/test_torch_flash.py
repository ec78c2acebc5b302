"""Port attention kernels: the plain ``attention_ref`` and ``decode_ref``
against the JAX oracles and the Pallas kernels (in interpret mode), the
query-offset variant against both packages' chunked attention, the ops
dispatch, and the CUDA kernels against their plain versions on a card.

Inputs are numpy arrays from a seed, fed to both packages.  The JAX
package is imported inside the parity tests only, so that the ``cuda``
tests also collect on a GPU machine without JAX
(``pytest -m cuda tests/test_torch_flash.py``).
"""
import numpy as np
import pytest
import torch

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,Sq,Skv,hd,win,off", [
    (1, 16, 1, 128, 128, 256, 2048, 0),    # recurrentgemma dense prefill
    (1, 12, 2, 64, 240, 128, None, 64),    # qwen2 paged prefill chunk
    (2, 4, 4, 37, 37, 64, 5, 0),           # ragged, G = 1, tight window
], ids=["rg", "qwen2-chunk", "ragged"])
def test_cuda_flash_attention_matches_plain_version(B, H, KV, Sq, Skv, hd,
                                                    win, off, dtype):
    _needs_card()
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dev, dt)
               for a in _attn_inputs(B, H, KV, Sq, Skv, hd, seed=9))
    # the model passes (B, S, H, hd) projections as transposed views
    q = q.transpose(1, 2).contiguous().transpose(1, 2)
    got = flash_attention.flash_attention(q, k, v, window=win, q_offset=off)
    torch.cuda.synchronize()
    want = ref.attention_ref(q, k, v, window=win, q_offset=off)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_decode_matches_plain_version(dtype):
    _needs_card()
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dev, dt)
               for a in _decode_inputs(4, 16, 1, 160, 256, seed=6))
    lengths = torch.tensor([1, 33, 160, 100], dtype=torch.int32, device=dev)
    got = decode_attention.flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    want = ref.decode_ref(q, k, v, lengths)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    zeros = decode_attention.flash_decode(q, k, v, torch.zeros_like(lengths))
    assert zeros.abs().max().item() == 0.0
