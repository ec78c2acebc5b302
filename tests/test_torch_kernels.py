"""Port kernels: the plain paged decode against the JAX Pallas kernel (in
interpret mode) and the JAX oracles, the ops dispatch, and the CUDA
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_cuda_kernel_matches_plain_version(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    dev = torch.device("cuda")
    lengths = [1, 7, 23, 48]
    q, kp, vp, tbl, lens = [t.to(dev) for t in _torch(
        *_case(4, 2, 12, 128, 16, 3, lengths))]
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    got = decode_attention.paged_flash_decode(q, kp, vp, tbl, lens)
    torch.cuda.synchronize()
    want = ref.paged_decode_ref(q, kp, vp, tbl, lens)
    assert (got.float() - want.float()).abs().max().item() <= tol
    zeros = decode_attention.paged_flash_decode(q, kp, vp, tbl,
                                                torch.zeros_like(lens))
    assert zeros.abs().max().item() == 0.0
