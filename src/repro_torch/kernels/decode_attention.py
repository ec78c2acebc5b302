"""Build and binding of the Hopper decode kernels.

Port of ``repro/kernels/decode_attention.py``: ``paged_flash_decode``
(one query token per lane against the shared page pool) and
``flash_decode`` (one query token per lane against a dense per-lane
cache).  Each is CUDA C++ (``csrc/paged_decode.cu``,
``csrc/flash_decode.cu``, both on the split-K design of
``csrc/decode_split.cuh``), compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use
(``kernels/build.py``) and loaded with ``ctypes``.  Nothing here runs when
the module is imported: the CPU tests import it on machines without
``nvcc``.

Split-K: each lane's cache is cut into splits by :func:`split_plan`, from
shapes only, so that a call never waits for the device and can be
captured in a CUDA graph.  A call launches a split kernel (one block per
lane, KV head, 16 query heads and split, writing partial softmax states
into a workspace the wrapper allocates) and a merge kernel (one block per
query row, combining the partials of the splits that start below the
lane's length).

:func:`flash_decode_partials` and :func:`decode_merge` launch the two
passes of :func:`flash_decode` apart, for a ring cut along its positions
over several ranks: each rank's partials (an empty one for every split it
skips) are all-gathered and merged all together.

:func:`paged_flash_decode` and :func:`flash_decode` launch their kernels
on CUDA tensors only and raise on anything they do not take.  Their plain
versions are ``repro_torch.kernels.ref.paged_decode_ref`` and
``decode_ref``; the dispatch between kernel and plain version lives in
``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build as _build

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "paged_decode.cu"
FLASH_DECODE_SOURCE = _HERE / "csrc" / "flash_decode.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# an H100 block may use at most this much shared memory
_MAX_SMEM = 232_448
# the split kernel's geometry (csrc/decode_split.cuh): 32-position tiles,
# head_dim a multiple of 16 and at most 256
TILE = 32
MAX_HEAD_DIM = 256
# The split plan's rule, from a sweep on an H100 (PERF.md section 6):
# split blocks a call aims for (two per SM of 132), and the most positions
# a split holds (two tiles), so that a lane of a long cache gets more
# splits rather than longer ones.
SPLIT_BLOCKS = 264
MAX_SPLIT = 2 * TILE

_lib: Optional[ctypes.CDLL] = None
_flash_lib: Optional[ctypes.CDLL] = None


def split_plan(B: int, KV: int, n_positions: int,
               unit: int) -> Tuple[int, int]:
    """(positions per split, number of splits) for ``B`` lanes x ``KV``
    heads over a cache of ``n_positions`` (the ring depth S, or the block
    table's W x page_size), from shapes only: never from the lengths,
    which live on the device.

    A split is a whole number of ``unit`` positions (a tile of the dense
    cache, a page of the pool): as few as keep ``B * KV * n_splits``
    within :data:`SPLIT_BLOCKS`, but no more than :data:`MAX_SPLIT`
    positions (at least one unit) and no more than 65535 splits (the
    grid's limit).  Split s covers positions [s * per_split,
    (s + 1) * per_split); the kernel skips any split that starts at or
    past its lane's length."""
    units = -(-n_positions // unit)
    most = min(65535, max(1, SPLIT_BLOCKS // max(1, B * KV)))
    per = min(-(-units // most), max(1, MAX_SPLIT // unit))
    per = max(1, per, -(-units // 65535))
    return per * unit, -(-units // per)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build(SOURCE)))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.repro_paged_decode.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp,
                                           ci, ci, ci, ci, ci, ci, ci, ci,
                                           ci, ctypes.c_float, vp]
        lib.repro_paged_decode.restype = ci
        lib.repro_paged_decode_smem_bytes.argtypes = [ci, ci, ci]
        lib.repro_paged_decode_smem_bytes.restype = ctypes.c_longlong
        lib.repro_cuda_error_string.argtypes = [ci]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _flash_library() -> ctypes.CDLL:
    global _flash_lib
    if _flash_lib is None:
        lib = ctypes.CDLL(str(_build.build(FLASH_DECODE_SOURCE)))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.repro_flash_decode.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci,
                                           ci, ci, ci, ci, ci, ci,
                                           ctypes.c_float, vp]
        lib.repro_flash_decode.restype = ci
        lib.repro_flash_decode_partials.argtypes = [
            ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
            ctypes.c_float, vp]
        lib.repro_flash_decode_partials.restype = ci
        lib.repro_decode_merge.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci,
                                           ci, ci, vp]
        lib.repro_decode_merge.restype = ci
        lib.repro_flash_decode_smem_bytes.argtypes = [ci, ci, ci]
        lib.repro_flash_decode_smem_bytes.restype = ctypes.c_longlong
        lib.repro_flash_decode_error_string.argtypes = [ci]
        lib.repro_flash_decode_error_string.restype = ctypes.c_char_p
        _flash_lib = lib
    return _flash_lib


def _check(t: torch.Tensor, name: str, dtype=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")


def _lengths(lengths, B: int, device, name: str) -> torch.Tensor:
    """An int, a 0-d tensor or a (B,) int32 CUDA tensor, as (B,) int32."""
    if not torch.is_tensor(lengths) or lengths.dim() == 0:
        lengths = torch.full((B,), int(lengths), dtype=torch.int32,
                             device=device)
    _check(lengths, name, torch.int32)
    if lengths.shape != (B,):
        raise ValueError(f"{name} must be ({B},), got "
                         f"{tuple(lengths.shape)}")
    return lengths


def _split_setup(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 KV: int, n_positions: int, unit: int, smem_bytes,
                 workspace: bool = True):
    """The checks both kernels share, the split plan, and the partials'
    workspace: (per_split, n_splits, workspace or None).  The workspace is
    one f32 ``torch.empty`` holding acc (B, KV, n_splits, G, hd), then m
    and l (B, KV, n_splits, G); the kernels write every entry the merge
    reads."""
    B, H, hd = q.shape
    if hd % 16 or not 16 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} must be a multiple of 16 and at "
                         f"most {MAX_HEAD_DIM}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    per_split, n_splits = split_plan(B, KV, n_positions, unit)
    smem = smem_bytes(hd, q.element_size(), per_split)
    if smem > _MAX_SMEM:
        raise ValueError(f"head_dim {hd} needs {smem} bytes of shared "
                         f"memory per block")
    ws = (torch.empty(B * H * n_splits * (hd + 2), dtype=torch.float32,
                      device=q.device) if workspace else None)
    return per_split, n_splits, ws


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       lengths) -> torch.Tensor:
    """Launch the CUDA kernels: q (B,H,hd); pools (P,KV,ps,hd); tables
    (B,W) int32; lengths (B,) int32 (or a scalar, broadcast).  Returns
    (B,H,hd) in q's dtype; a lane of length 0 gives zeros.

    One call is two kernel launches on the current stream (the split
    blocks of :func:`split_plan` over the table's W x ps positions, then
    the merge), made by one ``ctypes`` call, without synchronising."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_flash_decode takes float32 or bfloat16, "
                        f"got {q.dtype}")
    for t, name in ((q, "q"), (k_pages, "k_pages"), (v_pages, "v_pages")):
        _check(t, name, q.dtype)
    _check(block_tables, "block_tables", torch.int32)
    B, H, hd = q.shape
    P, KV, ps, hd_k = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_k != hd:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be ({B}, W), got "
                         f"{tuple(block_tables.shape)}")
    lengths = _lengths(lengths, B, q.device, "lengths")
    out = torch.empty_like(q)
    W = block_tables.shape[1]
    if B == 0 or W == 0:
        return out.zero_()
    lib = _library()
    per_split, n_splits, ws = _split_setup(
        q, k_pages, v_pages, KV, W * ps, ps,
        lib.repro_paged_decode_smem_bytes)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_paged_decode(
            _DTYPES[q.dtype], q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), ws.data_ptr(), B, H, KV, P,
            ps, hd, W, per_split, n_splits, 1.0 / math.sqrt(hd), stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"paged_flash_decode launch failed: CUDA error "
                           f"{err} ({msg})")
    return out


def _dense_checks(q, k_cache, v_cache, name: str):
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    for t, what in ((q, "q"), (k_cache, "k_cache"), (v_cache, "v_cache")):
        _check(t, what, q.dtype)
    B, H, hd = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != B or \
            k_cache.shape[3] != hd or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    KV = k_cache.shape[1]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV}")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, length) -> torch.Tensor:
    """Launch the CUDA kernels: q (B,H,hd); caches (B,KV,S,hd); length an
    int, a 0-d tensor or a (B,) int32 CUDA tensor of valid positions per
    lane (clamped to [0, S]).  Returns (B,H,hd) in q's dtype; a lane of
    length 0 gives zeros.

    One call is two kernel launches on the current stream (the split
    blocks of :func:`split_plan` over the S positions, then the merge),
    made by one ``ctypes`` call, without synchronising."""
    _dense_checks(q, k_cache, v_cache, "flash_decode")
    B, H, hd = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    length = _lengths(length, B, q.device, "length")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out.zero_()
    lib = _flash_library()
    per_split, n_splits, ws = _split_setup(
        q, k_cache, v_cache, KV, S, TILE,
        lib.repro_flash_decode_smem_bytes)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_decode(
            _DTYPES[q.dtype], q.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), length.data_ptr(),
            out.data_ptr(), ws.data_ptr(), B, H, KV, S, hd, per_split,
            n_splits, 1.0 / math.sqrt(hd), stream)
    if err != 0:
        msg = lib.repro_flash_decode_error_string(err).decode()
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err} "
                           f"({msg})")
    return out


def flash_decode_partials(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, length
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The split pass of :func:`flash_decode` alone, for one rank's slice
    of a ring cut along its positions: q (B,H,hd); caches (B,KV,S,hd);
    length as for :func:`flash_decode`.  Returns the f32 partials of
    :func:`split_plan`'s splits over the S positions, acc
    (B,KV,n_splits,G,hd), m and l (B,KV,n_splits,G): per split the
    running max of its scaled scores, the sum of their exponentials and
    the unnormalised sum of V rows they weight; a split at or past the
    lane's length gives m = -inf, l = 0, acc = 0.  One kernel launch on
    the current stream, without synchronising."""
    _dense_checks(q, k_cache, v_cache, "flash_decode_partials")
    B, H, hd = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    length = _lengths(length, B, q.device, "length")
    if B == 0 or S == 0:
        raise ValueError(f"flash_decode_partials needs lanes and positions,"
                         f" got B {B}, S {S}")
    lib = _flash_library()
    per_split, n_splits, _ = _split_setup(
        q, k_cache, v_cache, KV, S, TILE, lib.repro_flash_decode_smem_bytes,
        workspace=False)
    acc = torch.empty((B, KV, n_splits, G, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.empty((B, KV, n_splits, G), dtype=torch.float32,
                    device=q.device)
    l = torch.empty_like(m)  # noqa: E741
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_decode_partials(
            _DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), length.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), B, H, KV, S, hd, per_split,
            n_splits, 1.0 / math.sqrt(hd), stream)
    if err != 0:
        msg = lib.repro_flash_decode_error_string(err).decode()
        raise RuntimeError(f"flash_decode_partials launch failed: CUDA "
                           f"error {err} ({msg})")
    return acc, m, l


def decode_merge(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The merge pass of :func:`flash_decode` alone, over every partial
    it is given: acc (B,KV,N,G,hd), m and l (B,KV,N,G), f32 (the
    gathered partials of :func:`flash_decode_partials` over the slices of
    a ring).  Returns (B,KV*G,hd) in ``dtype`` (float32 or bfloat16):
    sum_s exp(m_s - M) acc_s / sum_s exp(m_s - M) l_s, M = max_s m_s, an
    empty partial weighing nothing, zeros where every partial is empty.
    One kernel launch on the current stream, without synchronising."""
    if dtype not in _DTYPES:
        raise TypeError(f"decode_merge writes float32 or bfloat16, got "
                        f"{dtype}")
    for t, name in ((acc, "acc"), (m, "m"), (l, "l")):
        _check(t, name, torch.float32)
    if acc.dim() != 5 or m.shape != acc.shape[:4] or l.shape != m.shape:
        raise ValueError(f"partials acc {tuple(acc.shape)}, m "
                         f"{tuple(m.shape)}, l {tuple(l.shape)} do not fit")
    B, KV, N, G, hd = acc.shape
    if hd % 16 or not 16 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} must be a multiple of 16 and at "
                         f"most {MAX_HEAD_DIM}")
    out = torch.empty((B, KV * G, hd), dtype=dtype, device=acc.device)
    if B == 0 or N == 0:
        return out.zero_()
    lib = _flash_library()
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = lib.repro_decode_merge(
            _DTYPES[dtype], acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            out.data_ptr(), B, KV, G, hd, N, stream)
    if err != 0:
        msg = lib.repro_flash_decode_error_string(err).decode()
        raise RuntimeError(f"decode_merge launch failed: CUDA error {err} "
                           f"({msg})")
    return out
