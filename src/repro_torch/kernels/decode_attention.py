"""Build and binding of the Hopper paged flash-decode kernel.

Port of ``repro/kernels/decode_attention.py::paged_flash_decode``.  The
kernel is CUDA C++ (``csrc/paged_decode.cu``), compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface at first use
(``kernels/build.py``) and loaded with ``ctypes``.  Nothing here runs when
the module is imported: the CPU tests import it on machines without
``nvcc``.

:func:`paged_flash_decode` launches the kernel on CUDA tensors only and
raises on anything it does not take.  Its plain version is
``repro_torch.kernels.ref.paged_decode_ref``; the dispatch between the two
lives in ``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build as _build

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "paged_decode.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# an H100 block may use at most this much shared memory
_MAX_SMEM = 232_448

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build(SOURCE)))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.repro_paged_decode.argtypes = [ci, vp, vp, vp, vp, vp, vp,
                                           ci, ci, ci, ci, ci, ci, ci,
                                           ctypes.c_float, vp]
        lib.repro_paged_decode.restype = ci
        lib.repro_paged_decode_smem_bytes.argtypes = [ci, ci, ci]
        lib.repro_paged_decode_smem_bytes.restype = ctypes.c_longlong
        lib.repro_paged_decode_max_chunks.argtypes = []
        lib.repro_paged_decode_max_chunks.restype = ci
        lib.repro_cuda_error_string.argtypes = [ci]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       lengths) -> torch.Tensor:
    """Launch the CUDA kernel: q (B,H,hd); pools (P,KV,ps,hd); tables
    (B,W) int32; lengths (B,) int32 (or a scalar, broadcast).  Returns
    (B,H,hd) in q's dtype; a lane of length 0 gives zeros.  Launches on
    the current stream without synchronising."""
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
    if not torch.is_tensor(lengths) or lengths.dim() == 0:
        lengths = torch.full((B,), int(lengths), dtype=torch.int32,
                             device=q.device)
    _check(lengths, "lengths", torch.int32)
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    # the kernel reads K/V in 16-byte chunks, hd / vec of them per token,
    # reduced across that many threads of one warp
    vec = 16 // q.element_size()
    parts = hd // vec
    if hd % vec or parts & (parts - 1) or parts > 32:
        raise ValueError(f"head_dim {hd} must be {vec} x a power of two "
                         f"<= 32 for {q.dtype}")
    for t, name in ((k_pages, "k_pages"), (v_pages, "v_pages")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = _library()
    if ps * parts > lib.repro_paged_decode_max_chunks():
        raise ValueError(f"a page of {ps} x {hd} {q.dtype} is too large "
                         f"for one block's registers")
    G = H // KV
    smem = lib.repro_paged_decode_smem_bytes(G, ps, hd)
    if smem > _MAX_SMEM:
        raise ValueError(f"G={G}, page_size={ps}, head_dim={hd} needs "
                         f"{smem} bytes of shared memory per block")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_paged_decode(
            _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, H, KV, P, ps, hd, block_tables.shape[1],
            1.0 / math.sqrt(hd), stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"paged_flash_decode launch failed: CUDA error "
                           f"{err} ({msg})")
    return out
