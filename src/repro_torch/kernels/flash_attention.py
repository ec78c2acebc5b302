"""Build and binding of the Hopper flash-attention kernel.

Port of ``repro/kernels/flash_attention.py::flash_attention``.  The
kernel is CUDA C++ (``csrc/flash_attention.cu``), compiled with ``nvcc``
for ``sm_90a`` at first use (``kernels/build.py``) and loaded with
``ctypes``.  Nothing here runs when the module is imported: the CPU tests
import it on machines without ``nvcc``.

:func:`flash_attention` launches the kernel on CUDA tensors only and
raises on anything it does not take.  It keeps the reference's layouts,
q (B, H, Sq, hd) and k, v (B, KV, Skv, hd), but takes any strides with a
unit last stride, so the model's (B, S, H, hd) projections pass as
transposed views without a copy.  It adds a query offset (query i sits
at position ``q_offset + i``), which paged prefill chunks need; the TPU
kernel's tile sizes ``bq``/``bk`` are gone: the kernel picks its own.
Its plain version is ``repro_torch.kernels.ref.attention_ref``; the
dispatch between the two lives in ``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 64       # query heads per KV head: one block's 64 query rows
# an H100 block may use at most this much shared memory
_MAX_SMEM = 232_448

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build(SOURCE)))
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_flash_attention.argtypes = ([ci] + [vp] * 4 + [cl] * 12
                                              + [ci] * 9
                                              + [ctypes.c_float, vp])
        lib.repro_flash_attention.restype = ci
        lib.repro_flash_attention_smem_bytes.argtypes = [ci]
        lib.repro_flash_attention_smem_bytes.restype = ctypes.c_longlong
        lib.repro_flash_attention_error_string.argtypes = [ci]
        lib.repro_flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 4 or t.stride(-1) != 1:
        raise ValueError(f"{name} must be 4-d with a unit last stride, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")
    size = t.element_size()
    if t.data_ptr() % 16 or any(s * size % 16 for s in t.stride()[:3]):
        raise ValueError(f"{name}'s rows must be 16-byte aligned (strides "
                         f"{t.stride()})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel: q (B,H,Sq,hd); k, v (B,KV,Skv,hd), float32
    or bfloat16.  Returns (B,H,Sq,hd) in q's dtype, a transposed view of
    a contiguous (B,Sq,H,hd) tensor.  A query row with no valid key gives
    zeros.  Launches on the current stream without synchronising."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, name, q.dtype)
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if k.shape != (B, KV, Skv, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if KV == 0 or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"{H} query heads over {KV} KV heads: need a "
                         f"multiple of at most {MAX_GROUP}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if B * H * Sq == 0:
        return out
    lib = _library()
    if lib.repro_flash_attention_smem_bytes(hd) > _MAX_SMEM:
        raise ValueError(f"head_dim {hd} needs more shared memory than a "
                         f"block has")
    G = H // KV
    blocks = B * KV * -(-Sq // (64 // G))
    if blocks >= 2 ** 31:
        raise ValueError(f"{blocks} blocks exceed the grid")
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), *strides, B, H, KV, Sq, Skv, hd, int(causal),
            -1 if window is None else int(window), int(q_offset),
            1.0 / math.sqrt(hd), stream)
    if err != 0:
        msg = lib.repro_flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err} ({msg})")
    return out
