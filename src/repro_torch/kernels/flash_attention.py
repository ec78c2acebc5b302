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
at position ``q_offset + i``), which paged prefill chunks need.  The TPU
kernel's tile sizes ``bq``/``bk`` are gone: :func:`tile_plan` picks them
from shapes alone, so a call never waits for the device and can be
captured in a CUDA graph.  Its plain version is
``repro_torch.kernels.ref.attention_ref``; the dispatch between the two
lives in ``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 64       # query heads per KV head: a block's 64 rows
# an H100 block may use at most this much shared memory
MAX_SMEM = 232_448
# The plan's rule, from a sweep of the bf16 kernel on an H100 (PERF.md
# section 6): a block is 4 warps over 64 / split packed query rows, the
# keys of each 16-row group split over `split` warps; split 1 where it
# gives a wave of blocks (one per SM), else 4.
WAVE = 132
SPLITS = (1, 4)

_lib: Optional[ctypes.CDLL] = None


class TilePlan(NamedTuple):
    """How one call is cut into blocks.  A packed query row is (position,
    one of the G query heads of a KV head); a block of 4 warps holds
    ``rows`` of them, in groups of 16 whose keys are split over ``split``
    warps (each takes ``bk // split`` keys of a tile), and walks its keys
    in tiles of ``bk``, ``stages`` tiles in flight."""
    rows: int
    bk: int
    stages: int
    blocks: int
    smem: int        # dynamic shared-memory bytes per block

    @property
    def split(self) -> int:
        return 64 // self.rows

    @property
    def threads(self) -> int:
        return 128


def walk_smem(hd: int, split: int, keys: int, stages: int,
              dtype: torch.dtype) -> int:
    """Shared memory of a block while it walks its keys, with ``keys``
    keys a warp: bf16 keeps the Q tile and ``stages`` K and V tiles in
    rows of hd + 8 values; f32 keeps Q as tf32 hi and lo (rows of hd + 8
    floats), K in rows of hd + 8 and V in rows of hd + 4."""
    rows, bk = 64 // split, split * keys
    if dtype == torch.float32:
        return 4 * (2 * rows * (hd + 8) + stages * bk * (2 * hd + 12))
    return 2 * (rows + 2 * stages * bk) * (hd + 8)


def warp_keys(hd: int, split: int, dtype: torch.dtype = torch.bfloat16
              ) -> int:
    """Keys one warp takes from each tile (``csrc/flash_attention.cu``
    warp_keys, tf32_warp_keys).  bf16: 64 at hd <= 128 and 32 at 256 (a
    warp's 16 x 256 output already holds 128 registers a thread) at split
    1, 16 at split 4.  f32, twice bf16's bytes: the most keys whose two
    stages leave room for a second block on an SM (64 / 16 at hd 64, 16 /
    8 at 128), and at hd 256, where none do, 16 / 8 (202 / 168 KB)."""
    if dtype != torch.float32:
        return (64 if hd <= 128 else 32) if split == 1 else 16
    return (64 if hd == 64 else 16) if split == 1 else (16 if hd == 64
                                                        else 8)


def mma_plan(B: int, KV: int, Sq: int, G: int, Skv: int, hd: int,
             split: int, dtype: torch.dtype = torch.bfloat16) -> TilePlan:
    """The plan with each 16-row group's keys over ``split`` warps: 64 //
    split rows a block, tiles of split x :func:`warp_keys` keys, two
    stages unless every key fits one tile; shared memory for the walk
    (:func:`walk_smem`) or the split's f32 merge, whichever is more."""
    rows = 64 // split
    keys = warp_keys(hd, split, dtype)
    stages = 1 if Skv <= split * keys else 2
    merge = 4 * (64 * (hd + 4) + 128) if split > 1 else 0
    return TilePlan(rows, split * keys, stages,
                    B * KV * -(-(Sq * G) // rows),
                    max(walk_smem(hd, split, keys, stages, dtype), merge))


def tile_plan(B: int, H: int, KV: int, Sq: int, Skv: int, hd: int,
              dtype: torch.dtype, window: Optional[int] = None,
              q_offset: int = 0, causal: bool = True) -> TilePlan:
    """The grid of one call, from shapes only: never from tensor values.

    :func:`mma_plan` with the smallest split of :data:`SPLITS` that keeps
    a wave of :data:`WAVE` blocks (else the largest), in either dtype.

    The mask's arguments (``window``, ``q_offset``, ``causal``) are
    checked but do not change the plan: each block computes its own key
    range from them."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    return _shape_plan(B, H, KV, Sq, Skv, hd, dtype)


@functools.lru_cache(maxsize=1024)
def _shape_plan(B: int, H: int, KV: int, Sq: int, Skv: int, hd: int,
                dtype: torch.dtype) -> TilePlan:
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{dtype}")
    if KV <= 0 or H < KV or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"{H} query heads over {KV} KV heads: need a "
                         f"multiple of at most {MAX_GROUP}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if min(B, Sq, Skv) < 0:
        raise ValueError(f"bad sizes: B {B}, Sq {Sq}, Skv {Skv}")
    plans = [mma_plan(B, KV, Sq, H // KV, Skv, hd, s, dtype)
             for s in SPLITS]
    plan = next((p for p in plans if p.blocks >= WAVE), plans[-1])
    if plan.smem > MAX_SMEM or plan.blocks >= 2 ** 31:
        raise ValueError(f"no plan fits the card: {plan.blocks} blocks of "
                         f"{plan.smem} bytes of shared memory")
    return plan


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build(SOURCE)))
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_flash_attention.argtypes = ([ci] + [vp] * 4 + [cl] * 12
                                              + [ci] * 9 + [ctypes.c_float]
                                              + [ci, vp])
        lib.repro_flash_attention.restype = ci
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
    zeros.  One kernel launch on the current stream, cut by
    :func:`tile_plan`, without synchronising."""
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
    plan = tile_plan(B, H, KV, Sq, Skv, hd, q.dtype, window, q_offset,
                     causal)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if plan.blocks == 0:
        return out
    lib = _library()
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), *strides, B, H, KV, Sq, Skv, hd, int(causal),
            -1 if window is None else int(window), int(q_offset),
            1.0 / math.sqrt(hd), plan.split, stream)
    if err != 0:
        msg = lib.repro_flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err} ({msg})")
    return out
