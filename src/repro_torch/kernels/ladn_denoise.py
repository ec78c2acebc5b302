"""Build and binding of the Hopper fused LADN reverse-chain kernel.

Port of ``repro/kernels/ladn_denoise.py::ladn_denoise_fused``.  The kernel
is CUDA C++ (``csrc/ladn_denoise.cu``), compiled with ``nvcc`` for
``sm_90a`` at first use (``kernels/build.py``) and loaded with ``ctypes``.
It runs the whole I-step chain of Eqn 10 for G stacked agents' rows in one
launch; the rows' shapes are ``(G, T, ...)``.  Unlike the TPU kernel it
takes the weights unpadded (no 128-lane tiles, no row blocks), and the
first layer's two slices as views of the stacked weight.

:func:`plan` picks the kernel's instantiation (a width class of 24 or 32,
held in registers, or 64 / 128, staged in shared memory), the rows a
block, the grid and the shared memory from shapes alone, so a call never
waits for the device and can be captured in a CUDA graph.
:func:`ladn_denoise_fused` launches it on CUDA tensors only and raises on
anything it does not take.
Its plain version is ``repro_torch.kernels.ref.ladn_denoise_ref``; the
dispatch between the two lives in ``repro_torch.kernels.ops``.  The kernel
has no backward (nor has the TPU kernel): its output carries no gradient.
:func:`noop` launches the library's empty kernel, the floor a launch of
this library costs.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.diffusion import DiffusionSchedule
from repro_torch.kernels import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ladn_denoise.cu"
MAX_STEPS = 16       # I
MAX_WIDTH = 128      # A, S and H each
MAX_AGENTS = 65535   # G: the grid's second dimension
# the kernel's width classes: up to 32 a row's weights stay in registers
# (24 for the LAD-TS configurations' hidden width 20: in place of 32 it
# cut 242 registers to 168 and ran the update shape 1.8x faster on an
# H100, PERF.md section 6); 64 and 128 stage an agent's weights in shared
# memory
REGS_WIDTHS = (24, 32)
WIDTHS = REGS_WIDTHS + (64, 128)
# rows (one warp each) a block: the register kernel's rows share nothing
# (1, 2 and 4 rows timed alike); the shared-memory kernel stages an
# agent's weights once for 4 rows
SMEM_ROWS = 4
# an H100 block may use at most this much shared memory
MAX_SMEM = 232_448

_lib: Optional[ctypes.CDLL] = None
# (schedule bytes, paper_variance) -> the folded constants as a C array
_consts: dict = {}


class Plan(NamedTuple):
    """How one call is cut: the ``width`` class's kernel (registers up to
    32, shared memory above), ``rows`` warps (one row each) a block,
    ``blocks`` row tiles of each of ``agents`` agents, ``smem`` dynamic
    shared-memory bytes a block."""
    width: int
    rows: int
    blocks: int
    agents: int
    smem: int

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.blocks, self.agents)

    @property
    def threads(self) -> int:
        return 32 * self.rows

    @property
    def kernel(self) -> str:
        kind = "regs" if self.width in REGS_WIDTHS else "smem"
        return f"ladn_{kind}_kernel<{self.width}>"


def _pad32(n: int) -> int:
    return -(-n // 32) * 32


def smem_bytes(width: int, A: int, H: int, I: int) -> int:  # noqa: E741
    """Shared memory of one block (``csrc/ladn_denoise.cu`` smem_floats):
    none for the register kernel; else w1x, w2 and w3 zero-padded to
    multiples of 32, temb_w1 and the three biases."""
    if width in REGS_WIDTHS:
        return 0
    Ap, Hp = _pad32(A), _pad32(H)
    return 4 * (Ap * Hp + Hp * Hp + Hp * Ap + I * Hp + 2 * Hp + Ap)


@functools.lru_cache(maxsize=256)
def plan(G: int, T: int, A: int, S: int, H: int,
         I: int) -> Plan:  # noqa: E741
    """The launch of one call, from shapes only: the smallest width class
    of :data:`WIDTHS` that holds A, S and H; one row a block for the
    register kernel, :data:`SMEM_ROWS` (at most T) for the shared-memory
    kernel; ``ceil(T / rows)`` row tiles of each agent."""
    if not 0 < I <= MAX_STEPS:
        raise ValueError(f"the kernel runs 1..{MAX_STEPS} steps, got {I}")
    if min(A, S, H) < 1 or max(A, S, H) > MAX_WIDTH:
        raise ValueError(f"widths A={A} S={S} H={H} must lie in "
                         f"1..{MAX_WIDTH}")
    if not 0 < G <= MAX_AGENTS:
        raise ValueError(f"G={G} agents must lie in 1..{MAX_AGENTS}")
    if T < 1:
        raise ValueError(f"T={T} rows: need at least one")
    width = next(w for w in WIDTHS if max(A, S, H) <= w)
    rows = 1 if width in REGS_WIDTHS else min(SMEM_ROWS, T)
    smem = smem_bytes(width, A, H, I)
    if smem > MAX_SMEM:
        raise ValueError(f"A={A} H={H} I={I} needs {smem} bytes of shared "
                         f"memory per block")
    return Plan(width, rows, -(-T // rows), G, smem)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build(SOURCE)))
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_ladn_denoise.argtypes = ([vp] * 6 + [cl] * 2 + [vp] * 6
                                           + [ci] * 8 + [vp, vp])
        lib.repro_ladn_denoise.restype = ci
        lib.repro_ladn_denoise_smem_bytes.argtypes = [ci] * 4
        lib.repro_ladn_denoise_smem_bytes.restype = cl
        lib.repro_ladn_noop.argtypes = [vp]
        lib.repro_ladn_noop.restype = ci
        lib.repro_ladn_cuda_error_string.argtypes = [ci]
        lib.repro_ladn_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def step_consts(sched: DiffusionSchedule, paper_variance: bool = True
                ) -> List[Tuple[float, float, float]]:
    """Per-step ``(lambda_i^-1/2, beta_i / sqrt(1 - lambda_bar_i), noise
    scale)`` for step = 0..I-1 (i = I - step), folded on the host as the
    TPU kernel folds them into immediates; no noise at i = 1."""
    I = sched.num_steps  # noqa: E741
    consts = []
    for step in range(I):
        idx = I - step - 1
        beta = float(sched.betas[idx])
        lam = float(sched.lambdas[idx])
        lbar = float(sched.lambda_bars[idx])
        btil = float(sched.beta_tildes[idx])
        scale = (btil / 2.0) if paper_variance else (btil ** 0.5)
        if idx == 0:
            scale = 0.0
        consts.append((lam ** -0.5, beta / (1.0 - lbar) ** 0.5, scale))
    return consts


def _folded_consts(sched: DiffusionSchedule, paper_variance: bool = True):
    """:func:`step_consts` as the C array the kernel takes, folded once
    per schedule and ``paper_variance``."""
    key = (paper_variance,) + tuple(np.asarray(a).tobytes() for a in sched)
    arr = _consts.get(key)
    if arr is None:
        flat = [c for step in step_consts(sched, paper_variance)
                for c in step]
        arr = _consts[key] = (ctypes.c_float * len(flat))(*flat)
    return arr


def _check(t: torch.Tensor, name: str, shape: tuple,
           rows_only: bool = False) -> None:
    """A CUDA f32 tensor of ``shape``, contiguous (``rows_only``: each
    agent's rows contiguous, any agent stride)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if rows_only:
        if t.stride()[1:] != (shape[2], 1) or t.stride(0) < 0:
            raise ValueError(f"{name} must have contiguous rows, got "
                             f"strides {t.stride()}")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ladn_denoise_fused(x_I, s, noise, temb_w1, w1x, w1s, b1, w2, b2, w3, b3,
                       sched: DiffusionSchedule,
                       paper_variance: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel: x_I (G,T,A), s (G,T,S), noise (G,T,I,A),
    temb_w1 (G,I,H), w1x (G,A,H), w1s (G,S,H), b1 (G,H), w2 (G,H,H),
    b2 (G,H), w3 (G,H,A), b3 (G,A), all f32 on one card; each contiguous
    except w1x and w1s, which need contiguous rows only (slices of the
    stacked first-layer weight serve as they are).  ``sched`` is the numpy
    schedule (``make_schedule_np``).  Returns x_0 (G,T,A).  Launches on
    the current stream, as :func:`plan` cuts it, without synchronising."""
    G, T, A = x_I.shape
    S = s.shape[-1]
    H = w2.shape[-1]
    I = sched.num_steps  # noqa: E741
    if not (0 < I <= MAX_STEPS):
        raise ValueError(f"the kernel runs 1..{MAX_STEPS} steps, got {I}")
    for t, name, shape in (
            (x_I, "x_I", (G, T, A)), (s, "s", (G, T, S)),
            (noise, "noise", (G, T, I, A)), (temb_w1, "temb_w1", (G, I, H)),
            (b1, "b1", (G, H)), (w2, "w2", (G, H, H)), (b2, "b2", (G, H)),
            (w3, "w3", (G, H, A)), (b3, "b3", (G, A))):
        _check(t, name, shape)
    _check(w1x, "w1x", (G, A, H), rows_only=True)
    _check(w1s, "w1s", (G, S, H), rows_only=True)
    devices = {t.device for t in (x_I, s, noise, temb_w1, w1x, w1s, b1, w2,
                                  b2, w3, b3)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    out = torch.empty_like(x_I)
    if G == 0 or T == 0:
        return out
    p = plan(G, T, A, S, H, I)
    lib = _library()
    consts = _folded_consts(sched, paper_variance)
    with torch.cuda.device(x_I.device):
        stream = torch.cuda.current_stream(x_I.device).cuda_stream
        err = lib.repro_ladn_denoise(
            x_I.data_ptr(), s.data_ptr(), noise.data_ptr(),
            temb_w1.data_ptr(), w1x.data_ptr(), w1s.data_ptr(),
            w1x.stride(0), w1s.stride(0), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
            G, T, A, S, H, I, p.width, p.rows, consts, stream)
    if err != 0:
        msg = lib.repro_ladn_cuda_error_string(err).decode()
        raise RuntimeError(f"ladn_denoise launch failed: CUDA error {err} "
                           f"({msg})")
    return out


def noop(device=None) -> None:
    """Launch the library's empty kernel (one warp) on the current stream
    of ``device``: what any launch of this library costs at least."""
    lib = _library()
    with torch.cuda.device(device):
        err = lib.repro_ladn_noop(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.repro_ladn_cuda_error_string(err).decode()
        raise RuntimeError(f"ladn_noop launch failed: CUDA error {err} "
                           f"({msg})")
