"""Build and binding of the Hopper fused LADN reverse-chain kernel.

Port of ``repro/kernels/ladn_denoise.py::ladn_denoise_fused``.  The kernel
is CUDA C++ (``csrc/ladn_denoise.cu``), compiled with ``nvcc`` for
``sm_90a`` at first use (``kernels/build.py``) and loaded with ``ctypes``.
It runs the whole I-step chain of Eqn 10 for G stacked agents' rows in one
launch; the rows' shapes are ``(G, T, ...)``.  Unlike the TPU kernel it
takes the weights unpadded (no 128-lane tiles, no row blocks).

:func:`ladn_denoise_fused` launches it on CUDA tensors only and raises on
anything it does not take.  Its plain version is
``repro_torch.kernels.ref.ladn_denoise_ref``; the dispatch between the two
lives in ``repro_torch.kernels.ops``.  The kernel has no backward (nor has
the TPU kernel): its output carries no gradient.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from repro_torch.core.diffusion import DiffusionSchedule
from repro_torch.kernels import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ladn_denoise.cu"
MAX_STEPS = 16       # I
MAX_WIDTH = 128      # A, S and H each
MAX_AGENTS = 65535   # G: the grid's second dimension
# an H100 block may use at most this much shared memory
_MAX_SMEM = 232_448

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build(SOURCE)))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.repro_ladn_denoise.argtypes = [vp] * 12 + [ci] * 6 + [vp, vp]
        lib.repro_ladn_denoise.restype = ci
        lib.repro_ladn_denoise_smem_bytes.argtypes = [ci] * 5
        lib.repro_ladn_denoise_smem_bytes.restype = ctypes.c_longlong
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


def _check(t: torch.Tensor, name: str, shape: tuple) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def ladn_denoise_fused(x_I, s, noise, temb_w1, w1x, w1s, b1, w2, b2, w3, b3,
                       sched: DiffusionSchedule,
                       paper_variance: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel: x_I (G,T,A), s (G,T,S), noise (G,T,I,A),
    temb_w1 (G,I,H), w1x (G,A,H), w1s (G,S,H), b1 (G,H), w2 (G,H,H),
    b2 (G,H), w3 (G,H,A), b3 (G,A), all f32 and contiguous on one card;
    ``sched`` is the numpy schedule (``make_schedule_np``).  Returns x_0
    (G,T,A).  Launches on the current stream without synchronising."""
    G, T, A = x_I.shape
    S = s.shape[-1]
    H = w2.shape[-1]
    I = sched.num_steps  # noqa: E741
    if not (0 < I <= MAX_STEPS):
        raise ValueError(f"the kernel runs 1..{MAX_STEPS} steps, got {I}")
    if max(A, S, H) > MAX_WIDTH:
        raise ValueError(f"widths A={A} S={S} H={H} exceed {MAX_WIDTH}")
    if G > MAX_AGENTS:
        raise ValueError(f"G={G} agents exceed {MAX_AGENTS}")
    for t, name, shape in (
            (x_I, "x_I", (G, T, A)), (s, "s", (G, T, S)),
            (noise, "noise", (G, T, I, A)), (temb_w1, "temb_w1", (G, I, H)),
            (w1x, "w1x", (G, A, H)), (w1s, "w1s", (G, S, H)),
            (b1, "b1", (G, H)), (w2, "w2", (G, H, H)), (b2, "b2", (G, H)),
            (w3, "w3", (G, H, A)), (b3, "b3", (G, A))):
        _check(t, name, shape)
    devices = {t.device for t in (x_I, s, noise, temb_w1, w1x, w1s, b1, w2,
                                  b2, w3, b3)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    out = torch.empty_like(x_I)
    if G == 0 or T == 0:
        return out
    lib = _library()
    smem = lib.repro_ladn_denoise_smem_bytes(T, A, S, H, I)
    if smem > _MAX_SMEM:
        raise ValueError(f"A={A} S={S} H={H} I={I} needs {smem} bytes of "
                         f"shared memory per block")
    consts = (ctypes.c_float * (3 * I))(
        *[c for step in step_consts(sched, paper_variance) for c in step])
    with torch.cuda.device(x_I.device):
        stream = torch.cuda.current_stream(x_I.device).cuda_stream
        err = lib.repro_ladn_denoise(
            x_I.data_ptr(), s.data_ptr(), noise.data_ptr(),
            temb_w1.data_ptr(), w1x.data_ptr(), w1s.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), w3.data_ptr(),
            b3.data_ptr(), out.data_ptr(), G, T, A, S, H, I, consts, stream)
    if err != 0:
        msg = lib.repro_ladn_cuda_error_string(err).decode()
        raise RuntimeError(f"ladn_denoise launch failed: CUDA error {err} "
                           f"({msg})")
    return out
