"""Device meshes for sharded serving: named grids of ``torch.distributed``
ranks.

Port of ``repro/launch/mesh.py``.  The reference's mesh is a grid of the
devices one JAX process sees; here every rank is one process holding one
card (or one CPU process on the ``gloo`` backend), and a :class:`Mesh`
names a grid of those ranks with the reference's axis names:

    single pod : (16, 16)    -> ("data", "model")
    multi-pod  : (2, 16, 16) -> ("pod", "data", "model")

The process group is the caller's to set up (``init_process_group`` with
an explicit store, rank and world size); :func:`make_production_mesh`
checks the grid against its world size.  :func:`make_smoke_mesh` needs no
group: it starts a one-rank one on an in-process ``HashStore``.  The peak
constants are the H100's, in place of the reference's TPU v5e ones; the
roofline (``repro_torch.roofline``) divides by them.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import DeviceLike, resolve_device

# NVIDIA H100 SXM5 80GB at 700 W, from NVIDIA's H100 Tensor Core GPU
# data sheet (dense, no sparsity); per card
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, f32 on the CUDA cores
# f32-accurate products on the tensor cores: 3xTF32, three TF32 products
# (495 TFLOP/s) for each f32 one
PEAK_FLOPS_F32_TC = 495e12 / 3
HBM_BW = 3.35e12                # bytes/s, HBM3
NVLINK_BW = 450e9               # bytes/s per direction (the reference's ICI_BW)
HBM_BYTES = 80e9                # bytes of HBM3 a card

SMOKE_AXES = ("data", "model")


class Mesh:
    """A named grid of ranks over a ``DeviceMesh``.

    ``axis_names`` and ``shape`` (axis name -> size, in axis order) read
    as the reference's ``jax.sharding.Mesh``; ``get_group(axis)`` is the
    process group of this rank's line along ``axis`` and
    ``local_rank(axis)`` this rank's coordinate on it.  Two meshes are
    equal when they name the same ranks in the same grid on the same
    device type, so a mesh can key the shared step cache."""

    def __init__(self, device_mesh, axis_names: Sequence[str]):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              device_mesh.mesh.shape))
        self.device_type: str = device_mesh.device_type
        self._key = (self.axis_names, tuple(self.shape.values()),
                     self.device_type,
                     tuple(device_mesh.mesh.flatten().tolist()))

    def get_group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def local_rank(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({dims}, {self.device_type!r})"


def _backend() -> str:
    """One group for both device types where NCCL exists."""
    if torch.cuda.is_available() and dist.is_nccl_available():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(device: torch.device, shape, axes) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh
    return Mesh(init_device_mesh(device.type, tuple(shape),
                                 mesh_dim_names=tuple(axes)), axes)


def _ensure_group() -> None:
    """A one-rank default group when the process has none."""
    if not dist.is_initialized():
        dist.init_process_group(_backend(), store=dist.HashStore(), rank=0,
                                world_size=1)


_SMOKE: Dict[str, Mesh] = {}


def make_smoke_mesh(device: DeviceLike = None) -> Mesh:
    """The 1 x 1 ``("data", "model")`` mesh of a lone process on
    ``device`` (``cuda`` unless the caller asks for the CPU): NCCL
    collectives on the card, ``gloo`` on the CPU.  Starts a one-rank
    group when the process has none and reuses an existing one-rank
    group; repeated calls return the same mesh."""
    dev = resolve_device(device)
    if dev.type not in _SMOKE:
        _ensure_group()
        if _world_size() != 1:
            raise ValueError(
                f"the smoke mesh is one rank, but this process group has "
                f"world size {_world_size()}; use make_production_mesh()")
        _SMOKE[dev.type] = _mesh(dev, (1, 1), SMOKE_AXES)
    return _SMOKE[dev.type]


def make_production_mesh(*, multi_pod: bool = False, shape=None, axes=None,
                         device: DeviceLike = None) -> Mesh:
    """Production mesh, guarded against the process group's world size.

    ``shape`` / ``axes`` override the default single-pod (16, 16) or
    multi-pod (2, 16, 16) topology together.  Every rank of the group
    calls this with the same arguments; a grid whose size is not the
    world size fails here, naming both, instead of deep in the device
    mesh.  A one-rank grid needs no group (one is started, as for
    :func:`make_smoke_mesh`)."""
    if (shape is None) != (axes is None):
        raise ValueError("pass shape and axes together (or neither)")
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = _world_size()
    if have != need:
        raise ValueError(
            f"mesh shape {tuple(shape)} ({' x '.join(map(str, shape))} = "
            f"{need} ranks) does not match this job's world size {have}; "
            f"start {need} ranks or use make_smoke_mesh() for one")
    dev = resolve_device(device)
    _ensure_group()
    return _mesh(dev, shape, axes)


def mesh_chips(mesh: Mesh) -> int:
    """Ranks (one card each) in ``mesh``."""
    return mesh.size
