"""Engine-cluster construction and warm-up for the launcher.

Port of ``repro/serving/builders.py``.  :func:`build_sharded_engine`
builds one engine of any arch (paged, dense, recurrent, multimodal or
MoE) on a mesh: each rank holds its placed block of the weights
(``launch.sharding.place_params``) and of a dense slot pool, and every
step runs inside the mesh's ShardingContext (``ServeEngine(mesh=...)``),
on the 1 x 1 smoke mesh by default.  ``build_engines`` / ``build_fleet``
take the same ``mesh=`` for every engine they build.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import ServeEngine


def default_depths(n_edge: int) -> List[int]:
    """Heterogeneous layer depths — the cluster's speed diversity."""
    return [2 + 2 * (i % 2) for i in range(n_edge)]


def _engine(arch: str, cfg, i: int, seed0: int, device: torch.device,
            max_len: int, **kw) -> ServeEngine:
    """One engine of ``cfg`` with random weights drawn on ``device`` from
    a generator seeded ``seed0 + i``."""
    gen = torch.Generator(device=device).manual_seed(seed0 + i)
    params = init_params(cfg, gen, device)
    return ServeEngine(cfg, params, max_len=max_len, arch_id=arch,
                       device=device, seed=seed0 + i, **kw)


def build_engines(arch: str, n_edge: int, max_len: int, *,
                  kv_slots: int = 4, sample: bool = False,
                  depths: Optional[Sequence[int]] = None,
                  seed0: int = 0, paged: Optional[bool] = None,
                  page_size: int = 16, max_lanes: Optional[int] = None,
                  prefill_chunk: int = 64,
                  prefix_cache: Optional[bool] = None,
                  device: DeviceLike = None,
                  full_scale: bool = False, mesh=None) -> List[ServeEngine]:
    """n_edge replicas of ``arch`` on ``device`` (``cuda`` by default).

    ``full_scale=False`` serves ``reduced()`` configs at ``depths``
    (default: the reference's alternating 2/4 layers), as the reference
    does.  ``full_scale=True`` keeps the published widths and dtype, with
    the depth from ``depths`` or, when that is not given, the config's
    own.  ``paged=None`` picks the shared page pool for all-attention
    configs and the dense slot pool otherwise; dense engines ignore the
    paged knobs.  Weights are random, drawn on the device from a
    generator seeded ``seed0 + i`` for engine i."""
    device = resolve_device(device)
    base = get_config(arch)
    if not full_scale:
        base = reduced(base)
        depths = (list(depths) if depths is not None
                  else default_depths(n_edge))
    elif depths is None:
        depths = [base.num_layers] * n_edge
    return [_engine(arch, dataclasses.replace(base, num_layers=depths[i]), i,
                    seed0, device, max_len, kv_slots=kv_slots,
                    sample=sample, paged=paged, page_size=page_size,
                    max_lanes=max_lanes, prefill_chunk=prefill_chunk,
                    prefix_cache=prefix_cache, mesh=mesh)
            for i in range(n_edge)]


def build_fleet(archs: Sequence[str], max_len: int, *,
                kv_slots: int = 4, sample: bool = False,
                depths: Optional[Sequence[int]] = None,
                seed0: int = 0, paged: Optional[bool] = None,
                page_size: int = 16, max_lanes: Optional[int] = None,
                prefill_chunk: int = 64,
                prefix_cache: Optional[bool] = None,
                device: DeviceLike = None,
                full_scale: bool = False, mesh=None) -> List[ServeEngine]:
    """Heterogeneous fleet: one engine per entry of ``archs``, tagged with
    its arch id.  Mixed families mean mixed memory models behind one
    cluster interface: paged attention pools next to dense RG-LRU or
    xLSTM slot pools.

    ``full_scale=False`` serves each arch's ``reduced()`` config at
    ``depths[i]`` (default: alternating 2/4 layers), as the reference
    does.  ``full_scale=True`` keeps the published widths and dtype, with
    the depth from ``depths`` or, when that is not given, each config's
    own."""
    device = resolve_device(device)
    archs = list(archs)
    bases = [get_config(a) for a in archs]
    if not full_scale:
        bases = [reduced(b) for b in bases]
        depths = (list(depths) if depths is not None
                  else default_depths(len(archs)))
    elif depths is None:
        depths = [b.num_layers for b in bases]
    return [_engine(arch, dataclasses.replace(base, num_layers=depths[i]),
                    i, seed0, device, max_len, kv_slots=kv_slots,
                    sample=sample, paged=paged, page_size=page_size,
                    max_lanes=max_lanes, prefill_chunk=prefill_chunk,
                    prefix_cache=prefix_cache, mesh=mesh)
            for i, (arch, base) in enumerate(zip(archs, bases))]


def build_sharded_engine(arch: str, max_len: int, *, mesh=None,
                         full_scale: bool = False, num_layers: int = 2,
                         kv_slots: int = 4, sample: bool = False,
                         paged: Optional[bool] = None, page_size: int = 16,
                         max_lanes: Optional[int] = None,
                         prefill_chunk: int = 64,
                         prefix_cache: Optional[bool] = None,
                         seed: int = 0,
                         device: DeviceLike = None) -> ServeEngine:
    """One engine of ``arch`` on ``mesh`` (the 1 x 1 smoke mesh on
    ``device`` when None; ``make_production_mesh()`` on every rank of a
    multi-card job), each rank holding its placed blocks.

    ``full_scale=False`` serves the reduced config at ``num_layers``, as
    the reference does; ``full_scale=True`` keeps the published config
    whole.  Weights are random, drawn on the device from a generator
    seeded ``seed`` (the same on every rank)."""
    device = resolve_device(device)
    if mesh is None:
        mesh = make_smoke_mesh(device)
    cfg = get_config(arch)
    if not full_scale:
        cfg = dataclasses.replace(reduced(cfg), num_layers=num_layers)
    return _engine(arch, cfg, 0, seed, device, max_len, kv_slots=kv_slots,
                   sample=sample, paged=paged, page_size=page_size,
                   max_lanes=max_lanes, prefill_chunk=prefill_chunk,
                   prefix_cache=prefix_cache, mesh=mesh)


def warmup(engines: Sequence[ServeEngine], prompt_len: int,
           gen_tokens: int = 2) -> None:
    """Run one short request through every engine before timed serving
    (builds the CUDA kernels, wakes the libraries and the allocator), then
    reset it.  Audio configs get a (1, K, S) prompt and vision configs
    (1, P, vision_dim) patches, drawn from a seeded numpy generator."""
    rng = np.random.default_rng(1)
    for e in engines:
        cfg = e.cfg
        shape = ((1, cfg.num_codebooks, prompt_len) if cfg.num_codebooks
                 else (1, prompt_len))
        warm = rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)
        patches = None
        if cfg.vision_patches:
            patches = rng.standard_normal(
                (1, cfg.vision_patches, cfg.vision_dim), dtype=np.float32)
        e.generate(warm, max(gen_tokens, 2), patches=patches)
        e.reset()
