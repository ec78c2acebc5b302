"""Shared step cache: one step callable per (config, shape).

Port of ``repro/serving/compiled.py``: the same function names and cache
keys ``(kind, cfg, num_pages, page_size, sample, temperature, mesh)``.
PyTorch runs eagerly, so the entries are plain callables rather than
jitted executables; same-config engines in a fleet still share one.  The
reference donates the page pools to each step; here every step writes
them in place.  The dense slot-pool steps come with the dense engines
(ROADMAP.md A3) and sharded meshes with A7.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from repro_torch.train.steps import (make_paged_decode_step,
                                     make_paged_prefill_step)

_CACHE: Dict[Tuple, Callable] = {}


def _get(key: Tuple, build: Callable[[], Callable]) -> Callable:
    if key not in _CACHE:
        _CACHE[key] = build()
    return _CACHE[key]


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("sharded engines are not ported to "
                                  "repro_torch yet (ROADMAP.md A7)")


def paged_prefill_step(cfg, num_pages: int, page_size: int,
                       mesh=None) -> Callable:
    """One-chunk paged prefill; writes the shared page pools in place."""
    _no_mesh(mesh)
    return _get(("paged_prefill", cfg, num_pages, page_size, mesh),
                lambda: make_paged_prefill_step(cfg))


def paged_decode_step(cfg, num_pages: int, page_size: int, sample: bool,
                      temperature: float, mesh=None) -> Callable:
    """Paged decode round; writes the page pools in place."""
    _no_mesh(mesh)
    return _get(
        ("paged_decode", cfg, num_pages, page_size, sample, temperature,
         mesh),
        lambda: make_paged_decode_step(cfg, sample=sample,
                                       temperature=temperature))


def page_copy_step(cfg, num_pages: int, page_size: int,
                   mesh=None) -> Callable:
    """Copy-on-write page fork: every per-layer K/V pool copies physical
    page ``src`` onto page ``dst`` in place.  Used when a lane's prompt
    diverges mid-block from a cached prefix: the matched head of the
    cached page is duplicated so the lane can overwrite its private tail
    without touching the shared original."""
    _no_mesh(mesh)

    def build():
        def copy(states: List[dict], src: int, dst: int) -> List[dict]:
            for layer in states:
                for pool in layer.values():
                    pool[dst].copy_(pool[src])
            return states

        return copy

    return _get(("page_copy", cfg, num_pages, page_size, mesh), build)
