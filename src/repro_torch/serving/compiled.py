"""Shared step cache: one step callable per (config, shape).

Port of ``repro/serving/compiled.py``: the same function names and cache
keys ``(kind, cfg, max_len / kv_slots / num_pages + page_size, sample,
temperature, mesh)``.  PyTorch runs eagerly, so the entries are plain
callables rather than jitted executables; same-config engines in a fleet
still share one.  The reference donates the slot pool and the page pools
to each step; here every step writes them in place.  ``mesh`` joins every
key, and a step built for a mesh runs inside that mesh's
``ShardingContext`` (kept as the step's ``sharding`` attribute, whose
report names the layout each layer used): the layers compute on the
rank's placed weights, the dense decode round on the rank's block
of a slot pool cut over "data" (``launch.sharding.pool_pspecs``), and
the paged steps on the rank's block of pages
(``launch.sharding.page_block``).  Without a mesh the paged steps are
:class:`~repro_torch.serving.graphs.PiecewiseStep`: replayed from CUDA
graphs cut at the attention kernels on the card, eager elsewhere; their
calls by kind are ``cache_info()["graphs"]``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.launch import sharding
from repro_torch.models.transformer import forward
from repro_torch.serving.graphs import PiecewiseStep
from repro_torch.train.steps import (make_decode_step,
                                     make_paged_decode_step,
                                     make_paged_prefill_step,
                                     make_prefill_step, pick_tokens)

_CACHE: Dict[Tuple, Callable] = {}
_STATS = {"hits": 0, "misses": 0}


def _get(key: Tuple, build: Callable[[], Callable]) -> Callable:
    fn = _CACHE.get(key)
    if fn is None:
        _STATS["misses"] += 1
        fn = _CACHE[key] = build()
    else:
        _STATS["hits"] += 1
    return fn


def cache_info() -> Dict[str, Any]:
    """Snapshot for tests and diagnostics: entry keys and hit counts, and
    each paged step's graph captures, replays and eager calls by key."""
    return {"size": len(_CACHE), "keys": list(_CACHE), **_STATS,
            "graphs": {key: dict(fn.counts) for key, fn in _CACHE.items()
                       if isinstance(fn, PiecewiseStep)}}


def clear_cache() -> None:
    _CACHE.clear()
    _STATS["hits"] = _STATS["misses"] = 0


def _on(mesh, fn: Callable) -> Callable:
    """``fn`` run inside ``mesh``'s ShardingContext (``fn`` itself
    without a mesh)."""
    if mesh is None:
        return fn
    ctx = sharding.ShardingContext(mesh)

    def step(*args, **kw):
        with sharding.use(ctx):
            return fn(*args, **kw)

    step.sharding = ctx
    return step


# ---------------------------------------------------------------------------
# dense slot-pool steps
# ---------------------------------------------------------------------------


def prefill_step(cfg, max_len: int, mesh=None) -> Callable:
    """Batch-1 prefill: (params, {tokens (1, S)}) -> (last_logits (1, V),
    fresh per-request states whose caches are ``max_len`` deep)."""
    return _get(("prefill", cfg, max_len, mesh),
                lambda: _on(mesh, make_prefill_step(cfg, max_len=max_len)))


def pool_insert() -> Callable:
    """Slot insert ``pool[i] = state`` for every leaf of every layer, in
    place; a request's batch-1 state must fit its slot."""
    def build():
        def insert(pool: List[dict], states: List[dict], i: int
                   ) -> List[dict]:
            for layer, st in zip(pool, states):
                for name, leaf in layer.items():
                    if st[name].shape[1:] != leaf.shape[1:]:
                        raise ValueError(
                            f"a state {name} of shape "
                            f"{tuple(st[name].shape)} does not fit the "
                            f"slot pool's {tuple(leaf.shape)} (prompt "
                            f"longer than max_len?)")
                    leaf[i].copy_(st[name][0])
            return pool

        return insert

    return _get(("insert",), build)


def pool_decode_step(cfg, kv_slots: int, sample: bool, temperature: float,
                     mesh=None, max_len: Optional[int] = None) -> Callable:
    """:func:`make_pool_decode`'s step, cached per key."""
    key = ("pool_decode", cfg, kv_slots, sample, temperature, mesh)
    return _get(key if mesh is None else key + (max_len,),
                lambda: make_pool_decode(cfg, kv_slots, sample, temperature,
                                         mesh, max_len))


def make_pool_decode(cfg, kv_slots: int, sample: bool, temperature: float,
                     mesh=None, max_len: Optional[int] = None) -> Callable:
    """One-token decode round over the dense slot pool, written out as
    one batched decode: (params, toks (slots, 1), pool_states,
    generator) -> (tokens (slots,) int32, new pool_states).

    The reference vmaps a batch-1 decode over the slots, each slot with
    its own scalar position; here the slot axis is the batch axis and the
    states' ``pos`` is (slots,), which computes the same round (a
    ``ctypes`` kernel cannot sit under ``torch.func.vmap``); the MoE
    layers keep the vmap's semantics by routing each slot as its own
    group.  K/V caches are written in place.

    On a mesh (``max_len`` then sizes the rings) ``states`` is the rank's
    block of the pool: where the data axes divide ``kv_slots`` each rank
    decodes its own slots' rows and the greedy tokens are all-gathered
    over them, so every rank returns every slot's token; a sampled round
    gathers the logits instead and draws for every slot from
    ``generator``, the meshless engine's stream."""
    dec = make_decode_step(cfg, sample=sample, temperature=temperature)
    if mesh is None:
        def pool_step(params, toks: torch.Tensor, states: List[dict],
                      generator: Optional[torch.Generator] = None):
            _, tok, new_states = dec(params, {"tokens": toks}, states,
                                     generator)
            return tok, new_states

        return pool_step
    axes = sharding.batch_axes_for(mesh, kv_slots)
    # slots the data axes do not divide stay whole on every rank: the MoE
    # layers then route every row on every rank too
    ctx = sharding.ShardingContext(mesh, rules=None if axes
                                   else {"batch": None})
    rows = ctx.split_rows(axes)

    def pool_step(params, toks: torch.Tensor, states: List[dict],
                  generator: Optional[torch.Generator] = None):
        with sharding.use(rows):
            mine = sharding.my_rows(toks, mesh, axes)
            out = forward(params, cfg, {"tokens": mine}, mode="decode",
                          states=states, max_len=max_len)
            logits = out["logits"]
            if axes and sample:
                logits = sharding.gather_rows(logits, mesh, axes)
            tok = pick_tokens(logits, sample, temperature, generator)
            if axes and not sample:
                tok = sharding.gather_rows(tok, mesh, axes)
        return tok, out["states"]

    pool_step.sharding = ctx
    return pool_step


# ---------------------------------------------------------------------------
# paged page-pool steps
# ---------------------------------------------------------------------------


def paged_prefill_step(cfg, num_pages: int, page_size: int,
                       mesh=None) -> Callable:
    """One-chunk paged prefill; writes the shared page pools in place."""
    def build():
        step = make_paged_prefill_step(cfg, num_pages=num_pages)
        return (PiecewiseStep(cfg, "paged_prefill", step) if mesh is None
                else _on(mesh, step))

    return _get(("paged_prefill", cfg, num_pages, page_size, mesh), build)


def paged_decode_step(cfg, num_pages: int, page_size: int, sample: bool,
                      temperature: float, mesh=None) -> Callable:
    """Paged decode round; writes the page pools in place."""
    def build():
        step = make_paged_decode_step(cfg, sample=sample,
                                      temperature=temperature,
                                      num_pages=num_pages)
        return (PiecewiseStep(cfg, "paged_decode", step, sample, temperature)
                if mesh is None else _on(mesh, step))

    return _get(("paged_decode", cfg, num_pages, page_size, sample,
                 temperature, mesh), build)


def page_copy_step(cfg, num_pages: int, page_size: int,
                   mesh=None) -> Callable:
    """Copy-on-write page fork: every per-layer K/V pool copies physical
    page ``src`` onto page ``dst`` in place.  Used when a lane's prompt
    diverges mid-block from a cached prefix: the matched head of the
    cached page is duplicated so the lane can overwrite its private tail
    without touching the shared original.

    On a mesh whose data ranks cut the pool into page blocks
    (``launch.sharding.page_block``) the host knows each page's owner
    (``src`` and ``dst`` are host ints): a rank holding both copies in
    its block; otherwise ``src`` of every layer goes to ``dst``'s owner in
    one sum over the data axes, to which the other ranks add zeros.  Every
    rank keeps the same books, so every rank issues the same
    collectives."""
    def build():
        block = None if mesh is None else sharding.page_block(mesh,
                                                              num_pages)

        def copy(states: List[dict], src: int, dst: int) -> List[dict]:
            pools = [pool for layer in states for pool in layer.values()]
            if block is None:
                for pool in pools:
                    pool[dst].copy_(pool[src])
                return states
            lo, Pl = block
            mine = range(lo, lo + Pl)
            if src // Pl == dst // Pl:
                if src in mine:
                    for pool in pools:
                        pool[dst - lo].copy_(pool[src - lo])
                return states
            page = torch.stack([pool[src - lo] if src in mine
                                else torch.zeros_like(pool[0])
                                for pool in pools])
            sharding.all_reduce(page, mesh, sharding.data_axes(mesh))
            if dst in mine:
                for pool, sent in zip(pools, page):
                    pool[dst - lo].copy_(sent)
            return states

        return copy

    return _get(("page_copy", cfg, num_pages, page_size, mesh), build)
