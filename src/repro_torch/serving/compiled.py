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
rank's placed weights, and the dense decode round on the rank's block
of a slot pool cut over "data" (``launch.sharding.pool_pspecs``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.launch import sharding
from repro_torch.models.transformer import forward
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
    """Snapshot for tests and diagnostics: entry keys and hit counts."""
    return {"size": len(_CACHE), "keys": list(_CACHE), **_STATS}


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
    def build():
        dec = make_decode_step(cfg, sample=sample, temperature=temperature)
        if mesh is None:
            def pool_step(params, toks: torch.Tensor, states: List[dict],
                          generator: Optional[torch.Generator] = None):
                _, tok, new_states = dec(params, {"tokens": toks}, states,
                                         generator)
                return tok, new_states

            return pool_step
        ctx = sharding.ShardingContext(mesh)
        axes = sharding.batch_axes_for(mesh, kv_slots)
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

    key = ("pool_decode", cfg, kv_slots, sample, temperature, mesh)
    return _get(key if mesh is None else key + (max_len,), build)


# ---------------------------------------------------------------------------
# paged page-pool steps
# ---------------------------------------------------------------------------


def paged_prefill_step(cfg, num_pages: int, page_size: int,
                       mesh=None) -> Callable:
    """One-chunk paged prefill; writes the shared page pools in place."""
    return _get(("paged_prefill", cfg, num_pages, page_size, mesh),
                lambda: _on(mesh, make_paged_prefill_step(cfg)))


def paged_decode_step(cfg, num_pages: int, page_size: int, sample: bool,
                      temperature: float, mesh=None) -> Callable:
    """Paged decode round; writes the page pools in place."""
    return _get(
        ("paged_decode", cfg, num_pages, page_size, sample, temperature,
         mesh),
        lambda: _on(mesh, make_paged_decode_step(cfg, sample=sample,
                                                 temperature=temperature)))


def page_copy_step(cfg, num_pages: int, page_size: int,
                   mesh=None) -> Callable:
    """Copy-on-write page fork: every per-layer K/V pool copies physical
    page ``src`` onto page ``dst`` in place.  Used when a lane's prompt
    diverges mid-block from a cached prefix: the matched head of the
    cached page is duplicated so the lane can overwrite its private tail
    without touching the shared original."""
    def build():
        def copy(states: List[dict], src: int, dst: int) -> List[dict]:
            for layer in states:
                for pool in layer.values():
                    pool[dst].copy_(pool[src])
            return states

        return copy

    return _get(("page_copy", cfg, num_pages, page_size, mesh), build)
