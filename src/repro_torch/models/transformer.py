"""Unified decoder, paged serving modes.

Port of ``repro/models/transformer.py`` for stacks of attention + dense
MLP blocks served from the shared page pool.  Params keep the reference's
keys and ``(in, out)`` layout, except that layers are one flat list
(``params["layers"][i]``) where the reference may stack them for
``lax.scan``; ``repro_torch.convert.params_from_jax`` unstacks.

Forward modes here: ``paged_prefill`` and ``paged_decode``.  The dense
``train``/``prefill``/``decode`` modes, recurrent mixers, MoE and the
multimodal inputs raise ``NotImplementedError`` naming their ROADMAP.md
item.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.models import attention
from repro_torch.models.layers import (apply_mlp, dense_init, init_mlp,
                                       init_rmsnorm, rmsnorm)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md {item})")


def _check_block(blk) -> None:
    if blk.mixer != "attn":
        raise _not_ported(f"the {blk.mixer} mixer", "A3")
    if blk.ffn != "dense":
        raise _not_ported(f"the {blk.ffn} feed-forward", "A7")


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def _init_block(generator, cfg, blk, dtype, device) -> dict:
    _check_block(blk)
    return {"norm1": init_rmsnorm(cfg.d_model, dtype, device),
            "mixer": attention.init_attention(generator, cfg, dtype, device),
            "norm2": init_rmsnorm(cfg.d_model, dtype, device),
            "ffn": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.gated_ffn,
                            dtype, device)}


def init_params(cfg, generator: torch.Generator,
                device: torch.device) -> dict:
    """Random params drawn from ``generator`` (a generator on ``device``)."""
    if cfg.num_codebooks or cfg.vision_patches:
        raise _not_ported("multimodal embeddings", "A6")
    dtype = getattr(torch, cfg.dtype)
    params: Dict[str, Any] = {
        "embed": {"embed": dense_init(generator, cfg.vocab_size, cfg.d_model,
                                      dtype, device)},
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = {"head": dense_init(generator, cfg.d_model,
                                             cfg.vocab_size, dtype, device)}
    params["layers"] = [_init_block(generator, cfg, blk, dtype, device)
                        for blk in cfg.layer_pattern()]
    return params


def init_paged_states(cfg, num_pages: int, page_size: int,
                      device: torch.device) -> List[dict]:
    """One (num_pages, KV, page_size, hd) k/v pool per layer."""
    states = []
    for blk in cfg.layer_pattern():
        if blk.mixer != "attn":
            raise ValueError(
                f"paged serving requires attention mixers, got {blk.mixer}")
        states.append(attention.init_paged_kv_cache(cfg, blk, num_pages,
                                                    page_size, device))
    return states


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def _apply_block(cfg, blk, p, x, state, mode, paged):
    """Returns (x_out, new_state)."""
    _check_block(blk)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if mode == "paged_prefill":
        mix, new_state = attention.paged_prefill_chunk(
            p["mixer"], cfg, blk, h, state, paged["block_table"],
            paged["start"])
    else:
        mix, new_state = attention.paged_decode(
            p["mixer"], cfg, blk, h, state, paged["block_tables"],
            paged["lengths"])
    x = x + mix
    h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + apply_mlp(p["ffn"], h2), new_state


# ---------------------------------------------------------------------------
# embeddings & heads
# ---------------------------------------------------------------------------


def embed_inputs(params, cfg, inputs: dict) -> torch.Tensor:
    """Token embedding lookup: tokens (B, S) -> (B, S, d)."""
    if cfg.num_codebooks or "patches" in inputs:
        raise _not_ported("multimodal embeddings", "A6")
    if not cfg.use_rope:
        raise _not_ported("sinusoidal positions", "A3")
    return params["embed"]["embed"][inputs["tokens"].long()]


def apply_head(params, cfg, x) -> torch.Tensor:
    """x (B, S, d) -> logits (B, S, V)."""
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"]["embed"].T
    return x @ params["head"]["head"]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


@torch.no_grad()
def forward(params, cfg, inputs: dict, mode: str,
            states: Optional[List[dict]] = None) -> dict:
    """Run the model over the shared page pools.

    paged_prefill : inputs {tokens (1,C), start int, block_table (W,)}
                    + paged states               -> {chunk_logits, states}
    paged_decode  : inputs {tokens (B,1), block_tables (B,W) int32,
                    lengths (B,) int32} + states -> {logits, states}

    The pools in ``states`` are written in place.
    """
    if mode == "paged_prefill":
        start = inputs["start"]
        paged = {"block_table": inputs["block_table"],
                 "start": int(start)}
    elif mode == "paged_decode":
        paged = {"block_tables": inputs["block_tables"],
                 "lengths": inputs["lengths"]}
    else:
        raise _not_ported(f"forward mode {mode!r}",
                          "A3 (dense modes) / A8 (train)")
    x = embed_inputs(params, cfg, inputs)
    new_states = []
    for blk, p, st in zip(cfg.layer_pattern(), params["layers"], states):
        x, ns = _apply_block(cfg, blk, p, x, st, mode, paged)
        new_states.append(ns)
    if mode == "paged_prefill":
        return {"chunk_logits": apply_head(params, cfg, x),
                "states": new_states}
    return {"logits": apply_head(params, cfg, x)[:, 0], "states": new_states}
