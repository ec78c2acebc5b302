"""Unified decoder: attention and RG-LRU blocks, dense and paged modes.

Port of ``repro/models/transformer.py`` for stacks of attention or RG-LRU
mixers with dense MLPs.  Params keep the reference's keys and ``(in,
out)`` layout, except that layers are one flat list
(``params["layers"][i]``) where the reference may stack them for
``lax.scan``; ``repro_torch.convert.params_from_jax`` unstacks.  Layer
states are a flat list too, one dict per layer, each with a leading
batch (slot) axis and a per-row ``pos`` (B,) int32.

Forward modes: ``train`` (forward only: hidden states, no loss and no
backward), ``prefill``, ``decode``, ``paged_prefill`` and
``paged_decode``.  xLSTM mixers, MoE and the multimodal inputs raise
``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.models import attention, rglru
from repro_torch.models.layers import (apply_mlp, dense_init, init_mlp,
                                       init_rmsnorm, rmsnorm)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md {item})")


def _check_block(blk) -> None:
    if blk.mixer not in ("attn", "rglru"):
        raise _not_ported(f"the {blk.mixer} mixer", "A3")
    if blk.ffn != "dense":
        raise _not_ported(f"the {blk.ffn} feed-forward", "A7")


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def _init_block(generator, cfg, blk, dtype, device) -> dict:
    _check_block(blk)
    init_mixer = (attention.init_attention if blk.mixer == "attn"
                  else rglru.init_rglru)
    return {"norm1": init_rmsnorm(cfg.d_model, dtype, device),
            "mixer": init_mixer(generator, cfg, dtype, device),
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


def init_layer_states(cfg, batch: int, max_len: int,
                      device: torch.device) -> List[dict]:
    """Empty per-layer states with a leading batch (slot) axis: dense
    K/V rings (``attention.init_kv_cache``) or RG-LRU states, each with a
    ``pos`` (batch,) int32."""
    states = []
    for blk in cfg.layer_pattern():
        _check_block(blk)
        if blk.mixer == "attn":
            states.append(attention.init_kv_cache(cfg, blk, batch, max_len,
                                                  device))
        else:
            states.append(rglru.init_rglru_state(cfg, batch, device))
    return states


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


def _apply_block(cfg, blk, p, x, positions, state, mode, max_len=None,
                 paged=None):
    """Returns (x_out, new_state); ``new_state`` is None in train mode."""
    _check_block(blk)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    new_state = None
    if mode in ("paged_prefill", "paged_decode") and blk.mixer != "attn":
        raise ValueError(
            f"paged serving requires attention mixers, got {blk.mixer}")
    if blk.mixer == "rglru":
        if mode == "decode":
            mix, new_state = rglru.rglru_step(p["mixer"], cfg, h, state)
        else:
            mix, new_state = rglru.rglru_scan(p["mixer"], cfg, h)
    elif mode == "train":
        mix = attention.attend_train(p["mixer"], cfg, blk, h, positions)
    elif mode == "prefill":
        mix, new_state = attention.prefill(p["mixer"], cfg, blk, h,
                                           positions, max_len=max_len)
    elif mode == "decode":
        mix, new_state = attention.decode(p["mixer"], cfg, blk, h, state)
    elif mode == "paged_prefill":
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


MODES = ("train", "prefill", "decode", "paged_prefill", "paged_decode")


@torch.no_grad()
def forward(params, cfg, inputs: dict, mode: str,
            states: Optional[List[dict]] = None,
            max_len: Optional[int] = None) -> dict:
    """Run the model.

    train         : inputs {tokens (B,S)}        -> {hidden}
    prefill       : inputs {tokens (B,S)}        -> {last_logits, states}
    decode        : inputs {tokens (B,1)} + states (each row at its own
                    ``pos``)                     -> {logits, states}
    paged_prefill : inputs {tokens (1,C), start int, block_table (W,)}
                    + paged states               -> {chunk_logits, states}
    paged_decode  : inputs {tokens (B,1), block_tables (B,W) int32,
                    lengths (B,) int32} + states -> {logits, states}

    ``max_len`` sizes prefill's caches.  Decode writes the dense K/V
    caches in place, and the paged modes the pools.
    """
    if mode not in MODES:
        raise ValueError(f"unknown forward mode {mode!r}; options {MODES}")
    paged = None
    if mode == "paged_prefill":
        paged = {"block_table": inputs["block_table"],
                 "start": int(inputs["start"])}
    elif mode == "paged_decode":
        paged = {"block_tables": inputs["block_tables"],
                 "lengths": inputs["lengths"]}
    x = embed_inputs(params, cfg, inputs)
    positions = None
    if mode in ("train", "prefill"):
        positions = torch.arange(x.shape[1], device=x.device)
    new_states = []
    for i, (blk, p) in enumerate(zip(cfg.layer_pattern(), params["layers"])):
        st = states[i] if states is not None else None
        x, ns = _apply_block(cfg, blk, p, x, positions, st, mode,
                             max_len=max_len, paged=paged)
        new_states.append(ns)
    if mode == "train":
        return {"hidden": x}
    if mode == "prefill":
        return {"last_logits": apply_head(params, cfg, x[:, -1:])[:, 0],
                "states": new_states}
    if mode == "paged_prefill":
        return {"chunk_logits": apply_head(params, cfg, x),
                "states": new_states}
    return {"logits": apply_head(params, cfg, x)[:, 0], "states": new_states}
