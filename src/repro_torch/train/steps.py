"""Step builders for serving: dense prefill / decode and paged.

Port of ``make_prefill_step``, ``make_decode_step``,
``make_paged_prefill_step`` and ``make_paged_decode_step`` from
``repro/train/steps.py``.  The training step comes with LM training
(ROADMAP.md A8).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.transformer import forward


def pick_tokens(logits: torch.Tensor, sample: bool, temperature: float,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy argmax, or a draw with ``torch.multinomial`` from
    ``generator`` (the engine's), over the last axis: (B, V) -> (B,) or,
    for codebooks, (B, K, V) -> (B, K), int32."""
    if sample:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        tok = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                generator=generator)
        tok = tok.reshape(logits.shape[:-1])
    else:
        tok = torch.argmax(logits, dim=-1)
    return tok.to(torch.int32)


def make_prefill_step(cfg, max_len: Optional[int] = None):
    """Prompt prefill into fresh dense states.

    batch = {tokens (B, S)[, patches (B, P, vision_dim)]}; returns
    (last_logits (B, V), states whose caches are ``max_len`` deep)."""
    def prefill_step(params, batch):
        out = forward(params, cfg, batch, mode="prefill", max_len=max_len)
        return out["last_logits"], out["states"]

    return prefill_step


def make_decode_step(cfg, sample: bool = False, temperature: float = 1.0):
    """One decode token per row of dense states, each row at its own
    position; the K/V caches are written in place.

    batch = {tokens (B, 1)}; returns (logits (B, V), tokens (B,) int32,
    new states)."""
    def decode_step(params, batch, states,
                    generator: Optional[torch.Generator] = None):
        out = forward(params, cfg, batch, mode="decode", states=states)
        logits = out["logits"]
        return (logits, pick_tokens(logits, sample, temperature, generator),
                out["states"])

    return decode_step


def make_paged_prefill_step(cfg):
    """One prompt chunk into the shared page pool (batch 1).

    batch = {tokens (1, C), start int, block_table (W,)}; returns
    (chunk_logits (1, C, V), page pools written in place)."""
    def paged_prefill_step(params, batch, states):
        out = forward(params, cfg, batch, mode="paged_prefill",
                      states=states)
        return out["chunk_logits"], out["states"]

    return paged_prefill_step


def make_paged_decode_step(cfg, sample: bool = False,
                           temperature: float = 1.0):
    """One decode token per lane over the shared page pool.

    batch = {tokens (B, 1), block_tables (B, W) int32, lengths (B,) int32};
    inactive lanes carry all-null tables and length 0.  Greedy decoding
    takes the argmax; sampled decoding draws with ``torch.multinomial``
    from ``generator`` (the engine's)."""
    def paged_decode_step(params, batch, states,
                          generator: Optional[torch.Generator] = None):
        out = forward(params, cfg, batch, mode="paged_decode", states=states)
        logits = out["logits"]
        return (logits, pick_tokens(logits, sample, temperature, generator),
                out["states"])

    return paged_decode_step
