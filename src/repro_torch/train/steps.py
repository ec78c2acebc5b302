"""Step builders for paged serving.

Port of ``make_paged_prefill_step`` / ``make_paged_decode_step`` from
``repro/train/steps.py``.  The training step and the dense serving steps
come with their slices (ROADMAP.md A8, A3).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.transformer import forward


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
        if sample:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            tok = torch.argmax(logits, dim=-1)
        return logits, tok.to(torch.int32), out["states"]

    return paged_decode_step
