"""Sequence-chunked cross-entropy.

Port of ``repro/train/losses.py``.  The full logits tensor is the biggest
training activation (a 4k-token sequence times a 152k vocabulary is 2.5
GB in f32 per row), so the head matmul and the softmax CE run per
sequence chunk, each under ``torch.utils.checkpoint`` when grad is on:
a chunk's logits exist only while its forward or its backward runs.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.transformer import apply_head


def _chunk_ce(params, cfg, h, labels, mask):
    """h (B,c,d), labels (B,c) or (B,K,c), mask (B,c) -> (sum of the
    masked NLL, sum of the mask)."""
    logits = apply_head(params, cfg, h).float()
    if cfg.num_codebooks:
        labels = labels.transpose(1, 2)                    # (B,c,K)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if cfg.num_codebooks:
        nll = nll.mean(dim=-1)                             # mean codebooks
    nll = nll * mask
    return nll.sum(), mask.sum()


def chunked_ce_loss(params, cfg, hidden: torch.Tensor, labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    chunk: int = 256) -> torch.Tensor:
    """hidden (B,S,d); labels (B,S) or (B,K,S); mask (B,S) of 0/1 ->
    the mean NLL over the unmasked positions (f32 scalar).  The chunk is
    the largest power-of-two fraction of ``chunk`` that divides S, as in
    the reference."""
    B, S, _ = hidden.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    c = min(chunk, S)
    while S % c:
        c //= 2
    grad = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s in range(0, S, c):
        args = (params, cfg, hidden[:, s:s + c], labels[..., s:s + c],
                mask[:, s:s + c])
        part, n = (checkpoint(_chunk_ce, *args, use_reentrant=False)
                   if grad else _chunk_ce(*args))
        tot, cnt = tot + part, cnt + n
    return tot / torch.clamp(cnt, min=1.0)
