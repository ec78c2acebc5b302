"""Plain PyTorch versions of the port's kernels (the allclose targets).

Port of the decode oracles in ``repro/kernels/ref.py``.  The tests and
``chip_smoke.py`` hold the CUDA kernels against these; on the main path
they serve only tensors that lie on the CPU (``repro_torch.kernels.ops``).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               length) -> torch.Tensor:
    """q (B,H,hd); caches (B,KV,S,hd); length () or (B,) -> (B,H,hd).

    f32 softmax masked to ``length``.  A lane of length 0 has every score
    at NEG_INF and so returns the mean of V (the kernel returns zeros;
    the model never asks for length 0)."""
    B, H, hd = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qh = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgd,bksd->bkgs", qh, k_cache.float())
    s = s / math.sqrt(hd)
    length = torch.as_tensor(length, device=q.device).reshape(-1)
    length = length.expand(B) if length.numel() == 1 else length
    valid = (torch.arange(S, device=q.device)[None, :] < length[:, None])
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", w, v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)


def paged_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, block_tables: torch.Tensor,
                     lengths) -> torch.Tensor:
    """Gather the pages dense, then :func:`decode_ref`.

    q (B,H,hd); k/v_pages (P,KV,ps,hd); block_tables (B,npages), entries
    clamped to [0, P-1]; lengths () or (B,)."""
    B = q.shape[0]
    P, KV, ps, hd = k_pages.shape
    npages = block_tables.shape[1]
    tbl = block_tables.long().clamp(0, P - 1)
    k = k_pages[tbl]                              # (B, npages, KV, ps, hd)
    v = v_pages[tbl]
    k = k.permute(0, 2, 1, 3, 4).reshape(B, KV, npages * ps, hd)
    v = v.permute(0, 2, 1, 3, 4).reshape(B, KV, npages * ps, hd)
    return decode_ref(q, k, v, lengths)
