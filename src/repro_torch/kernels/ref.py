"""Plain PyTorch versions of the port's kernels (the allclose targets).

Port of the decode and LADN-chain oracles in ``repro/kernels/ref.py``.
The tests and ``chip_smoke.py`` hold the CUDA kernels against these; on
the main path they serve only tensors that lie on the CPU
(``repro_torch.kernels.ops``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.diffusion import DiffusionSchedule, reverse_step

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


def ladn_denoise_ref(x_I, s, noise, temb_w1, w1x, w1s, b1, w2, b2, w3, b3,
                     sched, paper_variance: bool = True) -> torch.Tensor:
    """Unfused reverse chain on the kernel's stacked layout.

    Port of ``repro/kernels/ref.py::ladn_denoise_ref`` with the agent axis
    G in front: x_I (G,T,A), s (G,T,S), noise (G,T,I,A) (``noise[:, :,
    step]`` is used at step = I - i), temb_w1 (G,I,H), w1x (G,A,H),
    w1s (G,S,H), b1 (G,H), w2 (G,H,H), b2 (G,H), w3 (G,H,A), b3 (G,A);
    ``sched`` as numpy arrays or tensors.  f32 throughout."""
    sched = DiffusionSchedule(*(torch.as_tensor(a, device=x_I.device)
                                for a in sched))
    I = sched.num_steps  # noqa: E741
    x = x_I.float()
    s_contrib = torch.bmm(s.float(), w1s) + b1[:, None, :]
    for step in range(I):
        i = I - step
        h = torch.relu(torch.bmm(x, w1x) + s_contrib
                       + temb_w1[:, step][:, None, :])
        h = torch.relu(torch.bmm(h, w2) + b2[:, None, :])
        eps = torch.bmm(h, w3) + b3[:, None, :]
        x = reverse_step(sched, eps, x, i, noise[:, :, step].float(),
                         paper_variance=paper_variance)
    return x
