"""Plain PyTorch versions of the port's kernels (the allclose targets).

Port of the attention, decode and LADN-chain oracles in
``repro/kernels/ref.py``.
The tests and ``chip_smoke.py`` hold the CUDA kernels against these; on
the main path they serve only tensors that lie on the CPU
(``repro_torch.kernels.ops``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.diffusion import DiffusionSchedule, reverse_step

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Dense masked attention.  q (B,H,Sq,hd); k,v (B,KV,Skv,hd) ->
    (B,H,Sq,hd).

    Query i sits at position ``q_offset + i`` and attends key j iff
    (not causal or j <= q_offset + i) and (no window or
    j > q_offset + i - window); ``q_offset = 0`` is the reference's
    oracle.  f32 scores and softmax; a row with no valid key gets the mean
    of V (the kernel writes zeros; no caller asks for such a row)."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    qh = q.reshape(B, KV, G, Sq, hd).float()
    s = torch.einsum("bkgqd,bkcd->bkgqc", qh, k.float()) / math.sqrt(hd)
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bkcd->bkgqd", w, v.float())
    return out.reshape(B, H, Sq, hd).to(q.dtype)


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


def decode_partials_ref(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, length, *, per_split: int,
                        n_splits: int):
    """The split pass of :func:`decode_ref` over splits of ``per_split``
    positions: q (B,H,hd); caches (B,KV,S,hd) with S <= per_split *
    n_splits; length () or (B,).  Returns f32 partials acc
    (B,KV,n_splits,G,hd), m and l (B,KV,n_splits,G): per split the max
    of its valid scaled scores, the sum of their exponentials from that
    max and the V rows they weight; a split with no valid position gives
    m = -inf, l = 0, acc = 0."""
    B, H, hd = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    P = per_split * n_splits
    qh = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgd,bksd->bkgs", qh, k_cache.float()) / math.sqrt(hd)
    v = v_cache.float()
    if P > S:
        s = torch.nn.functional.pad(s, (0, P - S))
        v = torch.nn.functional.pad(v, (0, 0, 0, P - S))
    length = torch.as_tensor(length, device=q.device).reshape(-1)
    length = length.expand(B) if length.numel() == 1 else length
    valid = torch.arange(P, device=q.device)[None, :] < length[:, None]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, -math.inf))
    s = s.reshape(B, KV, G, n_splits, per_split)
    m = s.amax(dim=-1)                                   # (B,KV,G,n)
    p = torch.where(torch.isinf(m)[..., None], torch.zeros_like(s),
                    torch.exp(s - m[..., None]))
    l = p.sum(dim=-1)  # noqa: E741
    acc = torch.einsum("bkgnp,bknpd->bkngd", p,
                       v.reshape(B, KV, n_splits, per_split, hd))
    return acc, m.transpose(2, 3).contiguous(), l.transpose(2, 3).contiguous()


def decode_merge_ref(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Combine every partial of :func:`decode_partials_ref`'s layout:
    acc (B,KV,N,G,hd), m and l (B,KV,N,G) -> (B,KV*G,hd) in ``dtype``.
    An empty partial (m = -inf) weighs nothing; a row whose partials are
    all empty gives zeros."""
    B, KV, N, G, hd = acc.shape
    M = m.amax(dim=2, keepdim=True)
    w = torch.where(torch.isinf(m), torch.zeros_like(m),
                    torch.exp(m - torch.where(torch.isinf(M),
                                              torch.zeros_like(M), M)))
    denom = (w * l).sum(dim=2)                           # (B,KV,G)
    num = (w[..., None] * acc).sum(dim=2)                # (B,KV,G,hd)
    out = torch.where(denom[..., None] > 0,
                      num / torch.clamp(denom, min=1e-30)[..., None],
                      torch.zeros_like(num))
    return out.reshape(B, KV * G, hd).to(dtype)


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
