"""A plain mirror of ``csrc/ladn_denoise.cu``'s arithmetic order.

Both kernels (the register kernel at widths <= 32 and the shared-memory
kernel above) sum each matrix-vector product in four partial sums: the
terms with k % 4 == r, in k order, then ``(p0 + p1) + (p2 + p3)``.  The
bias and time terms follow as ``(product + s_contrib) + temb_w1[step]``,
and each step is ``c0 * (x - c1 * eps) + c2 * noise[step]`` with the
constants folded on the host (``ladn_denoise.step_consts``).  The plain
version (``kernels.ref.ladn_denoise_ref``) sums in k order through
``bmm``; the tests hold this mirror to it.  f32 throughout, on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ladn_denoise import step_consts


def split_matvec(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """v (G, T, K) @ w (G, K, N) summed as the kernel sums: four partial
    sums over k % 4, each in k order, added as (p0 + p1) + (p2 + p3)."""
    G, T, K = v.shape
    parts = [torch.zeros((G, T, w.shape[-1]), dtype=torch.float32)
             for _ in range(4)]
    for k in range(K):
        parts[k % 4] = parts[k % 4] + v[:, :, k:k + 1] * w[:, k][:, None, :]
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def ladn_chain_split(x_I, s, noise, temb_w1, w1x, w1s, b1, w2, b2, w3, b3,
                     sched, paper_variance: bool = True) -> torch.Tensor:
    """The chain of ``ladn_denoise_ref``'s arguments in the kernel's
    order of arithmetic."""
    sc = split_matvec(s, w1s) + b1[:, None, :]
    x = x_I.clone()
    for step, (c0, c1, c2) in enumerate(step_consts(sched, paper_variance)):
        h = torch.relu(split_matvec(x, w1x) + sc
                       + temb_w1[:, step][:, None, :])
        h = torch.relu(split_matvec(h, w2) + b2[:, None, :])
        eps = split_matvec(h, w3) + b3[:, None, :]
        x = c0 * (x - c1 * eps) + c2 * noise[:, :, step]
    return x
