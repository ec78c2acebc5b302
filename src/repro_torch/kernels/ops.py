"""Public wrappers around the port's kernels, with launch counters.

Port of ``repro/kernels/ops.py``.  Each wrapper picks by the device of
the tensors it is given: a CPU tensor goes to the plain version in
``repro_torch.kernels.ref``; a CUDA tensor goes to the hand-written
kernel, or the call raises.  There is no fallback from a failed kernel to
the plain version.

``launches`` counts kernel launches per wrapper (plain-version calls do
not count), so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.core.diffusion import make_schedule_np
from repro_torch.core.networks import TIME_EMBED_DIM, timestep_embed
from repro_torch.core.optim import tree_leaves
from repro_torch.kernels import decode_attention, ladn_denoise as _ladn, ref

launches = {"paged_flash_decode": 0, "ladn_denoise": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """Paged flash decode (see ``kernels/decode_attention.py``).

    q (B,H,hd); k/v_pages (P,KV,ps,hd); block_tables (B,W) int32;
    lengths (B,) int32.  Returns (B,H,hd)."""
    if q.device.type == "cpu":
        return ref.paged_decode_ref(q, k_pages, v_pages, block_tables,
                                    lengths)
    out = decode_attention.paged_flash_decode(q, k_pages, v_pages,
                                              block_tables, lengths)
    launches["paged_flash_decode"] += 1
    return out


# ---------------------------------------------------------------------------
# fused LADN chain
# ---------------------------------------------------------------------------


def pack_ladn_weights(theta: list, state_dim: int, action_dim: int
                      ) -> Tuple[torch.Tensor, ...]:
    """Split the stacked (A+TE+S -> H -> H -> A) LADN into the kernel's
    layout: (w1x, w1t, w1s, b1, w2, b2, w3, b3), each with the agent axis
    in front and contiguous.  LADN input order (``networks.apply_ladn``):
    [x | time-embed | state].  No padding: the TPU's 128-lane tiles have
    no counterpart here."""
    A, TE = action_dim, TIME_EMBED_DIM
    w1 = theta[0]["w"]                           # (G, A+TE+S, H)
    if w1.shape[1] != A + TE + state_dim:
        raise ValueError(f"LADN input width {w1.shape[1]} != A {A} + "
                         f"{TE} + S {state_dim}")
    return (w1[:, :A].contiguous(), w1[:, A:A + TE].contiguous(),
            w1[:, A + TE:].contiguous(), theta[0]["b"].contiguous(),
            theta[1]["w"].contiguous(), theta[1]["b"].contiguous(),
            theta[2]["w"].contiguous(), theta[2]["b"].contiguous())


@functools.lru_cache(maxsize=None)
def _schedule(num_steps: int, beta_min: float, beta_max: float):
    return make_schedule_np(num_steps, beta_min, beta_max)


def ladn_denoise(theta: list, x_I: torch.Tensor, s: torch.Tensor,
                 noise: torch.Tensor, *, num_steps: int = 5,
                 beta_min: float = 0.1, beta_max: float = 10.0,
                 paper_variance: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused reverse chain for G stacked agents' rows.

    theta: stacked LADN params (``[{"w","b"}, ...]``, agent axis first);
    x_I (G,T,A); s (G,T,S); noise (G,T,I,A) (``noise[:, :, step]`` at
    i = I - step).  Returns (x_0, softmax(x_0)), both (G,T,A).

    The kernel has no backward, so this refuses weights or inputs that
    need a gradient while grad mode is on: a gradient through it would
    silently be zero.  Differentiate through the plain chain
    (``core.diffusion.run_reverse_chain``) instead."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [x_I, s, noise, *tree_leaves(theta)]):
        raise RuntimeError("ladn_denoise has no gradient: call it under "
                           "torch.no_grad() or with detached weights, and "
                           "differentiate through the plain chain")
    A, S = x_I.shape[-1], s.shape[-1]
    sched = _schedule(num_steps, beta_min, beta_max)
    w1x, w1t, w1s, b1, w2, b2, w3, b3 = pack_ladn_weights(theta, S, A)
    # per-step time contribution (G, I, H): computed once, tiny
    temb = timestep_embed(torch.arange(num_steps, 0, -1, device=x_I.device),
                          device=x_I.device)
    temb_w1 = torch.matmul(temb, w1t)
    if x_I.device.type == "cpu":
        x0 = ref.ladn_denoise_ref(x_I, s, noise, temb_w1, w1x, w1s, b1, w2,
                                  b2, w3, b3, sched, paper_variance)
    else:
        x0 = _ladn.ladn_denoise_fused(x_I, s, noise, temb_w1, w1x, w1s, b1,
                                      w2, b2, w3, b3, sched, paper_variance)
        launches["ladn_denoise"] += 1
    return x0, torch.softmax(x0, dim=-1)
