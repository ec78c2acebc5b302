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
from typing import Optional, Tuple

import torch

from repro_torch.core.diffusion import make_schedule_np
from repro_torch.core.networks import TIME_EMBED_DIM, timestep_embed
from repro_torch.core.optim import tree_leaves
from repro_torch.kernels import decode_attention, ladn_denoise as _ladn, ref
from repro_torch.kernels import flash_attention as _flash
from repro_torch.roofline.hooks import kernel_call

launches = {"paged_flash_decode": 0, "ladn_denoise": 0,
            "flash_attention": 0, "flash_decode": 0,
            "flash_decode_partials": 0, "decode_merge": 0}


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
        return kernel_call("paged_flash_decode", ref.paged_decode_ref, q,
                           k_pages, v_pages, block_tables, lengths)
    out = decode_attention.paged_flash_decode(q, k_pages, v_pages,
                                              block_tables, lengths)
    launches["paged_flash_decode"] += 1
    return out


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Causal GQA flash attention (see ``kernels/flash_attention.py``).

    q (B,H,Sq,hd); k, v (B,KV,Skv,hd); query i at position
    ``q_offset + i``.  Returns (B,H,Sq,hd).  The reference's TPU tile
    sizes ``bq``/``bk`` are not arguments: the kernel picks its own.

    The kernel has no backward: on the card this refuses inputs that need
    a gradient while grad mode is on (its output would silently carry
    none).  :func:`flash_attention_grad` is the differentiable call."""
    if q.device.type == "cpu":
        return kernel_call("flash_attention", ref.attention_ref, q, k, v,
                           causal=causal, window=window, q_offset=q_offset)
    if _needs_grad(q, k, v):
        raise RuntimeError("flash_attention has no backward: call it under "
                           "torch.no_grad(), or call flash_attention_grad")
    out = _flash.flash_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    launches["flash_attention"] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The CUDA kernel forward; the backward recomputes the plain
    ``models.attention.chunked_causal_attention`` on the saved q, k, v
    and differentiates it (the reference's train path differentiates the
    same function under ``jax.checkpoint``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, q_offset)
        out = _flash.flash_attention(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
        launches["flash_attention"] += 1
        return out

    @staticmethod
    def backward(ctx, grad_out):
        from repro_torch.models.attention import chunked_causal_attention
        causal, window, q_offset = ctx.mask
        if not causal:
            raise NotImplementedError("flash_attention_grad is causal only")
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            q, k, v = (t.transpose(1, 2) for t in inputs)
            out = chunked_causal_attention(q, k, v, window=window,
                                           q_offset=q_offset)
        grads = torch.autograd.grad(out, inputs, grad_out.transpose(1, 2))
        return (*grads, None, None, None)


def flash_attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """:func:`flash_attention` with a gradient.  On the card a call that
    needs one goes through :class:`_FlashAttention` (kernel forward, plain
    backward); every other call is :func:`flash_attention`'s."""
    if q.device.type != "cpu" and _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, length) -> torch.Tensor:
    """One query token per lane against a dense cache (see
    ``kernels/decode_attention.py``).

    q (B,H,hd); caches (B,KV,S,hd); length () or (B,) valid positions.
    Returns (B,H,hd)."""
    if q.device.type == "cpu":
        return kernel_call("flash_decode", ref.decode_ref, q, k_cache,
                           v_cache, length)
    out = decode_attention.flash_decode(q, k_cache, v_cache, length)
    launches["flash_decode"] += 1
    return out


def flash_decode_partials(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, length):
    """The split pass of :func:`flash_decode` alone, over one rank's slice
    of a ring cut along its positions (``kernels/decode_attention.py``):
    q (B,H,hd); caches (B,KV,S,hd); length () or (B,) valid positions.
    Returns the f32 partials (acc (B,KV,n,G,hd), m, l (B,KV,n,G)) of
    ``decode_attention.split_plan``'s n splits, an empty one (m = -inf,
    l = 0, acc = 0) for each split past the length."""
    B, H, _ = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    if q.device.type == "cpu":
        per, n = decode_attention.split_plan(B, KV, S, decode_attention.TILE)
        return kernel_call("flash_decode_partials", ref.decode_partials_ref,
                           q, k_cache, v_cache, length, per_split=per,
                           n_splits=n)
    out = decode_attention.flash_decode_partials(q, k_cache, v_cache, length)
    launches["flash_decode_partials"] += 1
    return out


def decode_merge(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The merge pass of :func:`flash_decode` alone over every partial it
    is given (acc (B,KV,N,G,hd), m, l (B,KV,N,G), f32): (B,KV*G,hd) in
    ``dtype``; an empty partial weighs nothing, a row of empty ones gives
    zeros."""
    if acc.device.type == "cpu":
        return kernel_call("decode_merge", ref.decode_merge_ref, acc, m, l,
                           dtype=dtype)
    out = decode_attention.decode_merge(acc, m, l, dtype)
    launches["decode_merge"] += 1
    return out


# ---------------------------------------------------------------------------
# fused LADN chain
# ---------------------------------------------------------------------------


def _first_layer(theta: list, state_dim: int, action_dim: int
                 ) -> Tuple[torch.Tensor, ...]:
    """The stacked first layer (G, A+TE+S, H) cut into its x, time-embed
    and state rows, as views.  LADN input order (``networks.apply_ladn``):
    [x | time-embed | state]."""
    A, TE = action_dim, TIME_EMBED_DIM
    w1 = theta[0]["w"]
    if w1.shape[1] != A + TE + state_dim:
        raise ValueError(f"LADN input width {w1.shape[1]} != A {A} + "
                         f"{TE} + S {state_dim}")
    w1 = w1.contiguous()
    return w1[:, :A], w1[:, A:A + TE], w1[:, A + TE:]


def pack_ladn_weights(theta: list, state_dim: int, action_dim: int
                      ) -> Tuple[torch.Tensor, ...]:
    """Split the stacked (A+TE+S -> H -> H -> A) LADN into the plain
    version's layout: (w1x, w1t, w1s, b1, w2, b2, w3, b3), each with the
    agent axis in front and contiguous.  No padding: the TPU's 128-lane
    tiles have no counterpart here."""
    return tuple(t.contiguous() for t in (
        *_first_layer(theta, state_dim, action_dim), theta[0]["b"],
        theta[1]["w"], theta[1]["b"], theta[2]["w"], theta[2]["b"]))


@functools.lru_cache(maxsize=None)
def _schedule(num_steps: int, beta_min: float, beta_max: float):
    return make_schedule_np(num_steps, beta_min, beta_max)


@functools.lru_cache(maxsize=None)
def _time_embed(num_steps: int, device: torch.device) -> torch.Tensor:
    """The chain's time embeddings (I, TE) for i = I..1, made once per
    step count and device."""
    return timestep_embed(torch.arange(num_steps, 0, -1, device=device),
                          device=device)


def ladn_denoise(theta: list, x_I: torch.Tensor, s: torch.Tensor,
                 noise: torch.Tensor, *, num_steps: int = 5,
                 beta_min: float = 0.1, beta_max: float = 10.0,
                 paper_variance: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused reverse chain for G stacked agents' rows.

    theta: stacked LADN params (``[{"w","b"}, ...]``, agent axis first);
    x_I (G,T,A); s (G,T,S); noise (G,T,I,A) (``noise[:, :, step]`` at
    i = I - step).  Returns (x_0, softmax(x_0)), both (G,T,A).

    The kernel takes the first layer's x and state rows as views of the
    stacked weight (no copies); the plain version, on the CPU, takes
    :func:`pack_ladn_weights`.

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
    temb = _time_embed(num_steps, x_I.device)
    if x_I.device.type == "cpu":
        w1x, w1t, w1s, b1, w2, b2, w3, b3 = pack_ladn_weights(theta, S, A)
        # per-step time contribution (G, I, H): computed once, tiny
        x0 = ref.ladn_denoise_ref(x_I, s, noise, torch.matmul(temb, w1t),
                                  w1x, w1s, b1, w2, b2, w3, b3, sched,
                                  paper_variance)
    else:
        w1x, w1t, w1s = _first_layer(theta, S, A)
        b1, w2, b2, w3, b3 = (t.contiguous() for t in (
            theta[0]["b"], theta[1]["w"], theta[1]["b"], theta[2]["w"],
            theta[2]["b"]))
        x0 = _ladn.ladn_denoise_fused(x_I, s, noise, torch.matmul(temb, w1t),
                                      w1x, w1s, b1, w2, b2, w3, b3, sched,
                                      paper_variance)
        launches["ladn_denoise"] += 1
    return x0, torch.softmax(x0, dim=-1)
