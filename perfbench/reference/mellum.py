"""Mellum2-12B-A2.5B's forward pass in plain PyTorch, float32.

As published (https://huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct,
config.json), per layer:

    h  = RMSNorm(x)                                     (eps 1e-6)
    q, k, v = h Wq, h Wk, h Wv                          (no bias; 32 query
                                                         heads over 4 K/V
                                                         heads of 128)
    q, k = RoPE(q), RoPE(k)                             (the layer kind's)
    x  = x + Attn(q, k, v) Wo                           (causal GQA, scores
                                                         q.k / sqrt(128);
                                                         a sliding layer's
                                                         query at p reads
                                                         keys in
                                                         (p - 1024, p])
    h  = RMSNorm(x)
    p  = softmax(h Wr)                                  (64 experts, f32)
    g, e = top8(p);  g = g / sum(g)                     (norm_topk_prob)
    x  = x + sum_j g_j (SiLU(h Wg[e_j]) * (h Wu[e_j])) Wd[e_j]

then a final RMSNorm and the untied head.  ``layer_types`` gives each
layer's kind: three ``sliding_attention`` layers (window 1024, default
RoPE, theta 500000) to each ``full_attention`` layer (no window, yarn).

RoPE, half-split: x = [x1 | x2] -> [x1 cos - x2 sin | x2 cos + x1 sin] at
angles p * inv_i.  Default: inv_i = theta^(-2i / hd).  Yarn (Hugging
Face's ``_compute_yarn_parameters``, factor s, original positions L,
beta_fast, beta_slow, attention_factor a):

    dim(r)  = hd ln(L / (2 pi r)) / (2 ln theta)
    lo, hi  = max(floor(dim(beta_fast)), 0), min(ceil(dim(beta_slow)), hd - 1)
    ramp_i  = clamp((i - lo) / (hi - lo), 0, 1)
    inv_i   = theta^(-2i/hd) (ramp_i / s + 1 - ramp_i)

and cos, sin both times a, so every score of a full layer is scaled by a^2.

The weights are the harness's stacked tensors (``models/moe_window.py``),
upcast one layer (and one expert) at a time.  Each sequence is computed
whole, its attention in row blocks over the keys its rows can read, with
no cache and no batching across sequences inside attention; the experts
are computed for the tokens routed to them, every one (no capacity).
TF32 is off.  Departures from the published model: none in the forward;
the multi-token-prediction head the family is described with is not in
the config and is not computed; the router's weight is the harness's
float32 copy.

``precision="fp8"`` is the check's control: every matrix product of the
projections, the router, the experts and the head takes its operands
rounded to float8 e4m3 (weights per output channel, activations per
token), as ``decoder.py``'s control does.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench.reference.decoder import _Matmul, _rmsnorm


def rope_inv_freq(hd: int, rope: Dict, device) -> torch.Tensor:
    """The inverse frequencies (hd / 2,) of one layer kind's RoPE."""
    theta = float(rope["rope_theta"])
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=device) / hd)
    if rope["rope_type"] == "default":
        return inv
    if rope["rope_type"] != "yarn":
        raise ValueError(f"unknown rope_type {rope['rope_type']!r}")
    L = float(rope["original_max_position_embeddings"])

    def dim(r):
        return hd * math.log(L / (2 * math.pi * r)) / (2 * math.log(theta))

    lo = max(math.floor(dim(float(rope["beta_fast"]))), 0)
    hi = min(math.ceil(dim(float(rope["beta_slow"]))), hd - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(hd // 2, dtype=torch.float32, device=device) - lo)
            / (hi - lo)).clamp(0, 1)
    return inv * (ramp / float(rope["factor"]) + 1 - ramp)


def rope_scale(rope: Dict) -> float:
    return float(rope.get("attention_factor", 1.0)) \
        if rope["rope_type"] == "yarn" else 1.0


def _rope(x: torch.Tensor, pos: torch.Tensor, inv: torch.Tensor,
          scale: float) -> torch.Tensor:
    """x (S, heads, hd) at positions pos (S,)."""
    hd = x.shape[-1]
    ang = pos.float()[:, None, None] * inv
    cos, sin = torch.cos(ang) * scale, torch.sin(ang) * scale
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, window, rows: int = 512):
    """Causal GQA over one sequence, queries ``rows`` at a time, each
    block against the keys its rows can read: q (S, H, hd), k/v (S, KV,
    hd) -> (S, H * hd)."""
    S, H, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.reshape(S, KV, G, hd).permute(1, 2, 0, 3)      # (KV, G, S, hd)
    kt = k.permute(1, 2, 0)                               # (KV, hd, S)
    vt = v.permute(1, 0, 2)                               # (KV, S, hd)
    out = torch.empty((KV, G, S, hd), device=q.device)
    for r0 in range(0, S, rows):
        r1 = min(S, r0 + rows)
        k0 = 0 if window is None else max(0, r0 - window + 1)
        qpos = torch.arange(r0, r1, device=q.device)[:, None]
        kpos = torch.arange(k0, r1, device=q.device)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.matmul(qg[:, :, r0:r1], kt[:, None, :, k0:r1]) \
            / math.sqrt(hd)
        s = s.masked_fill(~mask, float("-inf"))
        out[:, :, r0:r1] = torch.matmul(torch.softmax(s, -1),
                                        vt[:, None, k0:r1])
    return out.permute(2, 0, 1, 3).reshape(S, H * hd)


def _experts(h: torch.Tensor, w: Dict[str, torch.Tensor], i: int,
             spec: Dict, mm: _Matmul) -> torch.Tensor:
    """The layer's MoE output for h (T, d): every token's top-k experts,
    gates renormalised, each expert run on the tokens routed to it."""
    f, K = spec["d_expert"], spec["top_k"]
    probs = torch.softmax(mm(h, mm.weight(w["router"][i])), dim=-1)
    gate, idx = torch.topk(probs, K, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(spec["experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        wgu = mm.weight(w["we_gate_up"][i, e])             # (d, 2f)
        hu = mm(h[tok], wgu)
        a = torch.nn.functional.silu(hu[:, :f]) * hu[:, f:]
        y = mm(a, mm.weight(w["we_down"][i, e]))
        out.index_add_(0, tok, y * gate[tok, slot][:, None])
    return out


@torch.no_grad()
def logits_at(weights: Dict[str, torch.Tensor], spec: Dict,
              seqs: Sequence[np.ndarray], firsts: Sequence[int],
              precision: str = "fp32") -> List[torch.Tensor]:
    """The logits (n_i, V), float32, at positions ``firsts[i] ..
    len(seqs[i]) - 1`` of each token sequence, each attended on its
    own."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits_at(weights, spec, seqs, firsts, _Matmul(precision))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _logits_at(w, spec, seqs, firsts, mm: _Matmul) -> List[torch.Tensor]:
    dev = w["embed"].device
    H, KV, hd = spec["heads"], spec["kv_heads"], spec["head_dim"]
    eps = spec["norm_eps"]
    lens = [len(s) for s in seqs]
    bounds = np.concatenate([[0], np.cumsum(lens)])
    toks = torch.from_numpy(np.concatenate(seqs).astype(np.int64)).to(dev)
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    ropes = {kind: (rope_inv_freq(hd, r, dev), rope_scale(r))
             for kind, r in spec["rope"].items()}
    x = w["embed"][toks].float()                               # (T, d)
    for i, kind in enumerate(spec["layer_types"][:spec["layers"]]):
        window = spec["window"] if kind == "sliding_attention" else None
        inv, scale = ropes[kind]
        h = _rmsnorm(x, w["norm1"][i], eps)
        q = mm(h, mm.weight(w["wq"][i])).reshape(-1, H, hd)
        k = mm(h, mm.weight(w["wk"][i])).reshape(-1, KV, hd)
        v = mm(h, mm.weight(w["wv"][i])).reshape(-1, KV, hd)
        q, k = _rope(q, pos, inv, scale), _rope(k, pos, inv, scale)
        o = torch.cat([_attention(q[a:b], k[a:b], v[a:b], window)
                       for a, b in zip(bounds[:-1], bounds[1:])])
        x = x + mm(o, mm.weight(w["wo"][i]))
        x = x + _experts(_rmsnorm(x, w["norm2"][i], eps), w, i, spec, mm)
    rows = torch.cat([torch.arange(a + f, b, device=dev)
                      for a, b, f in zip(bounds[:-1], bounds[1:], firsts)])
    h = _rmsnorm(x[rows], w["final_norm"], eps)
    logits = mm(h, mm.weight(w["head"]))
    cuts = np.cumsum([b - a - f for a, b, f in
                      zip(bounds[:-1], bounds[1:], firsts)])[:-1]
    return list(torch.tensor_split(logits, list(cuts)))
