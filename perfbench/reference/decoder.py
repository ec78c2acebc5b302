"""The served decoder's forward pass in plain PyTorch, float32.

Pre-norm blocks: RMSNorm, q/k/v projections (with biases where the
configuration has them), rotary positions in the half-split layout,
causal grouped-query attention with 1/sqrt(head_dim) scaling, the output
projection and a residual; RMSNorm, an MLP (SwiGLU where gated, else
GELU with the tanh approximation) and a residual; a final RMSNorm and
the head (the embedding matrix where tied).  The weights are the
harness's stacked tensors, upcast one layer at a time; every sequence is
computed whole, with no cache and no batching across sequences inside
attention, and the TF32 paths are switched off.

``precision="fp8"`` is the check's control: every matrix product takes
its operands rounded to float8 e4m3 (weights per output channel,
activations per token, each scaled to the format's range) and
multiplies them in float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

FP8_MAX = 448.0


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the slice's largest magnitude maps to the format's)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _Matmul:
    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """(in, out) weight in the product's precision."""
        w = w.float()
        return _fp8(w, 0) if self.fp8 else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = _fp8(x, -1)
        return x @ w


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float):
    """x (S, heads, hd) at positions pos (S,): half-split rotation."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = pos.float()[:, None, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, rows: int = 1024):
    """Causal GQA over one sequence: q (S, H, hd), k/v (S, KV, hd) ->
    (S, H * hd), queries ``rows`` at a time."""
    S, H, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.reshape(S, KV, G, hd).permute(1, 2, 0, 3)      # (KV, G, S, hd)
    kt = k.permute(1, 2, 0)                               # (KV, hd, S)
    vt = v.permute(1, 0, 2)                               # (KV, S, hd)
    out = torch.empty((KV, G, S, hd), device=q.device)
    kpos = torch.arange(S, device=q.device)
    for r0 in range(0, S, rows):
        r1 = min(S, r0 + rows)
        s = torch.matmul(qg[:, :, r0:r1], kt[:, None]) / math.sqrt(hd)
        mask = kpos[None, :r1] <= torch.arange(r0, r1,
                                               device=q.device)[:, None]
        s = s[..., :r1].masked_fill(~mask, float("-inf"))
        out[:, :, r0:r1] = torch.matmul(torch.softmax(s, -1),
                                        vt[:, None, :r1])
    return out.permute(2, 0, 1, 3).reshape(S, H * hd)


@torch.no_grad()
def logits_at(weights: Dict[str, torch.Tensor], spec: Dict,
              seqs: Sequence[np.ndarray], firsts: Sequence[int],
              precision: str = "fp32") -> List[torch.Tensor]:
    """The logits (n_i, V), float32, at positions ``firsts[i] ..
    len(seqs[i]) - 1`` of each token sequence, each sequence attended
    causally on its own."""
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
    x = w["embed"][toks].float()                               # (T, d)
    for i in range(spec["layers"]):
        lw = {k: mm.weight(w[k][i]) for k in ("wq", "wk", "wv", "wo",
                                             "w_up", "w_down")}
        h = _rmsnorm(x, w["norm1"][i], eps)
        q, k, v = mm(h, lw["wq"]), mm(h, lw["wk"]), mm(h, lw["wv"])
        if spec["qkv_bias"]:
            q = q + w["bq"][i].float()
            k = k + w["bk"][i].float()
            v = v + w["bv"][i].float()
        q = _rope(q.reshape(-1, H, hd), pos, spec["rope_theta"])
        k = _rope(k.reshape(-1, KV, hd), pos, spec["rope_theta"])
        v = v.reshape(-1, KV, hd)
        o = torch.cat([_attention(q[a:b], k[a:b], v[a:b])
                       for a, b in zip(bounds[:-1], bounds[1:])])
        x = x + mm(o, lw["wo"])
        h = _rmsnorm(x, w["norm2"][i], eps)
        up = mm(h, lw["w_up"])
        if spec["gated"]:
            gate = mm(h, mm.weight(w["w_gate"][i]))
            act = torch.nn.functional.silu(gate) * up
        else:
            act = torch.nn.functional.gelu(up, approximate="tanh")
        x = x + mm(act, lw["w_down"])
    rows = torch.cat([torch.arange(a + f, b, device=dev)
                      for a, b, f in zip(bounds[:-1], bounds[1:], firsts)])
    h = _rmsnorm(x[rows], w["final_norm"], eps)
    head = mm.weight(w["embed"].T if spec["tied"] else w["head"])
    logits = mm(h, head)
    cuts = np.cumsum([b - a - f for a, b, f in
                      zip(bounds[:-1], bounds[1:], firsts)])[:-1]
    return list(torch.tensor_split(logits, list(cuts)))


def served_gaps(ref: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """How far each served token's reference logit lies below the
    reference's best at its position: ref (n, V), served (n,)."""
    best = ref.max(dim=-1).values
    return best - ref.gather(1, served.long()[:, None])[:, 0]


def split_tokens(prompt: np.ndarray, served: np.ndarray
                 ) -> Tuple[np.ndarray, int]:
    """The sequence the reference reads for a request (the prompt and
    every served token but the last) and the first position whose logits
    chose a served token (the prompt's last)."""
    seq = np.concatenate([prompt, served[:-1]]).astype(np.int64)
    return seq, len(prompt) - 1
