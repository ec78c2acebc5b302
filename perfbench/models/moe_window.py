"""A decoder of sliding-window and full attention layers with dropless
sparse experts in every layer (Mellum2-12B-A2.5B's block; the port's
``LayerTypesConfig`` with a dropless ``MoEConfig``).

Its weights are the harness's own: one tensor per kind of leaf, stacked
over the layers (the experts over layers and experts), drawn in a few
large calls in the type they are served in; the router in float32, as
the port routes.  ``engine_params`` hands the port per-layer views of
them; the reference (``reference/mellum.py``) reads the stacks.  Its
FLOPs count the parameters a token multiplies (its top-k experts, not
all of them) and the keys each layer's window lets a token read.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench.reference import mellum


def spec(conf: Dict, shrink: Optional[Dict] = None) -> Dict:
    """The model's shape from a configuration file, which holds the
    published config.json's keys at its top level, with ``shrink``'s keys
    replaced (the CPU rehearsal's sizes)."""
    c, serve = conf, conf["serve"]
    if not all(t == "sparse" for t in c["mlp_layer_types"]):
        raise ValueError("every layer's MLP has to be sparse")
    if c["hidden_act"] != "silu":
        raise ValueError(f"the kind's experts are SiLU-gated, not "
                         f"{c['hidden_act']!r}")
    d, H = c["hidden_size"], c["num_attention_heads"]
    s = {
        "layers": c["num_hidden_layers"], "d_model": d, "heads": H,
        "kv_heads": c["num_key_value_heads"],
        "head_dim": c.get("head_dim", d // H),
        "vocab": c["vocab_size"], "experts": c["num_experts"],
        "top_k": c["num_experts_per_tok"],
        "d_expert": c["moe_intermediate_size"],
        "norm_topk": bool(c["norm_topk_prob"]),
        "layer_types": list(c["layer_types"]),
        "window": int(c["sliding_window"]),
        "rope": {k: dict(v) for k, v in c["rope_parameters"].items()},
        "tied": bool(c.get("tie_word_embeddings", False)),
        "norm_eps": float(c["rms_norm_eps"]),
        "init_std": float(serve["init_std"]),
        "dtype": serve["dtype"],
    }
    if not s["norm_topk"] or s["tied"] or c.get("attention_bias"):
        raise ValueError("the kind renormalises the top-k gates and has an "
                         "untied head and no attention bias")
    if shrink:
        s.update(shrink)
        if "head_dim" not in shrink:
            s["head_dim"] = s["d_model"] // s["heads"]
    return s


def _types(s: Dict):
    return s["layer_types"][:s["layers"]]


def model_config(conf: Dict, s: Dict):
    """The port's ``LayerTypesConfig`` of shape ``s``."""
    from repro_torch.configs.base import (AttentionKind, LayerTypesConfig,
                                          MoEConfig, RopeSpec)

    def rope(r):
        if r["rope_type"] == "default":
            return RopeSpec(theta=float(r["rope_theta"]))
        return RopeSpec(theta=float(r["rope_theta"]), kind=r["rope_type"],
                        factor=float(r["factor"]),
                        original_max_position=int(
                            r["original_max_position_embeddings"]),
                        beta_fast=float(r["beta_fast"]),
                        beta_slow=float(r["beta_slow"]),
                        attention_factor=float(r["attention_factor"]))

    kinds = tuple(
        (name, AttentionKind(window=s["window"] if name == "sliding_attention"
                             else None, rope=rope(r)))
        for name, r in s["rope"].items())
    return LayerTypesConfig(
        name=conf["name"], family="moe", num_layers=s["layers"],
        d_model=s["d_model"], num_heads=s["heads"],
        num_kv_heads=s["kv_heads"], head_dim=s["head_dim"],
        d_ff=s["d_expert"], vocab_size=s["vocab"], gated_ffn=True,
        moe=MoEConfig(num_experts=s["experts"], top_k=s["top_k"],
                      capacity_factor=None),
        pattern=(("attn", "moe"),), tie_embeddings=False,
        norm_eps=s["norm_eps"], dtype=s["dtype"], scan_layers=False,
        layer_types=tuple(_types(s)), attention_kinds=kinds)


def _shapes(s: Dict) -> Dict[str, tuple]:
    L, d, V, E, f = (s["layers"], s["d_model"], s["vocab"], s["experts"],
                     s["d_expert"])
    H, KV, hd = s["heads"], s["kv_heads"], s["head_dim"]
    return {"embed": (V, d), "head": (d, V), "wq": (L, d, H * hd),
            "wk": (L, d, KV * hd), "wv": (L, d, KV * hd),
            "wo": (L, H * hd, d), "we_gate_up": (L, E, d, 2 * f),
            "we_down": (L, E, f, d)}


def make_weights(s: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Stacked weights of shape ``s`` from ``seed``, on ``device``:
    N(0, init_std) for every matrix and the embedding in the served
    dtype, the router (L, d, E) in float32 (one call per kind of leaf),
    norm scales 1."""
    dtype = getattr(torch, s["dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    w = {}
    shapes = dict(_shapes(s), router=(s["layers"], s["d_model"],
                                      s["experts"]))
    for name, shape in shapes.items():
        t = torch.empty(shape, dtype=torch.float32 if name == "router"
                        else dtype, device=device)
        t.normal_(0.0, s["init_std"], generator=gen)
        w[name] = t
    L, d = s["layers"], s["d_model"]
    w["norm1"] = torch.ones((L, d), dtype=dtype, device=device)
    w["norm2"] = torch.ones((L, d), dtype=dtype, device=device)
    w["final_norm"] = torch.ones((d,), dtype=dtype, device=device)
    return w


def copy_weights(w: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.clone() for k, v in w.items()}


def engine_params(s: Dict, w: Dict[str, torch.Tensor]) -> Dict:
    """The port's param tree (``models/transformer.py::init_params``'s
    layout, the dropless MoE's ``we_gate_up``) as views of the stacks."""
    layers = []
    for i in range(s["layers"]):
        layers.append({
            "norm1": {"scale": w["norm1"][i]},
            "mixer": {k: w[k][i] for k in ("wq", "wk", "wv", "wo")},
            "norm2": {"scale": w["norm2"][i]},
            "ffn": {k: w[k][i] for k in ("router", "we_gate_up",
                                         "we_down")}})
    return {"embed": {"embed": w["embed"]}, "head": {"head": w["head"]},
            "final_norm": {"scale": w["final_norm"]}, "layers": layers}


def weight_bytes(s: Dict) -> int:
    """Bytes of one engine's weights."""
    elem = torch.finfo(getattr(torch, s["dtype"])).bits // 8
    n = sum(int(torch.Size(shape).numel()) for shape in _shapes(s).values())
    n += (2 * s["layers"] + 1) * s["d_model"]
    return n * elem + 4 * s["layers"] * s["d_model"] * s["experts"]


def page_bytes(s: Dict, page_size: int) -> int:
    """Bytes of one page of every layer's K and V pools."""
    elem = torch.finfo(getattr(torch, s["dtype"])).bits // 8
    return 2 * s["layers"] * s["kv_heads"] * page_size * s["head_dim"] * elem


def logits_at(weights: Dict[str, torch.Tensor], s: Dict, seqs, firsts,
              precision: str = "fp32"):
    """The plain model's logits (``reference/mellum.py``)."""
    return mellum.logits_at(weights, s, seqs, firsts, precision)


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------


def active_matmul_params(s: Dict) -> int:
    """The parameters a token multiplies: per layer the q/k/v/o
    projections, the router and its top-k experts' three matrices; the
    head.  Not the embedding lookup or the norms."""
    d, V, f = s["d_model"], s["vocab"], s["d_expert"]
    H, KV, hd = s["heads"], s["kv_heads"], s["head_dim"]
    per_layer = (d * H * hd + 2 * d * KV * hd + H * hd * d
                 + d * s["experts"] + s["top_k"] * 3 * d * f)
    return s["layers"] * per_layer + d * V


def window_keys(first: int, last: int, window: Optional[int]) -> int:
    """Keys read by positions ``first .. last - 1`` of one sequence, each
    reading itself and the positions before it, at most ``window`` in
    all: the sum of min(p + 1, window)."""
    if last <= first:
        return 0
    if window is None or last <= window:
        return (last * (last + 1) - first * (first + 1)) // 2
    cut = max(first, window)              # positions from here read window
    return window_keys(first, cut, None) + (last - cut) * window


def flops(s: Dict, first: int, last: int) -> float:
    """Model FLOPs of positions ``first .. last - 1`` of one sequence: 2
    per active matmul parameter per token, and in each layer 4 per head
    dimension per query head per key its window admits."""
    keys = sum(window_keys(first, last, s["window"]
                           if t == "sliding_attention" else None)
               for t in _types(s))
    return (2.0 * active_matmul_params(s) * (last - first)
            + 4.0 * s["head_dim"] * s["heads"] * keys)
