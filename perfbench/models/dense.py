"""The dense decoder: full causal attention and a dense MLP in every
layer, one RoPE for all (the port's ``family="dense"``).

Its weights are the harness's own: one tensor per kind of leaf, stacked
over the layers and drawn in a few large calls in the type they are
served in.  ``engine_params`` hands the port the layout ``ServeEngine``
takes (per-layer views of those tensors); the reference
(``reference/decoder.py``) reads the stacked tensors themselves.  Its
FLOPs are frozen copies of the port's counts
(``repro_torch/configs/base.py``'s ``param_count``,
``repro_torch/roofline/analysis.py``'s ``model_flops``), held to them by
``test_perfbench_roofline.py``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench import roofline
from perfbench.reference import decoder

ACT_GATED = {"silu": True, "gelu_pytorch_tanh": False}


def spec(conf: Dict, shrink: Optional[Dict] = None) -> Dict:
    """The decoder's shape from a configuration file, with ``shrink``'s
    keys replaced (the CPU rehearsal's sizes)."""
    c, serve = conf["config"], conf["serve"]
    d, H = c["hidden_size"], c["num_attention_heads"]
    s = {
        "layers": c["num_hidden_layers"], "d_model": d, "heads": H,
        "kv_heads": c["num_key_value_heads"],
        "head_dim": c.get("head_dim", d // H),
        "d_ff": c["intermediate_size"], "vocab": c["vocab_size"],
        "gated": ACT_GATED[c["hidden_act"]],
        "tied": bool(c.get("tie_word_embeddings", False)),
        "qkv_bias": bool(serve["qkv_bias"]),
        "rope_theta": float(c["rope_theta"]),
        "norm_eps": float(c.get("rms_norm_eps", c.get("norm_epsilon"))),
        "init_std": float(c["initializer_range"]),
        "dtype": serve["dtype"],
    }
    if shrink:
        s.update(shrink)
        if "head_dim" not in shrink:
            s["head_dim"] = s["d_model"] // s["heads"]
    return s


def model_config(conf: Dict, s: Dict):
    """The port's ``ModelConfig`` of shape ``s``."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=conf["name"], family="dense", num_layers=s["layers"],
        d_model=s["d_model"], num_heads=s["heads"],
        num_kv_heads=s["kv_heads"], head_dim=s["head_dim"],
        d_ff=s["d_ff"], vocab_size=s["vocab"], qkv_bias=s["qkv_bias"],
        rope_theta=s["rope_theta"], gated_ffn=s["gated"],
        tie_embeddings=s["tied"], pattern=(("attn", "dense"),),
        norm_eps=s["norm_eps"], dtype=s["dtype"], scan_layers=False)


def make_weights(s: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Stacked weights of shape ``s`` from ``seed``, on ``device``, in the
    served dtype: N(0, init_std) for every matrix, the embedding and the
    biases (one call per kind of leaf), norm scales 1."""
    dtype = getattr(torch, s["dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    L, d, f, V = s["layers"], s["d_model"], s["d_ff"], s["vocab"]
    H, KV, hd = s["heads"], s["kv_heads"], s["head_dim"]
    shapes = {"embed": (V, d), "wq": (L, d, H * hd), "wk": (L, d, KV * hd),
              "wv": (L, d, KV * hd), "wo": (L, H * hd, d),
              "w_up": (L, d, f), "w_down": (L, f, d)}
    if s["gated"]:
        shapes["w_gate"] = (L, d, f)
    if not s["tied"]:
        shapes["head"] = (d, V)
    if s["qkv_bias"]:
        shapes.update(bq=(L, H * hd), bk=(L, KV * hd), bv=(L, KV * hd))
    w = {}
    for name, shape in shapes.items():
        t = torch.empty(shape, dtype=dtype, device=device)
        t.normal_(0.0, s["init_std"], generator=gen)
        w[name] = t
    w["norm1"] = torch.ones((L, d), dtype=dtype, device=device)
    w["norm2"] = torch.ones((L, d), dtype=dtype, device=device)
    w["final_norm"] = torch.ones((d,), dtype=dtype, device=device)
    return w


def copy_weights(w: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.clone() for k, v in w.items()}


def engine_params(s: Dict, w: Dict[str, torch.Tensor]) -> Dict:
    """The port's param tree (``models/transformer.py::init_params``'s
    layout) as views of the stacked weights."""
    layers = []
    for i in range(s["layers"]):
        mixer = {k: w[k][i] for k in ("wq", "wk", "wv", "wo")}
        if s["qkv_bias"]:
            mixer.update({k: w[k][i] for k in ("bq", "bk", "bv")})
        ffn = {"w_up": w["w_up"][i], "w_down": w["w_down"][i]}
        if s["gated"]:
            ffn["w_gate"] = w["w_gate"][i]
        layers.append({"norm1": {"scale": w["norm1"][i]}, "mixer": mixer,
                       "norm2": {"scale": w["norm2"][i]}, "ffn": ffn})
    params = {"embed": {"embed": w["embed"]},
              "final_norm": {"scale": w["final_norm"]}, "layers": layers}
    if not s["tied"]:
        params["head"] = {"head": w["head"]}
    return params


def weight_bytes(s: Dict) -> int:
    """Bytes of one engine's weights."""
    elem = torch.finfo(getattr(torch, s["dtype"])).bits // 8
    L, d, f, V = s["layers"], s["d_model"], s["d_ff"], s["vocab"]
    H, KV, hd = s["heads"], s["kv_heads"], s["head_dim"]
    n = V * d + (0 if s["tied"] else d * V) + d
    n += L * (d * H * hd + 2 * d * KV * hd + H * hd * d
              + (3 if s["gated"] else 2) * d * f + 2 * d)
    if s["qkv_bias"]:
        n += L * (H + 2 * KV) * hd
    return n * elem


def page_bytes(s: Dict, page_size: int) -> int:
    """Bytes of one page of every layer's K and V pools."""
    elem = torch.finfo(getattr(torch, s["dtype"])).bits // 8
    return 2 * s["layers"] * s["kv_heads"] * page_size * s["head_dim"] * elem


def logits_at(weights: Dict[str, torch.Tensor], s: Dict, seqs, firsts,
              precision: str = "fp32"):
    """The plain decoder's logits (``reference/decoder.py``)."""
    return decoder.logits_at(weights, s, seqs, firsts, precision)


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------


def param_count(s: Dict) -> int:
    """Parameters of a dense decoder of ``s`` (:func:`spec`'s keys), as
    the port's ``ModelConfig.param_count`` counts them: the embedding,
    the head unless tied, per layer the q/k/v/o projections, the MLP (3
    matrices gated, 2 not) and two norm scales; QKV biases and the final
    norm are not counted."""
    d, f, V = s["d_model"], s["d_ff"], s["vocab"]
    H, KV, hd = s["heads"], s["kv_heads"], s["head_dim"]
    n = V * d + (0 if s["tied"] else d * V)
    per_layer = (d * H * hd + 2 * d * KV * hd + H * hd * d
                 + (3 if s["gated"] else 2) * d * f + 2 * d)
    return n + s["layers"] * per_layer


def model_flops(s: Dict, kind: str, tokens: int) -> float:
    """``roofline/analysis.py``'s MODEL_FLOPS: 6 N D to train, 2 N D to
    infer, N the parameters, D the tokens."""
    n = param_count(s)
    return (6.0 if kind == "train" else 2.0) * n * tokens


def matmul_params(s: Dict) -> int:
    """The parameters a token multiplies: every projection and MLP
    matrix, and the head (the embedding matrix itself where tied); not
    the embedding lookup, the norms or the biases."""
    d, f, V = s["d_model"], s["d_ff"], s["vocab"]
    H, KV, hd = s["heads"], s["kv_heads"], s["head_dim"]
    per_layer = (d * H * hd + 2 * d * KV * hd + H * hd * d
                 + (3 if s["gated"] else 2) * d * f)
    return s["layers"] * per_layer + d * V


def sequence_flops(s: Dict, tokens: int, keys: int) -> float:
    """Model FLOPs of ``tokens`` tokens that attend ``keys`` keys in all:
    2 per matmul parameter per token, and in every layer 4 per head
    dimension per query head per key (scores and the weighted sum)."""
    return (2.0 * matmul_params(s) * tokens
            + 4.0 * s["head_dim"] * s["heads"] * s["layers"] * keys)


def flops(s: Dict, first: int, last: int) -> float:
    """Model FLOPs of positions ``first .. last - 1`` of one sequence,
    each attending every earlier position and itself."""
    return sequence_flops(s, last - first, roofline.span_keys(first, last))
