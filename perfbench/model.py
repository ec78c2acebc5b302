"""A configuration file's model: its shape, the port's ``ModelConfig``,
and random weights drawn on the device from the run's seed.

The weights are the harness's own: one tensor per kind of leaf, stacked
over the layers and drawn in a few large calls in the type they are
served in.  ``engine_params`` hands the port the layout ``ServeEngine``
takes (per-layer views of those tensors); the reference reads the
stacked tensors themselves.  The LAD-TS actor that places requests is
drawn here too (``make_actor``), from the configuration's fixed
``actor_seed``, and handed to the scheduler and to the reference alike.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Optional

import torch

from perfbench.reference import ladn

ACT_GATED = {"silu": True, "gelu_pytorch_tanh": False}


def load(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


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


def make_actor(sch: Dict, device) -> Dict:
    """The LAD-TS actor of the configuration's ``scheduler`` block, one
    agent per origin station, from its ``actor_seed`` on ``device``:
    ``theta``, the LADN's layers [{"w" (G, in, out), "b" (G, out)}] drawn
    U(-1/sqrt(in), 1/sqrt(in)) (the port's and the paper's MLP rule), and
    ``X`` (G, max_tasks, A), the latent action store, N(0, 1).  The same
    for every run: the deployed policy stands in for a trained one as the
    model's random weights stand in for a checkpoint."""
    gen = torch.Generator(device=device).manual_seed(int(sch["actor_seed"]))
    G, A = sch["stations"], sch["engines"]
    dims = (A + ladn.TIME_EMBED_DIM + sch["state_dim"], *sch["hidden"], A)
    theta: List[Dict[str, torch.Tensor]] = []
    for nin, nout in zip(dims[:-1], dims[1:]):
        lim = 1.0 / math.sqrt(nin)
        layer = {}
        for key, shape in (("w", (G, nin, nout)), ("b", (G, nout))):
            t = torch.empty(shape, device=device)
            t.uniform_(-lim, lim, generator=gen)
            layer[key] = t
        theta.append(layer)
    X = torch.empty((G, sch["max_tasks"], A), device=device)
    X.normal_(0.0, 1.0, generator=gen)
    return {"theta": theta, "X": X}


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
