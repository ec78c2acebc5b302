"""The dense kind is the decoder the benchmark ran before kinds existed:
at the CPU rehearsal's sizes and a fixed seed it gives, bit for bit, the
weights (every leaf, in the same order, from the same draws), the
port's param tree, the second engine's copy, the reference's logits in
float32 and in its float8 control, the FLOPs of spans of positions and
the bytes ``size_pool.py`` reads that the harness's own functions gave
at the commit before (the checksums below were recorded there)."""
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
CONF = HERE / "configs" / "starcoder2-7b-edge2.json"
SEED = 2**31 + 7
SHRINK = {"layers": 2, "d_model": 64, "heads": 4, "kv_heads": 2,
          "d_ff": 96, "vocab": 97, "dtype": "float32"}
CASES = {"fp32": SHRINK,
         "bf16": {**SHRINK, "dtype": "bfloat16"},
         "bf16-gated-untied-bias": {**SHRINK, "dtype": "bfloat16",
                                    "gated": True, "tied": False,
                                    "qkv_bias": True}}
PAIRS = [(0, 1), (0, 2048), (5, 9), (1500, 1563), (100, 100), (2047, 3647)]


def _h(t: torch.Tensor) -> str:
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], f"{pre}/{k}")
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _flat(x, f"{pre}/{i}")
    else:
        yield pre, _h(tree)


def _joined(pairs) -> str:
    text = ";".join(f"{k}:{v}" for k, v in pairs)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def sums(kind, conf, shrink):
    """The checksums of ``kind`` (spec, make_weights, copy_weights,
    engine_params, logits_at, flops, weight_bytes, page_bytes) at
    ``shrink``."""
    s = kind.spec(conf, shrink)
    w = kind.make_weights(s, SEED, torch.device("cpu"))
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, s["vocab"], n) for n in (9, 23)]
    firsts = [3, 0]
    return {
        "spec": _joined(sorted((k, repr(v)) for k, v in s.items())),
        "weights": {k: _h(v) for k, v in w.items()},
        "copy": _joined((k, _h(v)) for k, v in kind.copy_weights(w).items()),
        "params": _joined(_flat(kind.engine_params(s, w))),
        "logits_fp32": _h(torch.cat(kind.logits_at(w, s, seqs, firsts,
                                                   "fp32"))),
        "logits_fp8": _h(torch.cat(kind.logits_at(w, s, seqs, firsts,
                                                  "fp8"))),
        "flops": [kind.flops(s, a, b) for a, b in PAIRS],
        "bytes": [kind.weight_bytes(s), kind.page_bytes(s, 16)],
    }


# recorded with the helpers above from the commit before kinds
PARENT = {
    "bf16": {
        "spec": "0bb82d0c61b18d3f",
        "weights": {
            "embed": "5241d9897f1aa602",
            "wq": "2c4b00b35e423462",
            "wk": "4265e9a24f7c5e51",
            "wv": "b3a654b23ef92c0c",
            "wo": "60e73c12d4da4f2e",
            "w_up": "ab32f717fb6628c5",
            "w_down": "5f0f8fdc6962aae3",
            "norm1": "1ede9ebfa1ad011b",
            "norm2": "1ede9ebfa1ad011b",
            "final_norm": "e72710531b01d91e"
        },
        "copy": "a65217e600121bf0",
        "params": "d1e9ca58e852f00b",
        "logits_fp32": "bd7052ff381f192f",
        "logits_fp8": "aaacb04751f7ccbe",
        "flops": [
            111232.0, 1301020672.0, 458240.0, 56391552.0, 0.0, 2509824000.0],
        "bytes": [111360, 4096]
    },
    "bf16-gated-untied-bias": {
        "spec": "27b5f3836d86b7b9",
        "weights": {
            "embed": "5241d9897f1aa602",
            "wq": "2c4b00b35e423462",
            "wk": "4265e9a24f7c5e51",
            "wv": "b3a654b23ef92c0c",
            "wo": "60e73c12d4da4f2e",
            "w_up": "ab32f717fb6628c5",
            "w_down": "5f0f8fdc6962aae3",
            "w_gate": "a4f7539c62ac6f46",
            "head": "64a4dfe358649336",
            "bq": "eafc3d8a4e0a7dd4",
            "bk": "a21ae41a4ebc1224",
            "bv": "5f521eee2afff01b",
            "norm1": "1ede9ebfa1ad011b",
            "norm2": "1ede9ebfa1ad011b",
            "final_norm": "e72710531b01d91e"
        },
        "copy": "d65421891a8a2c14",
        "params": "e37cde79365e93c3",
        "logits_fp32": "3efec8b7d2a8e90f",
        "logits_fp8": "1e60125424b3fb55",
        "flops": [
            135808.0, 1351352320.0, 556544.0, 57939840.0, 0.0, 2549145600.0],
        "bytes": [148864, 4096]
    },
    "fp32": {
        "spec": "6883d6437fadcf7f",
        "weights": {
            "embed": "f87dd80e428d2c56",
            "wq": "e399a1485ab2691a",
            "wk": "a0b8dc46d435c089",
            "wv": "253aa708bc399ae7",
            "wo": "34c80e29c3c4bfdd",
            "w_up": "cbfefd323473a795",
            "w_down": "5d923daa8da896e5",
            "norm1": "02722f124d0f1736",
            "norm2": "02722f124d0f1736",
            "final_norm": "2f20cd03c9cd392a"
        },
        "copy": "03db5a7a8101662d",
        "params": "41e8a87423aeb608",
        "logits_fp32": "8407e9dd7bed4cd0",
        "logits_fp8": "9ec551f902997d55",
        "flops": [
            111232.0, 1301020672.0, 458240.0, 56391552.0, 0.0, 2509824000.0],
        "bytes": [222720, 8192]
    },
    "full": {
        "spec": {
            "layers": 32,
            "d_model": 4608,
            "heads": 36,
            "kv_heads": 4,
            "head_dim": 128,
            "d_ff": 18432,
            "vocab": 49152,
            "gated": False,
            "tied": True,
            "qkv_bias": False,
            "rope_theta": 1000000.0,
            "norm_eps": 1e-05,
            "init_std": 0.018042,
            "dtype": "bfloat16"
        },
        "flops": [
            14345109504.0, 30615130865664.0, 57395773440.0, 960632193024.0,
            0.0, 25638469632000.0],
        "bytes": [14345118720, 1048576]
    }
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_kind_reproduces_the_parent(case):
    from perfbench import harness
    conf = json.loads(CONF.read_text())
    kind = harness.model_kind(conf["model"])
    got = sums(kind, conf, CASES[case])
    want = PARENT[case]
    assert list(got["weights"]) == list(want["weights"])
    assert got == want


def test_dense_kind_full_size_arithmetic():
    """The cell's own sizes: the spec, the FLOPs ``mfu.open`` counts and
    the bytes ``size_pool.py`` sized the pool from."""
    from perfbench import harness
    conf = json.loads(CONF.read_text())
    kind = harness.model_kind(conf["model"])
    s = kind.spec(conf)
    assert s == PARENT["full"]["spec"]
    assert [kind.flops(s, a, b) for a, b in PAIRS] == PARENT["full"]["flops"]
    assert [kind.weight_bytes(s), kind.page_bytes(s, 16)] == \
        PARENT["full"]["bytes"]
