"""The yardstick's frozen copies count what the port's own counts give
today, at each configuration's and cell's shapes; the dense kind's
counts through the kind its configurations name."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import harness, model, roofline

CONFIGS = sorted((Path(__file__).resolve().parent / "configs").glob("*.json"))
DENSE = [p for p in CONFIGS if model.load(p)["model"] == "dense"]


def _kind_spec(path, shrink=None):
    conf = model.load(path)
    kind = harness.model_kind(conf["model"])
    return conf, kind, kind.spec(conf, shrink)


@pytest.mark.parametrize("path", DENSE, ids=lambda p: p.stem)
def test_param_and_model_flops_match_the_port(path):
    from repro_torch.roofline import analysis
    conf, dense, s = _kind_spec(path)
    cfg = dense.model_config(conf, s)
    assert dense.param_count(s) == cfg.param_count()
    for kind, batch, seq in (("prefill", 1, 2048), ("decode", 32, 1),
                             ("train", 2, 512)):
        shape = SimpleNamespace(kind=kind, global_batch=batch, seq_len=seq)
        tokens = batch * (seq if kind != "decode" else 1)
        assert dense.model_flops(s, kind, tokens) == \
            pytest.approx(analysis.model_flops(cfg, shape))
    # matmul parameters: everything but the embedding lookup, the norms
    # and the biases, the head counted once
    d, V, L = s["d_model"], s["vocab"], s["layers"]
    head = 0 if s["tied"] else d * V
    assert dense.matmul_params(s) == \
        cfg.param_count() - V * d - head - 2 * d * L + d * V
    # a span of positions: 2 N D over the matmul parameters, and the
    # causal keys once
    assert dense.flops(s, 100, 2148) == dense.sequence_flops(
        s, 2048, roofline.span_keys(100, 2148))


def test_peaks_match_the_port():
    from repro_torch.launch import mesh
    assert roofline.PEAK_FLOPS_BF16 == mesh.PEAK_FLOPS_BF16
    assert roofline.HBM_BW == mesh.HBM_BW


def _cell_shapes(path):
    """The flash_attention and paged decode calls of a configuration's
    paged engine: a 2048-token chunk at offsets 0, 1024 and 2048 against
    the full table, and a round of every lane."""
    conf, _, s = _kind_spec(path)
    sv = conf["serve"]
    ps, C = sv["page_size"], sv["prefill_chunk"]
    W = -(-sv["max_len"] // ps) + -(-C // ps) + 1
    attn = [(1, s["heads"], s["kv_heads"], C, W * ps, s["head_dim"], None,
             off, 2) for off in (0, 1024, 2048)]
    lengths = [(37 * i) % sv["max_len"] for i in range(sv["lanes"])]
    dec = (sv["lanes"], s["heads"], s["kv_heads"], s["head_dim"], ps, W,
           lengths, 2)
    return attn, dec


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_kernel_costs_match_the_port_bench(path):
    from repro_torch.bench import kernels
    attn, dec = _cell_shapes(path)
    for (B, H, KV, Sq, Skv, hd, win, off, elem) in attn:
        nbytes, flops = roofline.flash_attention_cost(B, H, KV, Sq, Skv, hd,
                                                      win, off, elem)
        pairs = kernels.attn_pairs(Sq, Skv, win, off)
        assert roofline.attn_pairs(Sq, Skv, win, off) == pairs
        # bench/kernels.py::_attention_rows's count
        assert nbytes == elem * (2 * B * H * Sq * hd + 2 * B * KV * Skv * hd)
        assert flops == 4 * B * H * hd * pairs
        ms, by = kernels.bound(nbytes, flops, "bfloat16")
        t, by2 = roofline.bound_s(nbytes, flops)
        assert t * 1e3 == pytest.approx(ms) and by == by2
    B, H, KV, hd, ps, W, lengths, elem = dec
    nbytes, flops = roofline.paged_decode_cost(*dec)
    # bench/kernels.py::_paged_rows's count
    ctx = sum(min(n, W * ps) for n in lengths)
    assert nbytes == (2 * B * H * hd * elem + 2 * ctx * KV * hd * elem
                      + B * W * 4 + B * 4)
    assert flops == 4 * ctx * H * hd


def test_span_keys():
    assert roofline.span_keys(0, 3) == 1 + 2 + 3
    assert roofline.span_keys(5, 5) == 0
    assert roofline.span_keys(4, 6) == 5 + 6


def test_benchmark_names_only_known_configs():
    bench = json.loads((Path(__file__).resolve().parent.parent
                        / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        conf = model.load(Path(__file__).resolve().parent.parent / c["file"])
        assert conf["source"] == c["source"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
