"""The paged steps cut at their attention kernels
(``serving/graphs.py``), run eagerly on the CPU: segment by segment with
each layer's attention kernel between, they compute what
``transformer.forward`` computes, bit for bit; the kernels are called
through ``ops`` once a layer as an eager step calls them; and the
engine's paged steps report how each call ran.  The replayed graphs are
held to the eager forward on the card in
``test_torch_paged_graphs_cuda.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.kernels import ops
from repro_torch.models.transformer import (forward, init_paged_states,
                                            init_params)
from repro_torch.serving import compiled
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.graphs import PagedPieces

CPU = torch.device("cpu")
PS, C, PAGES = 4, 8, 24
TABLE = [5, 9, 2, 11, 7, 3, 0]            # W 7: 28 positions, null padded


def _model(dtype: str, seed: int = 0):
    """starcoder2-7b's block (tied, GELU, no biases) at a CPU size, two
    layers; pools of random values, so that stale pages are read too."""
    cfg = dataclasses.replace(reduced(get_config("starcoder2-7b")),
                              dtype=dtype, long_context_window=None)
    params = init_params(cfg, torch.Generator().manual_seed(seed), CPU)
    states = init_paged_states(cfg, PAGES, PS, CPU)
    g = torch.Generator().manual_seed(seed + 1)
    for st in states:
        for t in st.values():
            t.copy_(torch.randn(t.shape, generator=g))
    return cfg, params, states


def _clone(states):
    return [{k: t.clone() for k, t in st.items()} for st in states]


def _chunk(cfg, start: int, n: int):
    """A chunk at ``start`` holding ``n`` prompt tokens, padded to C."""
    toks = torch.zeros((1, C), dtype=torch.int32)
    toks[0, :n] = torch.randint(1, cfg.vocab_size, (n,),
                                generator=torch.Generator().manual_seed(start))
    return {"tokens": toks, "start": start,
            "block_table": torch.tensor(TABLE, dtype=torch.int32)}


def _round(cfg, lengths):
    """A decode round over lanes of ``lengths``; a lane of length 0 is
    idle: a null table and the zero token, as the engine sends it."""
    B, W = len(lengths), len(TABLE)
    tables = torch.zeros((B, W), dtype=torch.int32)
    toks = torch.zeros((B, 1), dtype=torch.int32)
    g = torch.Generator().manual_seed(sum(lengths))
    for b, n in enumerate(lengths):
        if n:
            tables[b] = torch.tensor(TABLE).roll(b)
            toks[b, 0] = int(torch.randint(1, cfg.vocab_size, (1,),
                                           generator=g))
    return {"tokens": toks, "block_tables": tables,
            "lengths": torch.tensor(lengths, dtype=torch.int32)}


CASES = {"chunk_at_0": ("paged_prefill", (0, C)),
         "chunk_at_C": ("paged_prefill", (C, C)),
         "padded_chunk_at_13": ("paged_prefill", (13, 5)),
         "round": ("paged_decode", ((5, 0, 13, 0),)),
         "round_full": ("paged_decode", ((27, 1, 8, 16),))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_segments_compute_the_forward_exactly(case, dtype):
    """Segment 0, then each layer's kernel and the next segment, over the
    static buffers: the forward's logits, tokens and pools exactly."""
    cfg, params, states = _model(dtype)
    mode, args = CASES[case]
    batch = (_chunk(cfg, *args) if mode == "paged_prefill"
             else _round(cfg, *args))
    want_states = _clone(states)
    want = forward(params, cfg, batch, mode, states=want_states)
    pieces = PagedPieces(cfg, mode, batch)
    with torch.no_grad():
        got = pieces.run(params, states, batch)
    want = want["chunk_logits" if mode == "paged_prefill" else "logits"]
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    for st, wst in zip(states, want_states):
        for name in st:
            assert torch.equal(st[name], wst[name]), name


def test_kernels_are_called_through_ops_once_a_layer(monkeypatch):
    """Wrapped as the benchmark's probes wrap them, the kernels see one
    call a layer: a chunk's with its true ``q_offset``, a round's with a
    ``lengths`` that the next round through the same buffers leaves as it
    was."""
    cfg, params, states = _model("float32")
    L = cfg.num_layers
    fa, pd = ops.flash_attention, ops.paged_flash_decode
    attn, paged = [], []

    def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0):
        attn.append(int(q_offset))
        return fa(q, k, v, causal=causal, window=window, q_offset=q_offset)

    def paged_flash_decode(q, k_pages, v_pages, block_tables, lengths):
        paged.append((lengths, lengths.clone()))
        return pd(q, k_pages, v_pages, block_tables, lengths)

    monkeypatch.setattr(ops, "flash_attention", flash_attention)
    monkeypatch.setattr(ops, "paged_flash_decode", paged_flash_decode)
    chunk = _chunk(cfg, 13, 5)
    with torch.no_grad():
        PagedPieces(cfg, "paged_prefill", chunk).run(params, states, chunk)
        assert attn == [13] * L
        first, second = _round(cfg, (5, 0, 13, 0)), _round(cfg, (6, 0, 14, 0))
        pieces = PagedPieces(cfg, "paged_decode", first)
        pieces.run(params, states, first)
        pieces.run(params, states, second)
    assert len(paged) == 2 * L
    for i, (kept, seen) in enumerate(paged):
        want = (first if i < L else second)["lengths"] + 1
        assert torch.equal(kept, seen) and torch.equal(kept, want)
        assert kept is not pieces.inputs["lengths"]


def test_engine_steps_report_eager_calls_off_the_card():
    """On the CPU every paged step runs the eager forward: the shared
    callables count only eager calls, one a prefill chunk and one a decode
    round, and the engine's chunk and round spans say so."""
    compiled.clear_cache()
    cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")), num_layers=1)
    eng = ServeEngine(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                       CPU),
                      paged=True, max_len=32, max_lanes=2, page_size=4,
                      prefill_chunk=8, device=CPU, seed=0)
    tracing.enable()
    try:
        eng.generate(np.arange(11, dtype=np.int32)[None] % cfg.vocab_size, 3)
    finally:
        tracing.disable()
    spans = tracing.drain()
    graphs = compiled.cache_info()["graphs"]
    counts = {key[0]: c for key, c in graphs.items()}
    assert counts == {
        "paged_prefill": {"captures": 0, "replays": 0, "eager": eng.prefills},
        "paged_decode": {"captures": 0, "replays": 0,
                         "eager": eng.decode_rounds}}
    assert (eng.prefills, eng.decode_rounds) == (2, 2)
    steps = [s for s in spans if s["name"] in ("engine.prefill_chunk",
                                               "engine.decode_round")]
    assert len(steps) == 4 and all(s["attrs"]["graph"] == "eager"
                                   for s in steps)
