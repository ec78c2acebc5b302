"""The paged steps replayed from CUDA graphs cut at the attention
kernels (``serving/graphs.py``) on the card: two engines' weights and
pools behind the shared step callables, every prefill chunk and decode
round bit for bit equal to the eager forward on the same inputs, with
the same attention launches.  Imports no JAX, so it runs on the GPU
machine:
``python3 -m pytest -q -m cuda tests/test_torch_paged_graphs_cuda.py``."""
import dataclasses
import gc

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.kernels import ops
from repro_torch.models.transformer import (forward, init_paged_states,
                                            init_params)
from repro_torch.serving import compiled
from repro_torch.train.steps import pick_tokens

PAGES, PS, C, W = 64, 16, 64, 12
PROMPTS = (150, 40)                    # 3 chunks (the last padded), 1


def _clone(states):
    return [{k: t.clone() for k, t in st.items()} for st in states]


def _same_pools(a, b) -> bool:
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_replays_equal_the_eager_forward(dtype):
    """Per engine: the chunks of two prompts, then three rounds over four
    lanes (two idle); each call's logits, tokens and pools = the eager
    forward's on a copy of the pools before it, and ``flash_attention``
    or ``paged_flash_decode`` launched once a layer.  One capture per
    engine and step, replays after; a returned tensor outlives the next
    call; a capture goes with its engine's pools."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(reduced(get_config("starcoder2-7b"),
                                      num_layers=3, d_model=512),
                              dtype=dtype, long_context_window=None)
    L = cfg.num_layers
    compiled.clear_cache()
    prefill = compiled.paged_prefill_step(cfg, PAGES, PS)
    decode = compiled.paged_decode_step(cfg, PAGES, PS, False, 1.0)
    engines = [(init_params(cfg, torch.Generator(device=dev).manual_seed(e),
                            dev), init_paged_states(cfg, PAGES, PS, dev))
               for e in range(2)]
    assert compiled.paged_prefill_step(cfg, PAGES, PS) is prefill
    g = torch.Generator(device=dev).manual_seed(7)
    kept = []
    for e, (params, states) in enumerate(engines):
        tables = [torch.arange(1 + (2 * e + s) * W, 1 + (2 * e + s + 1) * W,
                               dtype=torch.int32, device=dev)
                  for s in range(2)]
        last = []
        for s, n in enumerate(PROMPTS):
            prompt = torch.randint(1, cfg.vocab_size, (n,), generator=g,
                                   device=dev, dtype=torch.int32)
            for start in range(0, n, C):
                toks = torch.zeros((1, C), dtype=torch.int32, device=dev)
                part = prompt[start:start + C]
                toks[0, :len(part)] = part
                batch = {"tokens": toks, "start": start,
                         "block_table": tables[s]}
                want_pools = _clone(states)
                want = forward(params, cfg, batch, "paged_prefill",
                               states=want_pools)["chunk_logits"]
                before = ops.launches["flash_attention"]
                got, _ = prefill(params, batch, states)
                assert ops.launches["flash_attention"] - before == L
                assert torch.equal(got, want)
                assert _same_pools(states, want_pools)
                kept.append((got, got.clone()))
            last.append(int(got[0, len(part) - 1].argmax()))
        toks = torch.tensor([[last[0]], [0], [last[1]], [0]],
                            dtype=torch.int32, device=dev)
        block_tables = torch.zeros((4, W), dtype=torch.int32, device=dev)
        block_tables[0], block_tables[2] = tables
        lengths = torch.tensor([PROMPTS[0], 0, PROMPTS[1], 0],
                               dtype=torch.int32, device=dev)
        step = torch.tensor([1, 0, 1, 0], dtype=torch.int32, device=dev)
        for _ in range(3):
            batch = {"tokens": toks, "block_tables": block_tables,
                     "lengths": lengths}
            want_pools = _clone(states)
            want = forward(params, cfg, batch, "paged_decode",
                           states=want_pools)["logits"]
            before = ops.launches["paged_flash_decode"]
            got, tok, _ = decode(params, batch, states)
            assert ops.launches["paged_flash_decode"] - before == L
            assert torch.equal(got, want)
            assert torch.equal(tok, pick_tokens(want, False, 1.0, None))
            assert _same_pools(states, want_pools)
            kept.append((got, got.clone()))
            toks, lengths = tok[:, None], lengths + step
    assert all(torch.equal(a, b) for a, b in kept)
    graphs = {key[0]: c for key, c in compiled.cache_info()["graphs"].items()}
    assert graphs == {
        "paged_prefill": {"captures": 2, "replays": 6, "eager": 0},
        "paged_decode": {"captures": 2, "replays": 4, "eager": 0}}
    assert len(prefill._pieces) == len(decode._pieces) == 2
    del engines[0], params, states
    gc.collect()
    assert len(prefill._pieces) == len(decode._pieces) == 1
