"""Mellum2's new paths on the card: the windowed paged decode kernel
against its plain version at the window's edges, the dropless grouped
MoE against a per-token loop at the published widths, and a reduced
Mellum2's paged steps replayed from CUDA graphs bit for bit equal to the
eager forward, each layer's attention kernel launched once a call.
Imports no JAX, so it runs on the GPU machine:
``python3 -m pytest -q -m cuda tests/test_torch_mellum_cuda.py``."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.models import moe
from repro_torch.models.transformer import (forward, init_paged_states,
                                            init_params)
from repro_torch.serving import compiled
from repro_torch.train.steps import pick_tokens

# the paged decode tests' tolerances (test_torch_decode_split_cuda.py):
# bf16 outputs carry 2^-8 relative rounding; f32 the kernel's FMA order
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [1024, 40])
def test_window_decode_matches_the_plain_path(dtype, window):
    """Mellum2's decode shape (32 query heads over 4, hd 128, pages of
    16, a 3648-token table): lanes shorter than the window, at it, one
    past it mid-page, far past it, and idle; the kernel against
    ``ref.paged_decode_window_ref`` on the same scrambled pages."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    H, KV, hd, ps, Wt = 32, 4, 128, 16, 228
    lens = [window - 7, window, window + 1, window + 9, 3000, 3648, 1, 0]
    B, P = len(lens), 1 + len(lens) * Wt
    q = torch.randn((B, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((P, KV, ps, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((P, KV, ps, hd), generator=g, device=dev).to(dtype)
    tables = (1 + torch.randperm(P - 1, generator=g, device=dev)[:B * Wt]
              ).reshape(B, Wt).to(torch.int32)
    n = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = ops.launches["paged_flash_decode_window"]
    got = ops.paged_flash_decode_window(q, k, v, tables, n, window)
    torch.cuda.synchronize()
    assert ops.launches["paged_flash_decode_window"] - before == 1
    want = ref.paged_decode_window_ref(q, k, v, tables, n, window)
    live = n > 0
    err = (got.float() - want.float())[live].abs().max().item()
    assert err <= TOL[dtype], err
    assert torch.all(got[~live] == 0)
    # the window is what the kernel reads: a full-length read differs
    full = ref.paged_decode_ref(q, k, v, tables, n)
    assert (got.float() - full.float())[n > window].abs().max() > 0.05


@pytest.mark.cuda
def test_grouped_moe_matches_a_per_token_loop_at_published_widths():
    """64 experts of 896 over d 2304, top-8, 96 tokens in bf16, a router
    that sends most rows to expert 5: every token's output against the
    sum of its 8 experts computed one token at a time in f32 from the
    same bf16 weights (bf16 rounding of the products' inputs and outputs:
    within 3e-2 of the largest output)."""
    dev = _card()
    cfg = get_config("mellum2-12b")
    p = moe.init_moe(torch.Generator(device=dev).manual_seed(1), cfg,
                     torch.bfloat16, dev)
    # inputs with a mean of 0.1 on every dim against a router column of
    # 5 raised by 0.02: expert 5's logit gains ~4.6, so nearly every token
    # picks it
    p["router"][:, 5] += 0.02
    x = (torch.randn((1, 96, cfg.d_model), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(2))
         + 0.1).bfloat16()
    out, _ = moe.apply_moe(p, cfg, x)
    xf = x[0].float()
    probs = torch.softmax(xf @ p["router"], -1)
    gate, idx = torch.topk(probs, cfg.moe.top_k, -1)
    gate = gate / gate.sum(-1, keepdim=True)
    f = cfg.d_ff
    want = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(cfg.moe.top_k):
            e = int(idx[t, j])
            h = xf[t] @ p["we_gate_up"][e].float()
            a = torch.nn.functional.silu(h[:f]) * h[f:]
            want[t] += gate[t, j] * (a @ p["we_down"][e].float())
    assert int((idx == 5).sum()) >= 90
    err = (out[0].float() - want).abs().max() / want.abs().max()
    assert err < 3e-2, float(err)


@pytest.mark.cuda
def test_mellum_replays_equal_the_eager_forward():
    """A reduced Mellum2 (a period of three windowed layers, window 64,
    and one yarn layer; 8 experts top-2, dropless): two prompts' chunks
    across the window, then three decode rounds over four lanes; each
    call's logits and pools equal the eager forward's, each windowed layer
    launches ``paged_flash_decode_window`` once a round and the full one
    ``paged_flash_decode``, and every call adds its rows to the counter;
    in bf16, the one dtype the dropless MoE runs in on the card (f32
    raises)."""
    dev = _card()
    PAGES, PS, C, W = 64, 16, 64, 12
    small = reduced(get_config("mellum2-12b"), num_layers=4, d_model=512,
                    max_experts=8)
    cfg = dataclasses.replace(small, dtype="bfloat16")
    f32 = dataclasses.replace(small, dtype="float32")
    with pytest.raises(ValueError, match="bfloat16 only"):
        moe.apply_moe(moe.init_moe(torch.Generator(device=dev).manual_seed(0),
                                   f32, torch.float32, dev),
                      f32, torch.zeros((1, 4, f32.d_model), device=dev))
    windowed = sum(b.window is not None for b in cfg.layer_pattern())
    assert windowed == 3
    compiled.clear_cache()
    prefill = compiled.paged_prefill_step(cfg, PAGES, PS)
    decode = compiled.paged_decode_step(cfg, PAGES, PS, False, 1.0)
    params, counter = moe.with_row_counter(
        init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev),
        cfg, dev)
    states = init_paged_states(cfg, PAGES, PS, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    tables = [torch.arange(1 + s * W, 1 + (s + 1) * W, dtype=torch.int32,
                           device=dev) for s in range(2)]
    K = cfg.moe.top_k
    last = []
    for s, n in enumerate((150, 40)):
        prompt = torch.randint(1, cfg.vocab_size, (n,), generator=g,
                               device=dev, dtype=torch.int32)
        for start in range(0, n, C):
            toks = torch.zeros((1, C), dtype=torch.int32, device=dev)
            part = prompt[start:start + C]
            toks[0, :len(part)] = part
            batch = {"tokens": toks, "start": start, "block_table": tables[s]}
            want_pools = [{k: t.clone() for k, t in st.items()}
                          for st in states]
            want = forward(params, cfg, batch, "paged_prefill",
                           states=want_pools)["chunk_logits"]
            rows = counter.clone()
            got, _ = prefill(params, batch, states)
            assert torch.equal(got, want)
            assert int((counter - rows).sum(1).min()) == C * K
        last.append(int(got[0, len(part) - 1].argmax()))
    toks = torch.tensor([[last[0]], [0], [last[1]], [0]], dtype=torch.int32,
                        device=dev)
    block_tables = torch.zeros((4, W), dtype=torch.int32, device=dev)
    block_tables[0], block_tables[2] = tables
    lengths = torch.tensor([150, 0, 40, 0], dtype=torch.int32, device=dev)
    for _ in range(3):
        batch = {"tokens": toks, "block_tables": block_tables,
                 "lengths": lengths}
        want_pools = [{k: t.clone() for k, t in st.items()} for st in states]
        want = forward(params, cfg, batch, "paged_decode",
                       states=want_pools)["logits"]
        full = ops.launches["paged_flash_decode"]
        win = ops.launches["paged_flash_decode_window"]
        got, tok, _ = decode(params, batch, states)
        assert ops.launches["paged_flash_decode"] - full == 1
        assert ops.launches["paged_flash_decode_window"] - win == windowed
        assert torch.equal(got, want)
        assert torch.equal(tok, pick_tokens(want, False, 1.0, None))
        assert all(torch.equal(a[k], b[k]) for a, b in zip(states,
                                                            want_pools)
                   for k in a)
        toks = tok[:, None]
        lengths = lengths + torch.tensor([1, 0, 1, 0], dtype=torch.int32,
                                         device=dev)
    graphs = {key[0]: c for key, c in compiled.cache_info()["graphs"].items()}
    assert graphs == {
        "paged_prefill": {"captures": 1, "replays": 3, "eager": 0},
        "paged_decode": {"captures": 1, "replays": 2, "eager": 0}}
