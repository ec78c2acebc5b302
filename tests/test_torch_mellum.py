"""Mellum2-12B-A2.5B in the port (``configs/mellum2_12b.py``, the port's
own config: sliding and full attention layers with their own RoPE, yarn
on the full ones, 64 dropless experts top-8), held on the CPU at small
sizes to the benchmark's plain float32 reference
(``perfbench/reference/mellum.py``) on seeded random weights, logits
against logits: the paged engine's chunks and decode rounds, the
dropless experts, the yarn tables, the windowed decode's plain route and
the graphed pieces; every config of the reference builds as before."""
import dataclasses
import math
import sys
from pathlib import Path

import jax  # noqa: F401  (the reference's configs below)
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.serving import paged_kv as jax_paged_kv
from repro_torch.configs import (RopeSpec, get_config, reduced)
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import attention, moe
from repro_torch.models.layers import apply_rope, rope_freqs, yarn_freqs
from repro_torch.models.transformer import (forward, init_paged_states,
                                            init_params)
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.graphs import PagedPieces
from repro_torch.serving.paged_kv import paged_supported

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from perfbench import harness  # noqa: E402
from perfbench.reference import mellum as plain  # noqa: E402

from _torch_train import one_thread  # noqa: E402

_one_thread = pytest.fixture(autouse=True)(one_thread)
CPU = torch.device("cpu")
KIND = harness.model_kind("moe_window")
CONF = harness.model.load(REPO / "perfbench" / "configs"
                          / "mellum2-12b-edge2.json")
# two periods (6 sliding layers of window 16, 2 yarn layers), 8 experts
# top-4 of width 32, GQA 4 over 2; the init scale keeps the published
# logit scale (std 0.02 at d 2304)
SHRINK = {"layers": 8, "d_model": 64, "heads": 4, "kv_heads": 2,
          "d_expert": 32, "experts": 8, "top_k": 4, "vocab": 97,
          "window": 16, "init_std": 0.02 * (2304 / 64) ** 0.5,
          "dtype": "float32"}


def _small(**over):
    s = KIND.spec(CONF, dict(SHRINK, **over))
    return s, KIND.model_config(CONF, s)


# ---------------------------------------------------------------------------
# configs: the new one, and every reference config as before
# ---------------------------------------------------------------------------


def test_mellum_config_is_the_published_one():
    cfg = get_config("mellum2-12b")
    pat = cfg.layer_pattern()
    assert len(pat) == 28 and all(b.ffn == "moe" for b in pat)
    assert [b.window for b in pat[:4]] == [1024, 1024, 1024, None]
    assert [i for i, b in enumerate(pat) if b.window is None] == \
        list(range(3, 28, 4))
    assert {b.rope.kind for b in pat if b.window} == {"default"}
    yarn = pat[3].rope
    assert (yarn.kind, yarn.theta, yarn.factor, yarn.original_max_position,
            yarn.beta_fast, yarn.beta_slow) == ("yarn", 5e5, 16.0, 8192,
                                                32.0, 1.0)
    assert yarn.attention_factor == pytest.approx(0.1 * math.log(16) + 1)
    assert cfg.moe.capacity_factor is None and cfg.moe.top_k == 8
    assert cfg.param_count() == pytest.approx(12.15e9, rel=1e-3)
    # the benchmark's kind builds the same model from the published file
    s = KIND.spec(CONF)
    assert KIND.model_config(CONF, s).layer_pattern() == pat
    assert KIND.weight_bytes(s) == pytest.approx(2 * 12.15e9, rel=1e-3)
    assert paged_supported(cfg)


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_every_reference_config_builds_as_before(arch):
    """Field for field, blocks, the page pool's choice and the reduced
    variant: the new fields leave every reference config as it was."""
    tcfg, jcfg = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert type(tcfg).__name__ == "ModelConfig"
    for t, j in zip(tcfg.layer_pattern(), jcfg.layer_pattern()):
        assert (t.mixer, t.ffn, t.window, t.use_rope, t.rope) == \
            (j.mixer, j.ffn, j.window, j.use_rope, None)
    assert paged_supported(tcfg) == jax_paged_kv.paged_supported(jcfg)
    assert dataclasses.asdict(reduced(tcfg)) == \
        dataclasses.asdict(jax_reduced(jcfg))


def test_reduced_keeps_a_period_of_layer_kinds():
    cfg = reduced(get_config("mellum2-12b"))
    assert [b.window for b in cfg.layer_pattern()] == [64, 64, 64, None]
    assert cfg.moe.capacity_factor is None


# ---------------------------------------------------------------------------
# yarn
# ---------------------------------------------------------------------------


def _yarn_by_hand(hd, theta, s, L, fast, slow):
    """Hugging Face's ``_compute_yarn_parameters`` written out in float64
    (``truncate`` on)."""
    def corr(r):
        return hd * math.log(L / (r * 2 * math.pi)) / (2 * math.log(theta))
    lo = max(math.floor(corr(fast)), 0)
    hi = min(math.ceil(corr(slow)), hd - 1)
    pos = theta ** (np.arange(0, hd, 2) / hd)
    extra, inter = 1 / pos, 1 / (s * pos)
    ramp = np.clip((np.arange(hd // 2) - lo) / (hi - lo), 0, 1)
    keep = 1 - ramp
    return inter * (1 - keep) + extra * keep


def test_yarn_tables_follow_the_written_formula():
    """The port's and the reference's yarn frequencies against the
    formula in float64 at Mellum2's full-layer RoPE (f32 tables: 1e-6
    relative), the ramp's ends (dims below it keep theta's frequency,
    dims above are divided by 16), and the attention factor scaling cos
    and sin: a yarn rotation is the plain rotation at the same
    frequencies times 1.2773."""
    rope = get_config("mellum2-12b").layer_pattern()[3].rope
    want = _yarn_by_hand(128, 5e5, 16.0, 8192, 32.0, 1.0)
    got = yarn_freqs(128, rope, CPU).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    plain_inv = plain.rope_inv_freq(
        128, CONF["rope_parameters"]["full_attention"], CPU)
    np.testing.assert_allclose(plain_inv.double().numpy(), want, rtol=1e-6)
    base = rope_freqs(128, 5e5, CPU).double().numpy()
    assert got[0] == pytest.approx(base[0])
    assert got[-1] == pytest.approx(base[-1] / 16)
    x = torch.randn((3, 5, 2, 128), generator=torch.Generator()
                    .manual_seed(0))
    pos = torch.arange(5) * 997
    scaled = apply_rope(x, pos, rope=rope)
    unscaled = apply_rope(x, pos, rope=dataclasses.replace(
        rope, attention_factor=1.0))
    torch.testing.assert_close(scaled, unscaled * rope.attention_factor,
                               rtol=1e-6, atol=1e-6)
    default = apply_rope(x, pos, rope=RopeSpec(theta=5e5))
    torch.testing.assert_close(default, apply_rope(x, pos, 5e5), rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="unknown RoPE kind"):
        apply_rope(x, pos, rope=RopeSpec(kind="ntk"))


# ---------------------------------------------------------------------------
# the windowed decode's plain route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [9, 12, 13, 29], ids=["n<W", "n=W", "n=W+1",
                                                     "n=W+17"])
def test_window_decode_plain_route_at_window_edges(n):
    """``ops.paged_flash_decode_window`` on the CPU against dense masked
    attention over each lane's last W = 12 positions, pages of 8 (n = 13
    starts its window mid-page), scrambled tables, f32 (the same sums in
    another order: 1e-5)."""
    g = torch.Generator().manual_seed(n)
    W, ps, H, KV, hd, B = 12, 8, 4, 2, 16, 2
    P = 1 + B * 5
    q = torch.randn((B, H, hd), generator=g)
    k = torch.randn((P, KV, ps, hd), generator=g)
    v = torch.randn((P, KV, ps, hd), generator=g)
    tables = (1 + torch.randperm(P - 1, generator=g)).reshape(B, 5).int()
    lengths = torch.tensor([n, max(n - 3, 1)], dtype=torch.int32)
    got = ops.paged_flash_decode_window(q, k, v, tables, lengths, W)
    for b in range(B):
        pos = torch.arange(int(lengths[b]))
        kb = k[tables[b].long()[pos // ps], :, pos % ps]     # (n, KV, hd)
        vb = v[tables[b].long()[pos // ps], :, pos % ps]
        keep = pos >= int(lengths[b]) - W
        for h in range(H):
            s = (kb[keep, h // (H // KV)] @ q[b, h]) / math.sqrt(hd)
            want = torch.softmax(s, 0) @ vb[keep, h // (H // KV)]
            torch.testing.assert_close(got[b, h], want, rtol=1e-5,
                                       atol=1e-5)
    full = ops.paged_flash_decode(q, k, v, tables, lengths)
    assert torch.equal(got[lengths <= W], full[lengths <= W])
    if n > W:
        assert (got[0] - full[0]).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# dropless experts
# ---------------------------------------------------------------------------


def test_dropless_experts_match_a_per_token_loop_under_a_skewed_router():
    """A router that sends nearly every token to expert 2 (its column
    raised against inputs with a positive mean): the grouped path keeps
    every routed row, equal to each token's top-k experts summed one token
    at a time (f32, 1e-5); the capacity path on the same weights drops
    rows and misses by far more; the counter gets T x K rows."""
    s, cfg = _small()
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32,
                     CPU)
    p["router"][:, 2] += 0.3
    x = torch.randn((2, 24, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)) + 0.5
    counter = torch.zeros(cfg.moe.num_experts, dtype=torch.int64)
    out, _ = moe.apply_moe(dict(p, expert_rows=counter), cfg, x)
    xf = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xf @ p["router"], -1)
    gate, idx = torch.topk(probs, cfg.moe.top_k, -1)
    gate = gate / gate.sum(-1, keepdim=True)
    assert int((idx == 2).any(-1).sum()) == xf.shape[0]
    f = cfg.d_ff
    want = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(cfg.moe.top_k):
            e = int(idx[t, j])
            h = xf[t] @ p["we_gate_up"][e]
            a = torch.nn.functional.silu(h[:f]) * h[f:]
            want[t] += gate[t, j] * (a @ p["we_down"][e])
    torch.testing.assert_close(out.reshape(-1, cfg.d_model), want,
                               rtol=1e-5, atol=1e-5)
    assert int(counter.sum()) == xf.shape[0] * cfg.moe.top_k
    assert int(counter[2]) == xf.shape[0]
    capped = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25))
    loop = {"router": p["router"], "we_down": p["we_down"],
            "we_gate": p["we_gate_up"][..., :f],
            "we_up": p["we_gate_up"][..., f:]}
    dropped, _ = moe.apply_moe(loop, capped, x)
    assert (dropped.reshape(-1, cfg.d_model) - want).abs().max() > 0.1


# ---------------------------------------------------------------------------
# the paged engine against the plain reference
# ---------------------------------------------------------------------------


def _engine_logits(s, cfg, w, prompt, new):
    """The prompt through ``ServeEngine(paged=True)`` (chunks of 32, then
    greedy rounds): the logits of every served token, from the engine's
    own step calls."""
    eng = ServeEngine(cfg, KIND.engine_params(s, w), paged=True, max_len=160,
                      max_lanes=4, page_size=8, prefill_chunk=32,
                      device="cpu")
    seen = []
    pre, dec = eng._paged_prefill, eng._paged_decode

    def prefill(params, batch, states):
        logits, states = pre(params, batch, states)
        seen.append(("prefill", int(batch["start"]), logits))
        return logits, states

    def decode(params, batch, states, gen):
        logits, tok, states = dec(params, batch, states, gen)
        seen.append(("decode", None, logits[0]))
        return logits, tok, states

    eng._paged_prefill, eng._paged_decode = prefill, decode
    out = eng.generate(prompt[None], new)
    toks = np.concatenate([np.asarray(t).reshape(-1) for t in out.tokens])
    n = len(prompt)
    last = [lg for kind, st, lg in seen if kind == "prefill"][-1]
    first = last[0, (n - 1) % 32]
    rows = [first] + [lg for kind, _, lg in seen if kind == "decode"]
    return toks, torch.stack(rows), eng


def test_paged_engine_matches_the_plain_reference():
    """A 90-token prompt (3 chunks of 32, the last padded) and 8 greedy
    tokens through the paged engine, every served position's logits
    against the reference's full forward of prompt and tokens: both
    layer kinds (window 16, yarn) within 2e-4 of the largest logit (f32
    sums in another order).  The reference with the window off by one
    either way, or with yarn's attention factor dropped, misses by 30x
    that."""
    s, cfg = _small()
    w = KIND.make_weights(s, 2**31 + 7, CPU)
    prompt = np.random.default_rng(3).integers(0, s["vocab"], 90)
    toks, got, eng = _engine_logits(s, cfg, w, prompt, 8)
    assert len(toks) == 8 and eng.prefills == 3 and eng.decode_rounds == 7
    seq = np.concatenate([prompt, toks[:-1]])
    want = plain.logits_at(w, s, [seq], [len(prompt) - 1])[0]
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    assert err < 2e-4, err
    assert torch.equal(got.argmax(-1), torch.as_tensor(toks))
    for bad in ({"window": 15}, {"window": 17}):
        off = plain.logits_at(w, dict(s, **bad), [seq], [len(prompt) - 1])[0]
        assert float((off - want).abs().max()) / scale > 30 * 2e-4, bad
    rope = {k: dict(v) for k, v in s["rope"].items()}
    rope["full_attention"]["attention_factor"] = 1.0
    off = plain.logits_at(w, dict(s, rope=rope), [seq], [len(prompt) - 1])[0]
    assert float((off - want).abs().max()) / scale > 30 * 2e-4
    assert int(eng.expert_rows.sum()) > 0


def test_graphed_pieces_equal_the_eager_forward():
    """``PagedPieces.run`` with its segments run eagerly (what the CUDA
    graphs replay on the card): a chunk over the window and a round of
    three lanes, one idle, equal to the eager forward's logits and pools,
    with each layer's kernel given its window."""
    s, cfg = _small()
    params = KIND.engine_params(s, KIND.make_weights(s, 11, CPU))
    L = cfg.num_layers
    g = torch.Generator().manual_seed(5)
    states = init_paged_states(cfg, 32, 8, CPU)
    table = torch.arange(1, 9, dtype=torch.int32)
    for start in (0, 32):
        batch = {"tokens": torch.randint(0, s["vocab"], (1, 32), generator=g,
                                         dtype=torch.int32),
                 "start": start, "block_table": table}
        want_states = [{k: t.clone() for k, t in st.items()}
                       for st in states]
        want = forward(params, cfg, batch, "paged_prefill",
                       states=want_states)["chunk_logits"]
        got = PagedPieces(cfg, "paged_prefill", batch).run(params, states,
                                                           batch)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    tables = torch.stack([table, torch.zeros_like(table),
                          torch.arange(9, 17, dtype=torch.int32)])
    batch = {"tokens": torch.randint(0, s["vocab"], (3, 1), generator=g,
                                     dtype=torch.int32),
             "block_tables": tables,
             "lengths": torch.tensor([64, 0, 5], dtype=torch.int32)}
    want_states = [{k: t.clone() for k, t in st.items()} for st in states]
    want = forward(params, cfg, batch, "paged_decode",
                   states=want_states)["logits"]
    before = dict(ops.launches)
    got = PagedPieces(cfg, "paged_decode", batch).run(params, states, batch)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(states, want_states)
               for k in a)
    assert ops.launches == before          # plain routes on the CPU
    assert len(PagedPieces(cfg, "paged_decode", batch).windows) == L


def test_windowed_layers_refuse_a_pool_cut_over_a_mesh(monkeypatch):
    """A windowed layer's decode merges no partials of a cut pool."""
    s, cfg = _small()
    blk = cfg.layer_pattern()[0]
    monkeypatch.setattr(attention, "paged_decode_query",
                        lambda *a, **k: (torch.zeros(1, 4, 16), (0, 8)))
    with pytest.raises(ValueError, match="windowed layer"):
        attention.paged_decode({}, cfg, blk, torch.zeros(1, 1, 64), {},
                               torch.zeros(1, 2, dtype=torch.int32),
                               torch.ones(1, dtype=torch.int32))


def test_int8_cache_still_refused_by_the_pool():
    cfg = dataclasses.replace(reduced(get_config("mellum2-12b")),
                              kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="int8"):
        init_paged_states(cfg, 4, 8, CPU)


def test_serve_launcher_serves_mellum_from_the_paged_pool(capsys):
    """``launch/serve.py --arch mellum2-12b`` (the reduced config on the
    CPU): both engines paged, every request finished, the windowed and
    full layers' decode through their ops."""
    before = ops.launches.copy()
    st = serve_launcher.main(["--arch", "mellum2-12b", "--edges", "2",
                              "--scheduler", "jsq", "--requests", "4",
                              "--tokens", "4", "--prompt-len", "80",
                              "--rate", "50", "--device", "cpu"])
    assert st["count"] == 4
    assert [(e["paged"], e["layers"]) for e in st["engines"]] == [
        (True, 4), (True, 8)]              # one and two periods
    assert ops.launches == before          # plain routes on the CPU
    assert "[serve] jsq: n=4" in capsys.readouterr().out


def test_init_params_holds_the_fused_expert_stack():
    cfg = reduced(get_config("mellum2-12b"))
    p = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    ffn = p["layers"][0]["ffn"]
    assert set(ffn) == {"router", "we_gate_up", "we_down"}
    assert ffn["we_gate_up"].shape == (4, cfg.d_model, 2 * cfg.d_ff)
    assert ffn["router"].dtype == torch.float32
