"""Port dense serving path against the JAX one: the RG-LRU block, dense
prefill and ring-buffer decode, the three dense forward modes, the
batched slot-pool decode round against the reference's vmapped one, the
dense engine, a mixed paged + dense fleet in one cluster, the converter
on the stacked layout with RG-LRU leaves, and the launcher.  Reduced
recurrentgemma-9b (window 64), f32, weights carried over with
``params_from_jax``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, FakeClock, configs, params_pair, tokens_of
from repro.cluster import EdgeCluster as JEdgeCluster
from repro.cluster import make_scheduler as jax_make_scheduler
from repro.cluster import poisson_trace as jax_poisson_trace
from repro.cluster.request import Request as JRequest
from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import rglru as jax_rglru
from repro.models.transformer import forward as _jax_forward
from repro.serving import compiled as jax_compiled
from repro.serving.builders import build_fleet as jax_build_fleet
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.cluster import EdgeCluster, Request, make_scheduler
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention, rglru
from repro_torch.models.transformer import forward
from repro_torch.serving import compiled
from repro_torch.serving.builders import build_fleet
from repro_torch.serving.engine import ServeEngine

TOL = 1e-4
ARCH = "recurrentgemma-9b"
jax_forward = jax.jit(_jax_forward,
                      static_argnames=("cfg", "mode", "max_len"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _rg(num_layers=3, **kw):
    return configs(num_layers=num_layers, arch=ARCH, **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_recurrentgemma_configs_match_the_reference():
    assert (dataclasses.asdict(get_config(ARCH))
            == dataclasses.asdict(jax_get_config(ARCH)))
    jcfg, tcfg = _rg()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert [b.mixer for b in tcfg.layer_pattern()] == ["rglru", "rglru",
                                                       "attn"]
    assert tcfg.layer_pattern()[2].window == 64


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [2, 11], ids=["shorter_than_conv", "prompt"])
def test_rglru_scan_and_step_match(S):
    jcfg, tcfg = _rg()
    jp = jax_rglru.init_rglru(jax.random.key(1), jcfg, jnp.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    jout, jst = jax_rglru.rglru_scan(jp, jcfg, jnp.asarray(x))
    tout, tst = rglru.rglru_scan(tp, tcfg, _t(x))
    _close(tout, jout)
    for name in ("h", "conv"):
        _close(tst[name], jst[name])
    assert tst["pos"].tolist() == [S, S] and int(jst["pos"]) == S
    for _ in range(3):
        xt = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        jout, jst = jax_rglru.rglru_step(jp, jcfg, jnp.asarray(xt), jst)
        tout, tst = rglru.rglru_step(tp, tcfg, _t(xt), tst)
        _close(tout, jout)
        for name in ("h", "conv"):
            _close(tst[name], jst[name])
    assert tst["pos"].tolist() == [S + 3] * 2


@pytest.mark.parametrize("S", [1, 11, 128])
def test_rglru_assoc_scan_matches_reference_and_loop(S):
    """``use_assoc_scan=True``: the log-depth prefix scan against the
    reference's ``lax.associative_scan`` and against the port's own time
    loop, outputs and final state within 1e-5; then the model's prefill
    with ``cfg.use_assoc_scan`` against the reference's."""
    jcfg, tcfg = _rg()
    jp = jax_rglru.init_rglru(jax.random.key(2), jcfg, jnp.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    x = np.random.default_rng(S).standard_normal(
        (2, S, tcfg.d_model)).astype(np.float32)
    jout, jst = jax_rglru.rglru_scan(jp, jcfg, jnp.asarray(x),
                                     use_assoc_scan=True)
    tout, tst = rglru.rglru_scan(tp, tcfg, _t(x), use_assoc_scan=True)
    lout, lst = rglru.rglru_scan(tp, tcfg, _t(x))
    for got, want in ((tout, jout), (tout, lout), (tst["h"], jst["h"]),
                      (tst["h"], lst["h"]), (tst["conv"], jst["conv"])):
        _close(got, want, tol=1e-5)
    jcfg, tcfg = _rg(use_assoc_scan=True)
    jparams, tparams = params_pair(jcfg, tcfg, seed=8)
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (1, S),
                                             dtype=np.int32)
    jout = jax_forward(jparams, cfg=jcfg, inputs={"tokens": toks},
                       mode="prefill", max_len=S + 2)
    tout = forward(tparams, tcfg, {"tokens": _t(toks)}, mode="prefill",
                   max_len=S + 2)
    _close(tout["last_logits"], jout["last_logits"], tol=1e-5)


# ---------------------------------------------------------------------------
# dense attention: prefill into a ring and decode past its wrap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,steps", [(40, 30), (80, 5)],
                         ids=["decode_wraps", "prompt_longer_than_window"])
def test_dense_prefill_and_decode_match(S, steps):
    jcfg, tcfg = _rg()
    jblk, tblk = jcfg.layer_pattern()[2], tcfg.layer_pattern()[2]
    assert tblk.window == 64
    jp = jax_attention.init_attention(jax.random.key(2), jcfg, jnp.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    max_len = S + steps
    jout, jc = jax_attention.prefill(jp, jcfg, jblk, jnp.asarray(x),
                                     jnp.arange(S), max_len=max_len)
    tout, tc = attention.prefill(tp, tcfg, tblk, _t(x), torch.arange(S),
                                 max_len=max_len)
    _close(tout, jout)
    assert tc["k"].shape == jc["k"].shape and tc["k"].shape[2] == 64
    for name in ("k", "v"):
        _close(tc[name], jc[name])
    decode = jax.jit(jax_attention.decode, static_argnums=(1, 2))
    for _ in range(steps):
        xt = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        jout, jc = decode(jp, jcfg, jblk, jnp.asarray(xt), jc)
        tout, tc = attention.decode(tp, tcfg, tblk, _t(xt), tc)
        _close(tout, jout)
    for name in ("k", "v"):
        _close(tc[name], jc[name])
    assert tc["pos"].tolist() == [int(jc["pos"])] * 2 == [max_len] * 2


# ---------------------------------------------------------------------------
# the model's dense forward modes
# ---------------------------------------------------------------------------


def _compare_states(tst, jst):
    for tl, jl in zip(tst, jst["flat"]):
        for name, leaf in tl.items():
            if name == "pos":
                assert leaf.tolist() == [int(jl["pos"])] * leaf.shape[0]
            else:
                _close(leaf, jl[name])


def test_forward_train_prefill_and_decode_match():
    """Four layers (RG-LRU, RG-LRU, attention, RG-LRU); a prompt longer
    than the window, then decode steps."""
    jcfg, tcfg = _rg(num_layers=4)
    jparams, tparams = params_pair(jcfg, tcfg, seed=3)
    rng = np.random.default_rng(3)
    S, steps = 70, 3
    toks = rng.integers(0, tcfg.vocab_size, (2, S + steps), dtype=np.int32)
    jout = jax_forward(jparams, cfg=jcfg, inputs={"tokens": toks},
                       mode="train")
    tout = forward(tparams, tcfg, {"tokens": _t(toks)}, mode="train")
    _close(tout["hidden"], jout["hidden"])
    jout = jax_forward(jparams, cfg=jcfg, inputs={"tokens": toks[:, :S]},
                       mode="prefill", max_len=S + steps)
    tout = forward(tparams, tcfg, {"tokens": _t(toks[:, :S])},
                   mode="prefill", max_len=S + steps)
    _close(tout["last_logits"], jout["last_logits"])
    jst, tst = jout["states"], tout["states"]
    _compare_states(tst, jst)
    for j in range(S, S + steps):
        step = {"tokens": toks[:, j:j + 1]}
        jout = jax_forward(jparams, cfg=jcfg, inputs=step, mode="decode",
                           states=jst)
        tout = forward(tparams, tcfg, {"tokens": _t(step["tokens"])},
                       mode="decode", states=tst)
        _close(tout["logits"], jout["logits"])
        jst, tst = jout["states"], tout["states"]
    _compare_states(tst, jst)


# ---------------------------------------------------------------------------
# the slot pool: one batched round against the reference's vmapped one
# ---------------------------------------------------------------------------


def test_pool_decode_step_matches_the_vmapped_reference():
    """Three slots at different positions (prompts of 5, 17 and 30
    tokens) decode four rounds; every token and the final states match
    the reference's vmap over batch-1 decodes."""
    jcfg, tcfg = _rg(num_layers=4)
    jparams, tparams = params_pair(jcfg, tcfg, seed=4)
    slots, max_len = 3, 40
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tcfg.vocab_size, (1, n), dtype=np.int32)
               for n in (5, 17, 30)]
    jpre, tpre = (jax_compiled.prefill_step(jcfg, max_len),
                  compiled.prefill_step(tcfg, max_len))
    jins, tins = jax_compiled.pool_insert(), compiled.pool_insert()
    jpool = tpool = None
    toks = []
    for i, p in enumerate(prompts):
        jl, jst = jpre(jparams, {"tokens": jnp.asarray(p)})
        tl, tst = tpre(tparams, {"tokens": _t(p)})
        _close(tl, jl)
        if jpool is None:
            jpool = jax.tree_util.tree_map(
                lambda a: jnp.zeros((slots,) + a.shape, a.dtype), jst)
            from repro_torch.models.transformer import init_layer_states
            tpool = init_layer_states(tcfg, slots, max_len, CPU)
        jpool = jins(jpool, jst, jnp.int32(i))
        tpool = tins(tpool, tst, i)
        toks.append(int(np.argmax(np.asarray(jl))))
    jdec = jax_compiled.pool_decode_step(jcfg, slots, False, 1.0)
    tdec = compiled.pool_decode_step(tcfg, slots, False, 1.0)
    keys = jax.random.split(jax.random.key(0), slots)
    tok = np.asarray(toks, np.int32)[:, None]
    for _ in range(4):
        jtok, jpool = jdec(jparams, jnp.asarray(tok)[..., None], jpool, keys)
        ttok, tpool = tdec(tparams, _t(tok), tpool)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok)[:, 0])
        tok = ttok.numpy()[:, None]
    assert tpool[0]["pos"].tolist() == [9, 21, 34]
    for tl, jl in zip(tpool, jpool["flat"]):
        for name, leaf in tl.items():
            want = np.asarray(jl[name])
            if name != "pos":
                want = want[:, 0]            # the vmapped batch-1 axis
            _close(leaf, want)


# ---------------------------------------------------------------------------
# the dense engine and a mixed fleet
# ---------------------------------------------------------------------------


def test_dense_engine_matches_reference():
    """Three requests on two slots (one waits for a slot), one prompt
    longer than the window; same greedy tokens as the reference's
    ``ServeEngine(paged=False)``, no KV leak."""
    jcfg, tcfg = _rg(num_layers=4)
    jparams, tparams = params_pair(jcfg, tcfg, seed=5)
    kw = dict(max_len=80, kv_slots=2)
    je = JServeEngine(jcfg, jparams, paged=False, clock=FakeClock(), **kw)
    te = ServeEngine(tcfg, tparams, clock=FakeClock(), device=CPU, **kw)
    assert not te.paged and not te.capability.paged
    rng = np.random.default_rng(5)
    reqs = [(0, 70, 6), (1, 12, 4), (2, 30, 5)]
    jreqs, treqs = [], []
    for rid, n, new in reqs:
        p = rng.integers(0, tcfg.vocab_size, (1, n), dtype=np.int32)
        jreqs.append(JRequest(rid=rid, prompt=p, max_new_tokens=new))
        treqs.append(Request(rid=rid, prompt=p, max_new_tokens=new))
        je.admit(jreqs[-1])
        te.admit(treqs[-1])
    je.run_to_completion()
    te.run_to_completion()
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tokens_of(tr), tokens_of(jr))
        assert tr.status == jr.status == "ok"
    assert te.kv_leak == je.kv_leak == 0
    assert te.peak_inflight == je.peak_inflight == 2
    assert te.prefills == 3 and te.decode_rounds > 0
    te.reset()
    assert te.prefills == 0 and te.decode_rounds == 0 and te.kv_leak == 0


def test_build_fleet_serves_one_trace_through_edge_cluster():
    """A paged qwen2 engine beside a dense recurrentgemma engine in one
    cluster, in lockstep with the reference's fleet on the same weights:
    the same placements and tokens, no KV leak."""
    kw = dict(kv_slots=2, page_size=8, prefill_chunk=8)
    archs = ["qwen2-1.5b", ARCH]
    jeng = jax_build_fleet(archs, 40, **kw)
    teng = build_fleet(archs, 40, device=CPU, **kw)
    assert [e.paged for e in teng] == [True, False] == [e.paged
                                                       for e in jeng]
    for je, te in zip(jeng, teng):
        assert dataclasses.asdict(te.cfg) == dataclasses.asdict(je.cfg)
        assert te.arch_id == je.arch_id
        te.params = params_from_jax(_np(je.params), te.cfg, CPU)
    jc = JEdgeCluster(jeng, jax_make_scheduler("round-robin", 2), seed=1,
                      clock=FakeClock())
    tc = EdgeCluster(teng, make_scheduler("round-robin", 2), seed=1,
                     clock=FakeClock())
    trace = jax_poisson_trace(4, rate=10.0, prompt_len=16, max_new_tokens=5,
                              vocab_size=512, num_origins=2, seed=3)
    treqs = [Request(rid=r.rid, prompt=np.asarray(r.prompt),
                     max_new_tokens=r.max_new_tokens, arrival_s=r.arrival_s,
                     origin=r.origin) for r in trace]
    placements = [(jc.submit(jr), tc.submit(tr))
                  for jr, tr in zip(trace, treqs)]
    while jc.busy or tc.busy:
        jc.step()
        tc.step()
    assert all(a == b for a, b in placements)
    assert {a for a, _ in placements} == {0, 1}
    for jr, tr in zip(trace, treqs):
        assert tr.status == jr.status == "ok"
        np.testing.assert_array_equal(tokens_of(tr), tokens_of(jr))
    assert [e.kv_leak for e in teng] == [0, 0]


# ---------------------------------------------------------------------------
# converter and launcher
# ---------------------------------------------------------------------------


def test_converter_carries_rglru_blocks_in_the_scan_layout():
    """scan_layers with the 3-block pattern and 5 layers: one stacked
    group plus 2 remaining layers, RG-LRU leaves (f32 gates) included;
    the port's prefill over the converted flat list matches the
    reference's scanned one."""
    jcfg, tcfg = _rg(num_layers=5, scan_layers=True)
    jparams, tparams = params_pair(jcfg, tcfg, seed=6)
    scan, rem = jparams["layers"]["scan"], jparams["layers"]["rem"]
    assert len(scan) == 3 and len(rem) == 2 and len(tparams["layers"]) == 5
    np.testing.assert_array_equal(tparams["layers"][0]["mixer"]["gate_a"],
                                  np.asarray(scan[0]["mixer"]["gate_a"])[0])
    np.testing.assert_array_equal(tparams["layers"][2]["mixer"]["wq"],
                                  np.asarray(scan[2]["mixer"]["wq"])[0])
    np.testing.assert_array_equal(tparams["layers"][4]["mixer"]["lam"],
                                  np.asarray(rem[1]["mixer"]["lam"]))
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size, (1, 20),
                                             dtype=np.int32)
    jout = jax_forward(jparams, cfg=jcfg, inputs={"tokens": toks},
                       mode="prefill", max_len=24)
    tout = forward(tparams, tcfg, {"tokens": _t(toks)}, mode="prefill",
                   max_len=24)
    _close(tout["last_logits"], jout["last_logits"])


def test_serve_main_serves_recurrentgemma_on_dense_engines(capsys):
    st = serve.main(["--arch", ARCH, "--edges", "2", "--requests", "4",
                     "--tokens", "4", "--prompt-len", "12", "--rate",
                     "200", "--device", "cpu"])
    assert st["completed"] == st["count"] == 4 and st["unfinished"] == 0
    assert [e["kv_leak"] for e in st["engines"]] == [0, 0]
    assert [e["paged"] for e in st["engines"]] == [False, False]
    assert sum(e["prefills"] for e in st["engines"]) == 4
    assert st["launches"] == dict.fromkeys(ops.launches, 0)  # plain on CPU
    assert capsys.readouterr().out.count("[serve] req ") == 4


def test_pool_insert_refuses_a_state_that_does_not_fit_its_slot():
    """An unwindowed cache longer than the pool's rings (a prompt past
    max_len) is refused rather than cut."""
    _, tcfg = configs(num_layers=1)                  # qwen2: no window
    from repro_torch.models.transformer import init_layer_states
    pool = init_layer_states(tcfg, 2, 8, CPU)
    long = init_layer_states(tcfg, 1, 12, CPU)
    with pytest.raises(ValueError, match="max_len"):
        compiled.pool_insert()(pool, long, 0)


def test_build_fleet_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_fleet(["qwen2-1.5b", ARCH], 32)
