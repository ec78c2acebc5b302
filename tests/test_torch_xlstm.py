"""Port xLSTM path against the JAX one: the mLSTM and sLSTM cells (scan
and step), the reduced xlstm-350m forward in its three dense modes from
params carried over in both layer layouts, the dense slot-pool engine,
and greedy decode against teacher forcing for xlstm-350m and the three
all-attention configs that join with it (starcoder2-3b, starcoder2-7b,
minitron-8b).  Reduced configs, f32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, FakeClock, configs, params_pair, tokens_of
from repro.cluster.request import Request as JRequest
from repro.configs import get_config as jax_get_config
from repro.models import xlstm as jax_xlstm
from repro.models.transformer import forward as _jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.cluster import Request
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import xlstm
from repro_torch.models.transformer import apply_head, forward
from repro_torch.serving.engine import ServeEngine

CELL_TOL = 1e-5
TOL = 1e-4
ARCH = "xlstm-350m"
NEW_ARCHS = ("starcoder2-3b", "starcoder2-7b", "minitron-8b", ARCH)
jax_forward = jax.jit(_jax_forward,
                      static_argnames=("cfg", "mode", "max_len"))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small eager ops on the CPU: one intra-op thread each, so parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_match_the_reference(arch):
    """Field for field, published and reduced; the three attention
    configs serve unwindowed with a non-gated (tanh GELU) MLP, so they
    take the paged path, and long_context_window opens no window."""
    from repro_torch.configs import reduced
    from repro_torch.serving.paged_kv import paged_supported
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jred, tred = configs(num_layers=4, arch=arch)
    assert dataclasses.asdict(tred) == dataclasses.asdict(jred)
    blocks = tcfg.layer_pattern()
    if arch == ARCH:
        assert [b.mixer for b in blocks[:4]] == ["mlstm"] * 3 + ["slstm"]
        assert {b.ffn for b in blocks} == {"none"}
        assert not paged_supported(tcfg)
    else:
        assert all(b.window is None for b in blocks)
        assert not tcfg.gated_ffn and paged_supported(tcfg)
        assert paged_supported(reduced(tcfg))


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------


def _cell_params(kind, cfg, seed):
    init = jax_xlstm.init_mlstm if kind == "mlstm" else jax_xlstm.init_slstm
    jp = init(jax.random.key(seed), cfg, jnp.float32)
    return jp, {k: _t(v) for k, v in jp.items()}


def _random_state(kind, cfg, B, rng):
    """A non-trivial state: what a prompt would leave, drawn at random."""
    if kind == "mlstm":
        H, hd = cfg.num_heads, cfg.head_dim
        shapes = {"C": (B, H, hd, hd), "n": (B, H, hd), "m": (B, H)}
    else:
        shapes = dict.fromkeys("cnhm", (B, cfg.d_model))
    st = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    if kind == "slstm":
        st["n"] = np.abs(st["n"]) + 0.5
    return st


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("S", [1, 13])
def test_cell_scan_matches(kind, S):
    _, cfg = configs(arch=ARCH)
    jp, tp = _cell_params(kind, cfg, seed=S)
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    jscan = getattr(jax_xlstm, f"{kind}_scan")
    tscan = getattr(xlstm, f"{kind}_scan")
    jout, jst = jscan(jp, cfg, jnp.asarray(x))
    tout, tst = tscan(tp, cfg, _t(x))
    _close(tout, jout, CELL_TOL)
    assert set(tst) == set(jst)
    for name, leaf in tst.items():
        if name == "pos":
            assert leaf.tolist() == [int(jst["pos"])] * 2 == [S] * 2
        else:
            _close(leaf, jst[name], CELL_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cell_step_matches(kind):
    """Five decode steps from a random state, each row at its own
    position."""
    _, cfg = configs(arch=ARCH)
    jp, tp = _cell_params(kind, cfg, seed=7)
    rng = np.random.default_rng(7)
    st = _random_state(kind, cfg, 2, rng)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    jst["pos"] = jnp.int32(4)
    tst = {k: _t(v) for k, v in st.items()}
    tst["pos"] = torch.tensor([4, 9], dtype=torch.int32)
    jstep = jax.jit(getattr(jax_xlstm, f"{kind}_step"), static_argnums=1)
    tstep = getattr(xlstm, f"{kind}_step")
    for _ in range(5):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jout, jst = jstep(jp, cfg, jnp.asarray(x), jst)
        tout, tst = tstep(tp, cfg, _t(x), tst)
        _close(tout, jout, CELL_TOL)
        for name in tst:
            if name != "pos":
                _close(tst[name], jst[name], CELL_TOL)
    assert tst["pos"].tolist() == [9, 14] and int(jst["pos"]) == 9


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_converter_gives_the_same_params_from_both_layouts():
    """Five layers of the 4-block pattern: the stacked layout (one group
    plus one remaining layer) and the flat one carry over to the same
    flat list, and no block has norm2 or ffn."""
    jflat, tcfg = configs(num_layers=5, arch=ARCH)
    jscan = dataclasses.replace(jflat, scan_layers=True)
    trees = [jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.key(3), c))
        for c in (jflat, jscan)]
    assert len(trees[1]["layers"]["scan"]) == 4
    assert len(trees[1]["layers"]["rem"]) == 1
    flat, scan = (params_from_jax(t, tcfg, CPU) for t in trees)
    assert len(flat["layers"]) == len(scan["layers"]) == 5
    for a, b in zip(flat["layers"], scan["layers"]):
        assert set(a) == set(b) == {"norm1", "mixer"}
        assert set(a["mixer"]) == set(b["mixer"])
        for k in a["mixer"]:
            assert torch.equal(a["mixer"][k], b["mixer"][k])
    assert set(flat["layers"][3]["mixer"]) >= {"w_i", "r_o", "w_out"}


def _states_match(tst, jst):
    for tl, jl in zip(tst, jst["flat"]):
        assert set(tl) == set(jl)
        for name, leaf in tl.items():
            if name == "pos":
                assert leaf.tolist() == [int(jl["pos"])] * leaf.shape[0]
            else:
                _close(leaf, jl[name])


@pytest.mark.parametrize("scan", [False, True], ids=["flat", "scan"])
def test_forward_train_prefill_and_decode_match(scan):
    """Five layers (three mLSTM, one sLSTM, one mLSTM): train-mode hidden
    states, prefill logits and states, then three decode steps."""
    jcfg, tcfg = configs(num_layers=5, arch=ARCH, scan_layers=scan)
    jparams, tparams = params_pair(jcfg, tcfg, seed=4)
    rng = np.random.default_rng(4)
    S, steps = 11, 3
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
    if not scan:
        _states_match(tst, jst)
    for j in range(S, S + steps):
        step = {"tokens": toks[:, j:j + 1]}
        jout = jax_forward(jparams, cfg=jcfg, inputs=step, mode="decode",
                           states=jst)
        tout = forward(tparams, tcfg, {"tokens": _t(step["tokens"])},
                       mode="decode", states=tst)
        _close(tout["logits"], jout["logits"])
        jst, tst = jout["states"], tout["states"]
    if not scan:
        _states_match(tst, jst)


def test_dense_engine_matches_reference():
    """Three xlstm-350m requests on two slots (one waits for a slot):
    the same greedy tokens as the reference's dense engine, the mLSTM
    matrix memories carried through the slot pool, no slot held after."""
    jcfg, tcfg = configs(num_layers=4, arch=ARCH)
    jparams, tparams = params_pair(jcfg, tcfg, seed=5)
    kw = dict(max_len=40, kv_slots=2)
    je = JServeEngine(jcfg, jparams, clock=FakeClock(), **kw)
    te = ServeEngine(tcfg, tparams, clock=FakeClock(), device=CPU, **kw)
    assert not te.paged and not je.paged
    rng = np.random.default_rng(5)
    jreqs, treqs = [], []
    for rid, n, new in [(0, 20, 6), (1, 7, 4), (2, 12, 5)]:
        p = rng.integers(0, tcfg.vocab_size, (1, n), dtype=np.int32)
        jreqs.append(JRequest(rid=rid, prompt=p, max_new_tokens=new))
        treqs.append(Request(rid=rid, prompt=p, max_new_tokens=new))
        je.admit(jreqs[-1])
        te.admit(treqs[-1])
    je.run_to_completion()
    te.run_to_completion()
    for jr, tr in zip(jreqs, treqs):
        assert tr.status == jr.status == "ok"
        np.testing.assert_array_equal(tokens_of(tr), tokens_of(jr))
    assert te.kv_leak == je.kv_leak == 0
    assert te.expected_prefix_tokens(treqs[0]) == 0
    assert te.prefix_evictions == 0


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_greedy_decode_equals_teacher_forcing(arch):
    """The port's engine (paged for the attention configs, dense slots for
    xLSTM) decodes 6 greedy tokens; the train-mode forward over prompt +
    tokens picks the same token everywhere, and the port's last decode
    logits equal the reference's full prefill over the same tokens."""
    jcfg, tcfg = configs(num_layers=2, arch=arch)
    jparams, tparams = params_pair(jcfg, tcfg, seed=6)
    eng = ServeEngine(tcfg, tparams, max_len=32, page_size=8,
                      prefill_chunk=8, device=CPU, clock=FakeClock())
    assert eng.paged == (arch != ARCH)
    prompt = np.random.default_rng(6).integers(0, tcfg.vocab_size, (1, 13),
                                               dtype=np.int32)
    n_new = 6
    toks = np.concatenate(eng.generate(prompt, n_new).tokens)
    assert eng.kv_leak == 0
    seq = np.concatenate([prompt[0], toks[:-1]]).astype(np.int32)[None]
    hidden = forward(tparams, tcfg, {"tokens": _t(seq)},
                     mode="train")["hidden"]
    logits = apply_head(tparams, tcfg, hidden[:, prompt.shape[1] - 1:])[0]
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), toks)
    # the decode path against the reference's prefill over the same tokens
    st = forward(tparams, tcfg, {"tokens": _t(seq[:, :-1])}, mode="prefill",
                 max_len=32)["states"]
    dec = forward(tparams, tcfg, {"tokens": _t(seq[:, -1:])}, mode="decode",
                  states=st)["logits"]
    want = jax_forward(jparams, cfg=jcfg, inputs={"tokens": seq},
                       mode="prefill", max_len=32)["last_logits"]
    _close(dec, want)
