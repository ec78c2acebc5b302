"""Port multimodal dense serving against the JAX package: the vision
path of llava-next-mistral-7b (the projector, patches in front of the
text) and the audio path of musicgen-large (summed codebook embeddings,
one head per codebook, sinusoidal positions, int8 KV caches), from the
layers through the forward modes, the dense engine and the launcher.
Reduced configs, f32, the reference's parameters carried over with
``params_from_jax`` in both layer layouts; patches are the reference's,
injected."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, FakeClock, configs, params_pair, tokens_of
from repro.cluster.request import Request as JRequest
from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models.transformer import apply_head as jax_apply_head
from repro.models.transformer import forward as _jax_forward
from repro.serving import paged_kv as jax_paged_kv
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.cluster import Request
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention, layers
from repro_torch.models.transformer import apply_head, forward
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.paged_kv import paged_supported

TOL = 1e-5
LLAVA, MUSICGEN = "llava-next-mistral-7b", "musicgen-large"
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


def _inputs(cfg, B, S, seed):
    """Token streams (B, S) or (B, K, S), and the reference's patches
    (B, P, vision_dim) for vision configs."""
    shape = (B, cfg.num_codebooks, S) if cfg.num_codebooks else (B, S)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)
    patches = None
    if cfg.vision_patches:
        patches = np.asarray(jax.random.normal(
            jax.random.key(seed), (B, cfg.vision_patches, cfg.vision_dim)))
    return toks, patches


def _batch(toks, patches, lib):
    b = {"tokens": lib(toks)}
    if patches is not None:
        b["patches"] = lib(patches)
    return b


@pytest.mark.parametrize("arch", [LLAVA, MUSICGEN])
def test_configs_match_the_reference(arch):
    """Field for field, published and reduced; the reference's
    ``param_count()`` gives the published sizes."""
    assert (dataclasses.asdict(get_config(arch))
            == dataclasses.asdict(jax_get_config(arch)))
    jcfg, tcfg = configs(arch=arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    billions = {LLAVA: 7.26, MUSICGEN: 2.45}[arch]
    assert round(get_config(arch).param_count() / 1e9, 2) == billions


@pytest.mark.parametrize("arch", [LLAVA, MUSICGEN])
def test_paged_supported_sends_both_archs_to_the_dense_pool(arch):
    """Vision patches and int8 caches keep the dense slot pool, in both
    packages, at published and reduced size."""
    for cfg in (get_config(arch), reduced(get_config(arch))):
        assert not paged_supported(cfg)
        assert not jax_paged_kv.paged_supported(
            jax_get_config(arch) if cfg.name == arch
            else configs(arch=arch)[0])


# ---------------------------------------------------------------------------
# layers: sinusoidal positions, int8 quantisation, the codebook head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pos_shape", [(9,), (3, 1)], ids=["seq", "rows"])
def test_sinusoidal_positions_match(pos_shape):
    pos = np.random.default_rng(1).integers(0, 700, pos_shape, np.int32)
    want = jax_layers.sinusoidal_positions(jnp.asarray(pos), 64)
    got = layers.sinusoidal_positions(_t(pos), 64)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, tol=1e-6)


def test_quantize_kv_equals_the_reference_and_dequantize_is_close():
    """Same int8 values (half-to-even rounding, clip at 127) and scales on
    the same input, a zero row included (scale 1e-8); dequantised within
    1e-6."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 16, 64)).astype(np.float32) * 3
    x[0, 1, 3] = 0.0
    x[1, 2, 5, :4] = [127.0, -63.5, 0.5, 1.5]      # ties at x / scale
    jq, js = jax_attention._quantize_kv(jnp.asarray(x))
    tq, ts = attention._quantize_kv(_t(x))
    assert tq.dtype == torch.int8 and ts.shape == (2, 4, 16, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    want = jax_attention._dequantize_kv(jq, js, jnp.float32)
    got = attention._dequantize_kv(tq, ts, torch.float32)
    _close(got, want, tol=1e-6)


def test_int8_cache_structure_matches():
    """``tests/test_perf_features.py::test_int8_cache_struct``'s shapes:
    int8 rings and f32 (B, KV, W, 1) scales."""
    jcfg, tcfg = configs(arch=MUSICGEN, kv_cache_dtype="int8")
    jblk, tblk = jcfg.layer_pattern()[0], tcfg.layer_pattern()[0]
    jc = jax_attention.init_kv_cache(jcfg, jblk, 2, 32)
    tc = attention.init_kv_cache(tcfg, tblk, 2, 32, CPU)
    assert set(tc) == set(jc) == {"k", "v", "pos", "k_scale", "v_scale"}
    for name in ("k", "v", "k_scale", "v_scale"):
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype).split(".")[-1] == jc[name].dtype.name
    assert tc["k_scale"].shape == (2, tcfg.num_kv_heads, 32, 1)
    assert tc["pos"].shape == (2,)
    with pytest.raises(ValueError, match="int8"):
        attention.init_paged_kv_cache(tcfg, tblk, 4, 8, CPU)


def test_int8_decode_matches_the_reference_decode():
    """One int8 attention layer (musicgen's MHA, no RoPE, window 16):
    prefill a 20-token prompt (longer than the ring), then 20 decode
    steps through the wrap.  Inputs and weights lie on a coarse grid, so
    both packages' K/V projections are exact and quantise to the same
    int8 values; the rings stay equal, the scales within 1e-6 and every
    output within 1e-5.
    (On random weights the projections differ in the last bits, and a
    value at a rounding tie can land one int8 step apart.)"""
    jcfg, tcfg = configs(arch=MUSICGEN, kv_cache_dtype="int8",
                         sliding_window=16)
    jblk, tblk = jcfg.layer_pattern()[0], tcfg.layer_pattern()[0]
    assert tblk.window == 16 and not tblk.use_rope
    rng = np.random.default_rng(4)
    d, hd = tcfg.d_model, tcfg.num_heads * tcfg.head_dim
    p = {name: rng.integers(-2, 3, shape).astype(np.float32) / 8
         for name, shape in (("wq", (d, hd)), ("wk", (d, hd)),
                             ("wv", (d, hd)), ("wo", (hd, d)))}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}

    def grid(*shape):
        return rng.integers(-4, 5, shape).astype(np.float32) / 4

    S, steps = 20, 20
    x = grid(2, S, d)
    jout, jc = jax_attention.prefill(jp, jcfg, jblk, jnp.asarray(x),
                                     jnp.arange(S), max_len=S + steps)
    tout, tc = attention.prefill(tp, tcfg, tblk, _t(x), torch.arange(S),
                                 max_len=S + steps)
    _close(tout, jout)
    decode = jax.jit(jax_attention.decode, static_argnums=(1, 2))
    for _ in range(steps):
        xt = grid(2, 1, d)
        jout, jc = decode(jp, jcfg, jblk, jnp.asarray(xt), jc)
        tout, tc = attention.decode(tp, tcfg, tblk, _t(xt), tc)
        _close(tout, jout)
        for name in ("k", "v"):
            np.testing.assert_array_equal(tc[name].numpy(),
                                          np.asarray(jc[name]))
            # the jitted reference may take amax * (1 / 127): one ulp
            _close(tc[name + "_scale"], jc[name + "_scale"], tol=1e-6)
    assert tc["pos"].tolist() == [S + steps] * 2


def test_codebook_head_matches():
    jcfg, tcfg = configs(num_layers=1, arch=MUSICGEN)
    jparams, tparams = params_pair(jcfg, tcfg, seed=7)
    K = tcfg.num_codebooks
    assert tuple(tparams["embed"]["embed"].shape) == (K, tcfg.vocab_size,
                                                      tcfg.d_model)
    assert tuple(tparams["head"]["head"].shape) == (K, tcfg.d_model,
                                                    tcfg.vocab_size)
    x = np.random.default_rng(7).standard_normal(
        (2, 3, tcfg.d_model)).astype(np.float32)
    got = apply_head(tparams, tcfg, _t(x))
    assert tuple(got.shape) == (2, 3, K, tcfg.vocab_size)
    _close(got, jax_apply_head(jparams, jcfg, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# the forward modes from converted parameters
# ---------------------------------------------------------------------------


def _drive(jcfg, tcfg, jparams, tparams, S=12, steps=3, seed=3):
    """train, prefill and ``steps`` decode steps through both models on
    the same tokens (and the reference's patches); every output within
    ``TOL``, and the dense states after the last step."""
    B = 2
    toks, patches = _inputs(tcfg, B, S + steps, seed)
    jout = jax_forward(jparams, cfg=jcfg, inputs=_batch(toks, patches,
                                                        jnp.asarray),
                       mode="train")
    tout = forward(tparams, tcfg, _batch(toks, patches, _t), mode="train")
    _close(tout["hidden"], jout["hidden"])
    P = tcfg.vision_patches
    assert tout["hidden"].shape[1] == P + S + steps
    max_len = P + S + steps
    pre = toks[..., :S]
    jout = jax_forward(jparams, cfg=jcfg,
                       inputs=_batch(pre, patches, jnp.asarray),
                       mode="prefill", max_len=max_len)
    tout = forward(tparams, tcfg, _batch(pre, patches, _t), mode="prefill",
                   max_len=max_len)
    _close(tout["last_logits"], jout["last_logits"])
    jst, tst = jout["states"], tout["states"]
    assert tst[0]["pos"].tolist() == [P + S] * B
    for j in range(S, S + steps):
        step = toks[..., j:j + 1]
        jout = jax_forward(jparams, cfg=jcfg, inputs={"tokens": step},
                           mode="decode", states=jst)
        tout = forward(tparams, tcfg, {"tokens": _t(step)}, mode="decode",
                       states=tst)
        _close(tout["logits"], jout["logits"])
        jst, tst = jout["states"], tout["states"]
    flat = jst["flat"] if "flat" in jst else None
    return tst, flat


@pytest.mark.parametrize("arch,kv", [(LLAVA, "model"), (MUSICGEN, "model"),
                                     (MUSICGEN, "int8")])
def test_forward_train_prefill_and_decode_match(arch, kv):
    """llava with the reference's patches in front of the prompt;
    musicgen's 4 codebooks with sinusoidal positions, with a model-dtype
    cache and with its published int8 cache (the reference's int8 decode:
    the ring dequantised to f32).  Logits within 1e-5; the int8 rings
    equal the reference's and their scales within 1e-5.  (Random
    weights: a projected K/V value at a rounding tie could quantise one
    step apart, see ``test_int8_decode_matches_the_reference_decode``;
    here none does.)"""
    jcfg, tcfg = configs(arch=arch, kv_cache_dtype=kv)
    jparams, tparams = params_pair(jcfg, tcfg, seed=3)
    tst, jst = _drive(jcfg, tcfg, jparams, tparams)
    for tl, jl in zip(tst, jst):
        assert set(tl) == set(jl)
        for name, leaf in tl.items():
            if name == "pos":
                assert leaf.tolist() == [int(jl["pos"])] * leaf.shape[0]
            elif leaf.dtype == torch.int8:
                np.testing.assert_array_equal(leaf.numpy(),
                                              np.asarray(jl[name]))
            else:
                _close(leaf, jl[name])


@pytest.mark.parametrize("arch", [LLAVA, MUSICGEN])
def test_converter_carries_multimodal_params_in_the_scan_layout(arch):
    """scan_layers with 3 layers (a stacked group of 3): the projector and
    the stacked codebook tables are carried unchanged and the forward
    modes match the reference's scanned model.  Model-dtype caches: this
    holds the layout; the int8 cache has its own tests (at seed 6 three
    of musicgen's ~25k projected K/V values sit at rounding ties and
    quantise one step apart, which moves a decode logit by up to
    6.7e-4)."""
    jcfg, tcfg = configs(num_layers=3, arch=arch, scan_layers=True,
                         kv_cache_dtype="model")
    jparams, tparams = params_pair(jcfg, tcfg, seed=6)
    assert len(jparams["layers"]["scan"]) == 1
    top = {LLAVA: ("projector",), MUSICGEN: ("embed", "head")}[arch]
    for key in top:
        for name, leaf in tparams[key].items():
            np.testing.assert_array_equal(leaf.numpy(),
                                          np.asarray(jparams[key][name]))
    _drive(jcfg, tcfg, jparams, tparams, S=8, steps=2, seed=6)


# ---------------------------------------------------------------------------
# the dense engine and the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [LLAVA, MUSICGEN])
def test_dense_engine_matches_reference(arch):
    """Three requests of different prompt lengths on two slots (one waits
    for a slot, so rows decode at different positions): the same greedy
    tokens as the reference's engine ((1, K) rows for audio), no KV
    leak; ``generate`` gives (B,) or (B, K) tokens a step."""
    jcfg, tcfg = configs(arch=arch)
    jparams, tparams = params_pair(jcfg, tcfg, seed=5)
    P = tcfg.vision_patches
    kw = dict(max_len=P + 20, kv_slots=2)
    je = JServeEngine(jcfg, jparams, clock=FakeClock(), **kw)
    te = ServeEngine(tcfg, tparams, clock=FakeClock(), device=CPU, **kw)
    assert not je.paged and not te.paged
    jreqs, treqs = [], []
    for rid, (n, new) in enumerate([(9, 6), (4, 4), (12, 5)]):
        toks, patches = _inputs(tcfg, 1, n, seed=10 + rid)
        jreqs.append(JRequest(rid=rid, prompt=toks, max_new_tokens=new,
                              patches=(None if patches is None
                                       else jnp.asarray(patches))))
        treqs.append(Request(rid=rid, prompt=toks, max_new_tokens=new,
                             patches=patches))
        je.admit(jreqs[-1])
        te.admit(treqs[-1])
    je.run_to_completion()
    te.run_to_completion()
    for jr, tr in zip(jreqs, treqs):
        assert tr.status == jr.status == "ok"
        np.testing.assert_array_equal(tokens_of(tr), tokens_of(jr))
        assert np.asarray(tr.tokens[0]).shape == (
            (1, tcfg.num_codebooks) if tcfg.num_codebooks else (1,))
    assert te.kv_leak == je.kv_leak == 0 and te.prefills == 3
    toks, patches = _inputs(tcfg, 2, 7, seed=20)
    res = te.generate(toks, 3, patches=patches)
    jres = je.generate(jnp.asarray(toks), 3, patches=(
        None if patches is None else jnp.asarray(patches)))
    assert len(res.tokens) == 3
    for got, want in zip(res.tokens, jres.tokens):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_paged_engine_serves_codebook_tokens_like_the_reference():
    """musicgen with a model-dtype cache is all unwindowed attention, so
    both packages page it: chunked prefill of (1, K, S) prompts, (L, K, 1)
    decode rounds and a shared-prefix hit give the reference's tokens."""
    jcfg, tcfg = configs(arch=MUSICGEN, kv_cache_dtype="model")
    jparams, tparams = params_pair(jcfg, tcfg, seed=9)
    kw = dict(max_len=40, kv_slots=2, page_size=4, prefill_chunk=8)
    je = JServeEngine(jcfg, jparams, clock=FakeClock(), **kw)
    te = ServeEngine(tcfg, tparams, clock=FakeClock(), device=CPU, **kw)
    assert je.paged and te.paged
    shared, _ = _inputs(tcfg, 1, 8, seed=30)
    jreqs, treqs = [], []
    for rid, (n, new) in enumerate([(13, 5), (10, 3), (17, 4)]):
        toks, _ = _inputs(tcfg, 1, n, seed=31 + rid)
        toks[..., :8] = shared
        jreqs.append(JRequest(rid=rid, prompt=toks, max_new_tokens=new))
        treqs.append(Request(rid=rid, prompt=toks, max_new_tokens=new))
        je.admit(jreqs[-1])
        te.admit(treqs[-1])
        if rid == 0:            # its prompt blocks enter the prefix cache
            je.run_to_completion()
            te.run_to_completion()
    je.run_to_completion()
    te.run_to_completion()
    for jr, tr in zip(jreqs, treqs):
        assert tr.status == jr.status == "ok"
        np.testing.assert_array_equal(tokens_of(tr), tokens_of(jr))
    assert te.prefix_hits == je.prefix_hits == 2
    assert te.kv_leak == je.kv_leak == 0


@pytest.mark.parametrize("arch", [LLAVA, MUSICGEN])
def test_serve_main_serves_both_archs_on_cpu(arch, capsys):
    """Dense engines with room for the patches; every request ``ok``, no
    slot held, one prefill a request, no kernel launched on the CPU."""
    st = serve.main(["--arch", arch, "--edges", "2", "--requests", "3",
                     "--tokens", "3", "--prompt-len", "8", "--rate", "200",
                     "--device", "cpu"])
    assert st["completed"] == st["count"] == 3 and st["unfinished"] == 0
    assert [e["kv_leak"] for e in st["engines"]] == [0, 0]
    assert [e["paged"] for e in st["engines"]] == [False, False]
    assert sum(e["prefills"] for e in st["engines"]) == 3
    assert st["launches"] == dict.fromkeys(ops.launches, 0)
    assert capsys.readouterr().out.count("[serve] req ") == 3
