"""Port model against the JAX model: layers, chunked attention, the paged
forward modes from converted parameters, and the parameter converter on
both of the reference's layer layouts.  Reduced qwen2-1.5b in f32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, configs, params_pair
from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models.transformer import forward as _jax_forward
from repro.models.transformer import init_paged_states as jax_paged_states
from repro_torch.configs import get_config
from repro_torch.models import attention, layers
from repro_torch.models.transformer import forward, init_paged_states

TOL = 1e-4
RNG = np.random.default_rng(0)
# (params, cfg, inputs, mode, states): cfg and mode are static
jax_forward = jax.jit(_jax_forward, static_argnums=(1, 3))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_configs_match_the_reference():
    assert (dataclasses.asdict(get_config("qwen2-1.5b"))
            == dataclasses.asdict(jax_get_config("qwen2-1.5b")))
    jcfg, tcfg = configs()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches(dtype):
    x = RNG.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = RNG.standard_normal(64).astype(np.float32)
    want = jax_layers.rmsnorm({"scale": jnp.asarray(scale)},
                              jnp.asarray(x).astype(dtype), 1e-6)
    got = layers.rmsnorm({"scale": torch.from_numpy(scale)},
                         torch.from_numpy(x).to(getattr(torch, dtype)), 1e-6)
    assert str(got.dtype).endswith(dtype)
    _close(got.float(), want.astype(jnp.float32),
           tol=TOL if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("pos_shape", [(7,), (2, 7)], ids=["shared", "batch"])
def test_apply_rope_matches(pos_shape):
    x = RNG.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = RNG.integers(0, 300, pos_shape).astype(np.int32)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    _close(got, want, tol=1e-5)


@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "gelu"])
def test_apply_mlp_matches(gated):
    p = {"w_up": RNG.standard_normal((32, 48)).astype(np.float32) / 6,
         "w_down": RNG.standard_normal((48, 32)).astype(np.float32) / 7}
    if gated:
        p["w_gate"] = RNG.standard_normal((32, 48)).astype(np.float32) / 6
    x = RNG.standard_normal((2, 5, 32)).astype(np.float32)
    want = jax_layers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x))
    got = layers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x))
    _close(got, want, tol=1e-5)


@pytest.mark.parametrize("window", [None, 12])
def test_chunked_causal_attention_matches_with_offset(window):
    q = RNG.standard_normal((1, 16, 4, 16)).astype(np.float32)
    k = RNG.standard_normal((1, 48, 2, 16)).astype(np.float32)
    v = RNG.standard_normal((1, 48, 2, 16)).astype(np.float32)
    kw = dict(window=window, q_offset=24, q_chunk=8, kv_chunk=16)
    want = jax_attention.chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = attention.chunked_causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    _close(got, want, tol=1e-5)


def _drive_paged(jcfg, tcfg, jparams, tparams, decode_steps=3):
    """Prefill two sequences chunk by chunk through both models, then run
    decode rounds over them plus an idle lane; compare every logit and
    the written pages."""
    ps, C, num_pages = 8, 16, 13
    W = 6
    tables = np.asarray([[3, 1, 5, 0, 0, 0], [2, 7, 9, 4, 0, 0]], np.int32)
    prompts = [RNG.integers(0, jcfg.vocab_size, 20, dtype=np.int32),
               RNG.integers(0, jcfg.vocab_size, 27, dtype=np.int32)]
    jst = jax_paged_states(jcfg, num_pages, ps)
    tst = init_paged_states(tcfg, num_pages, ps, CPU)
    last = []
    for s, prompt in enumerate(prompts):
        for c0 in range(0, len(prompt), C):
            chunk = np.zeros((1, C), np.int32)
            part = prompt[c0:c0 + C]
            chunk[0, :len(part)] = part
            jout = jax_forward(jparams, jcfg,
                               {"tokens": jnp.asarray(chunk),
                                "start": jnp.int32(c0),
                                "block_table": jnp.asarray(tables[s])},
                               "paged_prefill", jst)
            jst = jout["states"]
            tout = forward(tparams, tcfg,
                           {"tokens": torch.from_numpy(chunk), "start": c0,
                            "block_table": torch.from_numpy(tables[s])},
                           mode="paged_prefill", states=tst)
            n = len(part)
            _close(tout["chunk_logits"][0, :n],
                   np.asarray(jout["chunk_logits"])[0, :n])
            _close(tout["aux"], jout["aux"], tol=1e-5)
        last.append(int(np.asarray(jout["chunk_logits"])[0, n - 1].argmax()))
    block_tables = np.zeros((3, W), np.int32)
    block_tables[[0, 2]] = tables                  # lane 1 idles (null)
    lengths = np.asarray([len(prompts[0]), 0, len(prompts[1])], np.int32)
    toks = np.asarray([[last[0]], [0], [last[1]]], np.int32)
    for _ in range(decode_steps):
        jout = jax_forward(jparams, jcfg,
                           {"tokens": jnp.asarray(toks),
                            "block_tables": jnp.asarray(block_tables),
                            "lengths": jnp.asarray(lengths)},
                           "paged_decode", jst)
        jst = jout["states"]
        tout = forward(tparams, tcfg,
                       {"tokens": torch.from_numpy(toks),
                        "block_tables": torch.from_numpy(block_tables),
                        "lengths": torch.from_numpy(lengths)},
                       mode="paged_decode", states=tst)
        jl = np.asarray(jout["logits"])
        _close(tout["logits"][[0, 2]], jl[[0, 2]])
        _close(tout["aux"], jout["aux"], tol=1e-5)
        toks = jl.argmax(-1).astype(np.int32)[:, None]
        lengths = lengths + np.asarray([1, 0, 1], np.int32)
    return jst, tst


def test_paged_forward_logits_match_from_converted_params():
    jcfg, tcfg = configs(num_layers=2)
    jparams, tparams = params_pair(jcfg, tcfg, seed=3)
    jst, tst = _drive_paged(jcfg, tcfg, jparams, tparams)
    # every page but the null page holds the same KV in both pools
    for jl, tl in zip(jst["flat"], tst):
        for name in ("k_pages", "v_pages"):
            _close(tl[name][1:], np.asarray(jl[name])[1:])


def test_converter_unstacks_scanned_layers():
    """A scan_layers config with a 2-block pattern and 3 layers gives the
    reference's {"scan": [stacked...], "rem": [layer]} tree: layer
    g * P + j comes from scan[j][g], then the remainder."""
    pattern = (("attn", "dense"), ("attn", "dense"))
    jcfg, tcfg = configs(num_layers=3, scan_layers=True, pattern=pattern)
    jparams, tparams = params_pair(jcfg, tcfg, seed=5)
    scan, rem = jparams["layers"]["scan"], jparams["layers"]["rem"]
    assert len(scan) == 2 and len(rem) == 1 and len(tparams["layers"]) == 3
    expect = [jax.tree_util.tree_map(lambda a: a[0], scan[0]),
              jax.tree_util.tree_map(lambda a: a[0], scan[1]), rem[0]]
    for want, got in zip(expect, tparams["layers"]):
        np.testing.assert_array_equal(
            got["mixer"]["wq"].numpy(), np.asarray(want["mixer"]["wq"]))
        np.testing.assert_array_equal(
            got["ffn"]["w_down"].numpy(), np.asarray(want["ffn"]["w_down"]))
    _drive_paged(jcfg, tcfg, jparams, tparams, decode_steps=2)


def test_converter_reads_bfloat16_bits_exactly():
    jcfg, tcfg = configs(num_layers=1, dtype="bfloat16")
    jparams, tparams = params_pair(jcfg, tcfg, seed=6)
    got = tparams["layers"][0]["mixer"]["wk"]
    want = np.asarray(jparams["layers"]["flat"][0]["mixer"]["wk"])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_apply_head_matches(tied):
    from repro.models.transformer import apply_head as jax_apply_head
    from repro_torch.models.transformer import apply_head
    jcfg, tcfg = configs(num_layers=1, tie_embeddings=tied)
    jparams, tparams = params_pair(jcfg, tcfg, seed=7)
    assert ("head" in tparams) == (not tied)
    x = RNG.standard_normal((2, 3, tcfg.d_model)).astype(np.float32)
    _close(apply_head(tparams, tcfg, torch.from_numpy(x)),
           jax_apply_head(jparams, jcfg, jnp.asarray(x)))


def test_forward_modes_outside_the_slice_raise():
    """Every forward mode and feed-forward is ported: an unknown
    feed-forward and an unknown mode are refused."""
    jcfg, tcfg = configs(num_layers=1)
    _, tparams = params_pair(jcfg, tcfg)
    toks = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    odd = dataclasses.replace(tcfg, pattern=(("attn", "sparse"),))
    for mode in ("train", "prefill"):
        with pytest.raises(ValueError, match="unknown feed-forward"):
            forward(tparams, odd, toks, mode=mode)
    with pytest.raises(ValueError, match="unknown forward mode"):
        forward(tparams, tcfg, toks, mode="generate")


# ---------------------------------------------------------------------------
# MoE stacks: reduced mixtral-8x22b (sliding window) and dbrx-132b
# ---------------------------------------------------------------------------

MOE_ARCHS = ["mixtral-8x22b", "dbrx-132b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_match_the_reference(arch):
    assert (dataclasses.asdict(get_config(arch))
            == dataclasses.asdict(jax_get_config(arch)))
    jcfg, tcfg = configs(arch=arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_train_prefill_decode_match(arch):
    """train and prefill over 2 x 12 tokens (hidden, last logits, aux
    within 1e-5 / 1e-4), then two decode steps: the port's decode rows are
    the reference's batch-1 decodes of each row (its slot pool's vmap),
    aux the mean of theirs."""
    jcfg, tcfg = configs(num_layers=2, arch=arch, d_ff=96)
    jparams, tparams = params_pair(jcfg, tcfg, seed=8)
    toks = RNG.integers(0, jcfg.vocab_size, (2, 12), dtype=np.int32)
    jout = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                       "train", None)
    tout = forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                   mode="train")
    _close(tout["hidden"], jout["hidden"], tol=1e-5)
    _close(tout["aux"], jout["aux"], tol=1e-5)
    assert float(tout["aux"]) > 0
    jpre = _jax_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                        mode="prefill", max_len=20)
    tpre = forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                   mode="prefill", max_len=20)
    _close(tpre["last_logits"], jpre["last_logits"])
    _close(tpre["aux"], jpre["aux"], tol=1e-5)
    rows = [jax.tree_util.tree_map(lambda a, b=b: a[b:b + 1] if a.ndim
                                   else a, jpre["states"]) for b in range(2)]
    tst = tpre["states"]
    nxt = toks[:, -1:]
    for _ in range(2):
        jl, ja = [], []
        for b in range(2):
            o = _jax_forward(jparams, jcfg,
                             {"tokens": jnp.asarray(nxt[b:b + 1])},
                             mode="decode", states=rows[b])
            rows[b] = o["states"]
            jl.append(np.asarray(o["logits"])[0])
            ja.append(float(o["aux"]))
        tdec = forward(tparams, tcfg, {"tokens": torch.from_numpy(nxt)},
                       mode="decode", states=tst)
        tst = tdec["states"]
        _close(tdec["logits"], np.stack(jl))
        _close(tdec["aux"], np.mean(ja), tol=1e-5)
        nxt = np.stack(jl).argmax(-1).astype(np.int32)[:, None]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_paged_forward_logits_match(arch):
    """paged_prefill chunks and paged_decode rounds (an idle lane riding
    along, as in the reference's round) with aux, from converted params.
    Page pools hold unwindowed caches only (in the reference too), so
    mixtral runs here without its sliding window."""
    jcfg, tcfg = configs(num_layers=2, arch=arch, d_ff=96,
                         sliding_window=None)
    jparams, tparams = params_pair(jcfg, tcfg, seed=9)
    _drive_paged(jcfg, tcfg, jparams, tparams, decode_steps=2)


def test_converter_unstacks_scanned_moe_layers():
    """A scan_layers MoE config: the stacked (G, E, d, f) expert leaves
    unstack like any other leaf, and the forward matches the reference's
    scanned one."""
    jcfg, tcfg = configs(num_layers=3, arch="dbrx-132b", scan_layers=True,
                         d_ff=96)
    jparams, tparams = params_pair(jcfg, tcfg, seed=10)
    scan = jparams["layers"]["scan"][0]["ffn"]
    assert scan["we_up"].shape == (3, 4, tcfg.d_model, 96)
    for g, layer in enumerate(tparams["layers"]):
        for k in ("router", "we_up", "we_down", "we_gate"):
            np.testing.assert_array_equal(layer["ffn"][k].numpy(),
                                          np.asarray(scan[k])[g])
    toks = RNG.integers(0, jcfg.vocab_size, (1, 9), dtype=np.int32)
    jout = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                       "train", None)
    tout = forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                   mode="train")
    _close(tout["hidden"], jout["hidden"], tol=1e-5)
    _close(tout["aux"], jout["aux"], tol=1e-5)
