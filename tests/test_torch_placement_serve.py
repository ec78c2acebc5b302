"""Engines on placed weights: on gloo meshes (1, 4), (2, 2) and (4, 1)
every rank of a ``ServeEngine(mesh=...)`` serves the greedy tokens of the
reference's single-device engine and of the port's meshless one, for
paged qwen2-1.5b with its prefix cache (and a 2-head variant cut
mid-head), dense recurrentgemma-9b with a ring "model" cuts (wrapping)
and with one it does not divide, musicgen-large's int8 ring and
codebooks, and xlstm-350m; prefill logits through the mesh agree with the
reference's within 1e-4 (f32); each engine's placement report names the
layout each layer took."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import placement_serve_rank, ranks_running
from _torch_parity import configs, params_pair
from repro.models.transformer import forward as jax_forward
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.serving.engine import ServeEngine

MESHES = [(1, 4), (2, 2), (4, 1)]
TOL = 1e-4
# name: (arch, layers, overrides, engine keywords, prompt shape, new tokens)
CASES = {
    "qwen2_paged": ("qwen2-1.5b", 2, {}, dict(
        max_len=40, kv_slots=2, max_lanes=2, page_size=8, prefill_chunk=8,
        prefix_cache=True), (4, 20), 5),
    "qwen2_h2": ("qwen2-1.5b", 2, dict(num_heads=2, num_kv_heads=1,
                                       head_dim=128), dict(
        max_len=32, kv_slots=2, page_size=8, prefill_chunk=8), (3, 10), 4),
    "rg_cut": ("recurrentgemma-9b", 3, {}, dict(max_len=96, kv_slots=4),
               (4, 40), 26),
    "rg_whole": ("recurrentgemma-9b", 3, {}, dict(max_len=41, kv_slots=4),
                 (4, 20), 8),
    "musicgen_int8": ("musicgen-large", 2, {}, dict(max_len=40, kv_slots=4),
                      (4, 12), 6),
    "xlstm": ("xlstm-350m", 4, {}, dict(max_len=40, kv_slots=4), (4, 12), 6),
}


def _prompts(tcfg, shape, seed):
    rng = np.random.default_rng(seed)
    B, S = shape
    if tcfg.num_codebooks:
        return rng.integers(0, tcfg.vocab_size, (B, tcfg.num_codebooks, S),
                            dtype=np.int32)
    p = rng.integers(0, tcfg.vocab_size, (B, S), dtype=np.int32)
    if S >= 20:         # the third request waits for a lane: a prefix hit
        p[2, :16] = p[0, :16]
    return p


def _case(name, tmp_path, seed=5):
    """The case's configs, params (the port's saved for the ranks) and
    prompts."""
    arch, layers, over, kw, shape, n_new = CASES[name]
    jcfg, tcfg = configs(num_layers=layers, arch=arch, **over)
    jparams, tparams = params_pair(jcfg, tcfg, seed=seed)
    path = str(tmp_path / f"{name}.pt")
    torch.save(tparams, path)
    return jcfg, tcfg, jparams, tparams, path, _prompts(tcfg, shape, seed)


def _reference(name, jcfg, tcfg, jparams, tparams, prompts):
    """The reference engine's greedy tokens (equal to the meshless port
    engine's) and its prefill last logits of the first prompt."""
    _, _, _, kw, _, n_new = CASES[name]
    want = np.stack([np.asarray(t) for t in JServeEngine(
        jcfg, jparams, **kw).generate(jnp.asarray(prompts), n_new).tokens])
    mine = ServeEngine(tcfg, tparams, device="cpu", **kw)
    meshless = np.stack([np.asarray(t) for t in
                         mine.generate(prompts, n_new).tokens])
    np.testing.assert_array_equal(meshless, want)
    logits = np.asarray(jax_forward(
        jparams, jcfg, {"tokens": jnp.asarray(prompts[:1])}, mode="prefill",
        max_len=kw["max_len"])["last_logits"])
    return want, logits


def _report(tmp_path, key, r):
    return json.loads(str(np.load(tmp_path / f"{key}.{r}.npz")["report"]))


def test_mesh_engines_serve_the_reference_tokens(tmp_path):
    """Every case on every mesh: each rank's greedy tokens equal the
    reference's and the meshless port's, no KV is held after, the paged
    engine's prefix cache hits, and the mesh's prefill logits are the
    reference's within 1e-4 of max |logit|."""
    cases, made = [], {}
    for name, (_, _, _, kw, _, n_new) in CASES.items():
        made[name] = _case(name, tmp_path)
        tcfg, path, prompts = made[name][1], made[name][4], made[name][5]
        cases += [(f"{name}_{D}x{M}", tcfg, path, (D, M), prompts, n_new,
                   kw) for D, M in MESHES]
    # the reference's side runs while the ranks serve
    with ranks_running(placement_serve_rank, 4, tmp_path, cases,
                       str(tmp_path), timeout=240.0):
        want = {}
        for name, args in made.items():
            toks, logits = _reference(name, *args[:4], args[5])
            for D, M in MESHES:
                want[f"{name}_{D}x{M}"] = (toks, logits, CASES[name][3])
    for key, (toks, logits, kw) in want.items():
        for r in range(4):
            got = np.load(tmp_path / f"{key}.{r}.npz")
            np.testing.assert_array_equal(got["tokens"], toks,
                                          err_msg=f"{key} rank {r}")
            assert int(got["kv_leak"]) == 0, f"{key} rank {r}"
            if kw.get("prefix_cache"):
                assert int(got["prefix_hits"]) > 0, f"{key} rank {r}"
            scale = max(float(np.abs(logits).max()), 1.0)
            err = float(np.abs(got["logits"].reshape(logits.shape)
                               - logits).max())
            assert err <= TOL * scale, f"{key} rank {r}: logits {err:.2e}"

    # the layouts the layers took
    rep = _report(tmp_path, "qwen2_paged_1x4", 0)
    assert rep["embed"]["embed"] == "model=vocab data=gathered"
    layer = rep["layers.0"]
    assert layer["wq"] == "data=gathered model=tp"      # 4 heads over 4
    assert layer["wk"] == "data=gathered model=gathered"   # 2 KV heads
    assert layer["wo"] == "model=tp data=gathered"
    assert layer["w_up"] == "data=gathered model=tp"
    mid = _report(tmp_path, "qwen2_h2_1x4", 0)["layers.1"]  # 2 over 4
    assert mid["wq"] == mid["wk"] == "data=gathered model=gathered"
    assert mid["wo"] == "model=gathered data=gathered"
    assert _report(tmp_path, "qwen2_h2_2x2", 0)["layers.1"]["wq"] == \
        "data=gathered model=tp"                        # 2 heads over 2
    for mesh, ring in (("1x4", "model=split"), ("2x2", "model=split"),
                       ("4x1", "model=split")):
        rg = _report(tmp_path, f"rg_cut_{mesh}", 0)
        assert rg["layers.2"]["kv_ring"] == ring
        assert "model=gathered" in rg["layers.0"]["w_in"]
        assert "model=gathered" in rg["layers.0"]["w_out"]
    assert _report(tmp_path, "rg_whole_1x4", 0)["layers.2"]["kv_ring"] == \
        "whole"                                          # 41 over 4
    xl = _report(tmp_path, "xlstm_2x2", 3)
    assert "model=gathered" in xl["layers.0"]["w_up"]   # mLSTM
    assert "model=gathered" in xl["layers.3"]["w_z"]    # sLSTM
    assert _report(tmp_path, "musicgen_int8_2x2", 1)["layers.0"][
        "kv_ring"] == "model=split"


@pytest.mark.parametrize("name", ["rg_cut", "musicgen_int8"])
def test_smoke_mesh_engine_runs_the_split_and_merge_passes(name, tmp_path,
                                                           monkeypatch):
    """On the 1 x 1 mesh a dense engine's rings are "cut" over the one
    "model" rank: every decode round of every attention layer runs the
    split pass and the merge pass once each (never the one-call decode),
    and the tokens are the meshless engine's."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_smoke_mesh
    arch, layers, over, kw, shape, n_new = CASES[name]
    jcfg, tcfg = configs(num_layers=layers, arch=arch, **over)
    _, tparams = params_pair(jcfg, tcfg, seed=5)
    prompts = _prompts(tcfg, shape, 5)
    calls = {"flash_decode": 0, "flash_decode_partials": 0,
             "decode_merge": 0}
    for fn in calls:
        real = getattr(ops, fn)

        def counted(*a, _fn=fn, _real=real, **k):
            calls[_fn] += 1
            return _real(*a, **k)

        monkeypatch.setattr(ops, fn, counted)
    want = np.stack([np.asarray(t) for t in ServeEngine(
        tcfg, tparams, device="cpu", **kw).generate(prompts, n_new).tokens])
    assert calls["flash_decode"] > 0 and calls["decode_merge"] == 0
    calls.update(dict.fromkeys(calls, 0))
    eng = ServeEngine(tcfg, tparams, device="cpu", mesh=make_smoke_mesh("cpu"),
                      **kw)
    got = np.stack([np.asarray(t) for t in
                    eng.generate(prompts, n_new).tokens])
    np.testing.assert_array_equal(got, want)
    n_attn = sum(b.mixer == "attn" for b in tcfg.layer_pattern())
    assert calls["flash_decode"] == 0
    assert calls["flash_decode_partials"] == calls["decode_merge"] == \
        n_attn * eng.decode_rounds
