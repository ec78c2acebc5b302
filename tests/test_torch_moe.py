"""Port MoE layer against the JAX one: routing, capacity, the FIFO expert
compute and the local path within 1e-5 in f32; the reference's semantic
cases; the expert layouts bit for bit; per-slot routing groups against a
``vmap`` of the reference; and the sharded and weights-stationary paths
on 4 gloo ranks against the reference's local path.  Small widths."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import moe_paths_rank, run_ranks
from repro.configs import MoEConfig as JMoEConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import moe as jmoe
from repro_torch.configs import MoEConfig, get_config, reduced
from repro_torch.models import moe

TOL = 1e-5
RNG = np.random.default_rng(0)


def _cfgs(arch="dbrx-132b", E=4, K=2, cf=2.0, d=64, f=96, **kw):
    """(JAX cfg, port cfg): reduced ``arch`` at width d, d_ff f, E experts
    of which each token takes K."""
    def one(get, red, moe_cls):
        base = red(get(arch))
        return dataclasses.replace(
            base, d_model=d, d_ff=f, head_dim=d // base.num_heads,
            moe=moe_cls(num_experts=E, top_k=K, capacity_factor=cf), **kw)
    return (one(jax_get_config, jax_reduced, JMoEConfig),
            one(get_config, reduced, MoEConfig))


def _params(jcfg, seed=0):
    """The reference's init_moe params as numpy, and the port's copy."""
    p = jmoe.init_moe(jax.random.key(seed), jcfg, jnp.float32)
    p = {k: np.asarray(v) for k, v in p.items()}
    return p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("T", [1, 4, 32])
def test_route_matches_reference(T):
    jcfg, tcfg = _cfgs(E=8, K=2)
    jp, tp = _params(jcfg)
    x = RNG.standard_normal((T, jcfg.d_model)).astype(np.float32)
    jw, jaux = jmoe._route(jnp.asarray(jp["router"]), jcfg, jnp.asarray(x))
    tw, taux = moe._route(tp["router"], tcfg, torch.from_numpy(x))
    _close(tw, jw)
    _close(taux, jaux)
    # each token's weights sum to 1 over exactly K experts
    assert ((tw > 0).sum(-1) == 2).all()
    _close(tw.sum(-1), np.ones(T))


@pytest.mark.parametrize("cf", [1e-6, 1.0, 1.25, 2.0])
@pytest.mark.parametrize("T", [1, 4, 7, 128])
def test_capacity_matches_reference(T, cf):
    jcfg, tcfg = _cfgs(E=8, K=2, cf=cf)
    assert moe._capacity(tcfg, T) == jmoe._capacity(jcfg, T)


@pytest.mark.parametrize("C", [1, 3, 16])
@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "gelu"])
def test_one_expert_matches_reference(C, gated):
    """FIFO capacity: the first C assigned tokens, in order."""
    T, d, f = 16, 32, 48
    x = RNG.standard_normal((T, d)).astype(np.float32)
    w_col = np.where(RNG.random(T) < 0.5,
                     RNG.random(T), 0.0).astype(np.float32)
    wu, wg = (RNG.standard_normal((d, f)).astype(np.float32) / 6
              for _ in range(2))
    wd = RNG.standard_normal((f, d)).astype(np.float32) / 7
    if not gated:
        wg = None
    want = jmoe._one_expert(jnp.asarray(x), jnp.asarray(w_col),
                            jnp.asarray(wu), jnp.asarray(wd),
                            None if wg is None else jnp.asarray(wg), C)
    got = moe._one_expert(torch.from_numpy(x), torch.from_numpy(w_col),
                          torch.from_numpy(wu), torch.from_numpy(wd),
                          None if wg is None else torch.from_numpy(wg), C)
    _close(got, want)
    kept = np.flatnonzero(w_col > 0)[:C]
    assert set(np.flatnonzero(np.abs(got.numpy()).sum(-1))) <= set(kept)


CASES = {"dbrx_e4k2": dict(arch="dbrx-132b", E=4, K=2, cf=2.0),
         "mixtral_e8k2": dict(arch="mixtral-8x22b", E=8, K=2, cf=1.25),
         "e16k4_drops": dict(arch="dbrx-132b", E=16, K=4, cf=1.0),
         "gelu": dict(arch="dbrx-132b", E=4, K=2, cf=1.25, gated_ffn=False)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", [(2, 16), (1, 5), (8, 1)])
def test_apply_moe_local_matches_reference(case, shape):
    jcfg, tcfg = _cfgs(**CASES[case])
    jp, tp = _params(jcfg, seed=1)
    x = RNG.standard_normal(shape + (jcfg.d_model,)).astype(np.float32)
    jout, jaux = jmoe.apply_moe({k: jnp.asarray(v) for k, v in jp.items()},
                                jcfg, jnp.asarray(x))
    tout, taux = moe.apply_moe(tp, tcfg, torch.from_numpy(x))
    assert tout.shape == x.shape and tout.dtype == torch.float32
    _close(tout, jout)
    _close(taux, jaux)


@pytest.mark.parametrize("S", [1, 3])
def test_routing_groups_match_a_vmap_of_the_reference(S):
    """``groups=B``: each row routed with its own capacity, as the
    reference's dense decode round, a ``vmap`` of batch-1 decodes."""
    jcfg, tcfg = _cfgs(E=8, K=2, cf=1.0)
    jp, tp = _params(jcfg, seed=2)
    B = 4
    x = RNG.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jpp = {k: jnp.asarray(v) for k, v in jp.items()}
    jout, jaux = jax.vmap(lambda xb: jmoe.apply_moe(jpp, jcfg, xb[None]))(
        jnp.asarray(x))
    tout, taux = moe.apply_moe(tp, tcfg, torch.from_numpy(x), groups=B)
    _close(tout, np.asarray(jout)[:, 0])
    _close(taux, np.asarray(jaux).mean())
    # one group over all rows drops tokens the per-row groups keep
    one, _ = moe.apply_moe(tp, tcfg, torch.from_numpy(x))
    if S == 1:
        assert not torch.allclose(one, tout)


# ---------------------------------------------------------------------------
# the reference's semantic cases, on the port
# ---------------------------------------------------------------------------


def test_output_shape_and_aux():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    x = torch.from_numpy(RNG.standard_normal((2, 16, 64)).astype(np.float32))
    out, aux = moe.apply_moe(tp, tcfg, x)
    assert out.shape == x.shape
    assert float(aux) > 0        # the load-balance loss is positive


def test_topk_only_active_experts_contribute():
    """Zeroing a never-chosen expert leaves every output unchanged."""
    jcfg, tcfg = _cfgs(E=4, K=1, cf=4.0)
    _, tp = _params(jcfg)
    rng = np.random.default_rng(1)
    unused = []
    while not unused:                  # 8 tokens that leave an expert idle
        x = torch.from_numpy(rng.standard_normal((1, 8, 64)).astype(
            np.float32))
        chosen = set((x[0] @ tp["router"]).argmax(-1).tolist())
        unused = [e for e in range(4) if e not in chosen]
    out1, _ = moe.apply_moe(tp, tcfg, x)
    p2 = {k: v.clone() for k, v in tp.items()}
    for k in ("we_up", "we_down", "we_gate"):
        p2[k][unused[0]] = 0.0
    out2, _ = moe.apply_moe(p2, tcfg, x)
    _close(out2, out1, tol=1e-6)


def test_capacity_drops_tokens():
    """Capacity factor ~0 keeps one token per expert; 2.0 keeps all."""
    jcfg, tcfg = _cfgs(E=4, K=2, cf=1e-6)
    _, tp = _params(jcfg)
    x = torch.from_numpy(RNG.standard_normal((2, 32, 64)).astype(np.float32))
    out, _ = moe.apply_moe(tp, tcfg, x)
    big = dataclasses.replace(
        tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=2.0))
    out_big, _ = moe.apply_moe(tp, big, x)
    assert float((out.abs().sum(-1) == 0).float().mean()) > 0.5
    assert float((out_big.abs().sum(-1) > 0).float().mean()) > 0.9


def test_local_path_refuses_mesh_layouts():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    hoisted = moe.prepare_tree(tp, tcfg, 2)
    with pytest.raises(ValueError, match="ShardingContext"):
        moe.apply_moe(hoisted, tcfg, torch.zeros((1, 2, 64)))


# ---------------------------------------------------------------------------
# expert layouts
# ---------------------------------------------------------------------------

LAYOUTS = {"m8_e4": (8, 4), "m4_e2_fpar2": (4, 2), "m2_e4": (2, 4),
           "m1_e4": (1, 4)}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_layouts_equal_the_reference_bit_for_bit(case):
    M, E = LAYOUTS[case]
    jcfg, tcfg = _cfgs(E=E, d=64, f=96)
    for lead in [(), (3,)]:
        cols = RNG.standard_normal(lead + (E, 64, 96)).astype(np.float32)
        rows = RNG.standard_normal(lead + (E, 96, 64)).astype(np.float32)
        want_c = np.asarray(jmoe.layout_cols(jnp.asarray(cols), jcfg, M))
        want_r = np.asarray(jmoe.layout_rows(jnp.asarray(rows), jcfg, M))
        got_c = moe.layout_cols(torch.from_numpy(cols), tcfg, M)
        got_r = moe.layout_rows(torch.from_numpy(rows), tcfg, M)
        np.testing.assert_array_equal(got_c.numpy(), want_c)
        np.testing.assert_array_equal(got_r.numpy(), want_r)
        np.testing.assert_array_equal(
            moe.layout_cols_inv(got_c, tcfg, M).numpy(),
            np.asarray(jmoe.layout_cols_inv(jnp.asarray(want_c), jcfg, M)))
        np.testing.assert_array_equal(
            moe.layout_rows_inv(got_r, tcfg, M).numpy(),
            np.asarray(jmoe.layout_rows_inv(jnp.asarray(want_r), jcfg, M)))
        np.testing.assert_array_equal(
            moe.layout_cols_inv(got_c, tcfg, M).numpy(), cols)
        np.testing.assert_array_equal(
            moe.layout_rows_inv(got_r, tcfg, M).numpy(), rows)
    # each rank's block, cut from the stack, is its row of the layout
    for j in range(M):
        for w, want, is_rows in ((cols, want_c, False),
                                 (rows, want_r, True)):
            got = moe.expert_block(torch.from_numpy(w[0]), tcfg, M, j,
                                   rows=is_rows)
            np.testing.assert_array_equal(got.numpy(), want[0, j])


def test_prepare_tree_marks_leaves_by_ndim():
    jcfg, tcfg = _cfgs(arch="mixtral-8x22b", E=4)
    _, tp = _params(jcfg)
    tree = {"layers": [{"ffn": tp, "norm2": {"scale": torch.ones(64)}}]}
    out = moe.prepare_tree(tree, tcfg, M=4)
    ffn = out["layers"][0]["ffn"]
    assert ffn["we_up"].ndim == ffn["we_gate"].ndim == 4
    assert ffn["we_down"].shape == (4, 1, 96, 64)
    assert ffn["router"] is tp["router"]
    assert tp["we_up"].ndim == 3             # the input tree is untouched
    back = moe.unprepare_grads(out, tcfg, M=4)["layers"][0]["ffn"]
    for k in ("we_up", "we_down", "we_gate"):
        np.testing.assert_array_equal(back[k].numpy(), tp[k].numpy())


# ---------------------------------------------------------------------------
# the sharded paths on 4 gloo ranks
# ---------------------------------------------------------------------------

MESHES = [(1, 4), (2, 2), (4, 1)]
# (config, x shape): the reference's own multi-device cases, and E = 2 on
# 4 'model' ranks (each expert's FFN split over f_par = 2)
PATH_CASES = {
    "dbrx_e4": (dict(arch="dbrx-132b", E=4, K=2, cf=2.0, d=256), (2, 32)),
    "mixtral_e4": (dict(arch="mixtral-8x22b", E=4, K=2, cf=2.0, d=64),
                   (8, 4)),
    "e2_fpar2": (dict(arch="mixtral-8x22b", E=2, K=1, cf=2.0, d=64),
                 (4, 8)),
}


def test_sharded_and_stationary_paths_match_local_on_4_ranks(tmp_path):
    """``_apply_moe_sharded`` (``moe_stationary_serve=False``) and
    ``_apply_moe_stationary`` on meshes (1, 4), (2, 2) and (4, 1), each rank
    holding only its ``place_params`` slice of the experts: every rank
    returns the reference's local output within 1e-4 (the reference's
    own bound), the same on every rank, through the collectives its path
    issues; the stationary path's aux is the local aux."""
    cases, want = [], {}
    for name, (kw, xshape) in PATH_CASES.items():
        jcfg, tcfg = _cfgs(**kw)
        jp, _ = _params(jcfg, seed=3)
        x = RNG.standard_normal(xshape + (jcfg.d_model,)).astype(np.float32)
        out, aux = jmoe.apply_moe({k: jnp.asarray(v) for k, v in jp.items()},
                                  jcfg, jnp.asarray(x))
        inputs = str(tmp_path / f"{name}.npz")
        np.savez(inputs, x=x, **jp)
        for shape in MESHES:
            for stationary in (False, True):
                key = f"{name}_{shape[0]}x{shape[1]}_{int(stationary)}"
                cases.append((key, tcfg, inputs, shape, stationary))
                want[key] = (np.asarray(out), float(aux), shape, stationary,
                             tcfg)
    run_ranks(moe_paths_rank, 4, tmp_path, cases, str(tmp_path))
    for key, (out, aux, (D, M), stationary, tcfg) in want.items():
        ranks = [np.load(tmp_path / f"{key}.{r}.npz") for r in range(4)]
        r_exp = moe._layout_dims(tcfg, M)[2]
        for got in ranks:
            err = np.abs(got["out"] - out).max()
            assert err < 1e-4, (key, err)
            np.testing.assert_array_equal(got["out"], ranks[0]["out"])
            # the rank's (1, r, d, f_lp) block, not the whole stack
            assert got["block"].shape[:2] == (1, r_exp), key
            # gathers: rows over 'data'; reduces: the output (and, when
            # stationary, 2 pre-activations per expert, and one more
            # axis) plus the aux mean over both axes
            assert int(got["all_gather"]) == 1, key
            want_reduce = 2 * r_exp + 4 if stationary else 3
            assert int(got["all_reduce"]) == want_reduce, key
            if stationary or D == 1:
                assert abs(float(got["aux"]) - aux) < 1e-5, key
