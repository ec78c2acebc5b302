"""MoE training on a mesh of gloo ranks: the gradients through the
sharded and weights-stationary paths (experts, router and layer input)
equal the local path's within 1e-4 on meshes (1, 2), (2, 1), (2, 2),
(4, 1) and (1, 4), with each rank holding its placed expert block or the
whole stacks (the sharded path over D data ranks against the local path
with D routing groups: there, as in the reference, each rank's rows are
routed, capped and balanced alone); one train step on a mesh with
``hoist_moe_layout`` gives the local step's gradients and new params; on
(2, 1) the replicated weights' gradients equal the single-rank step's.
The local path's gradients are held to ``jax.grad`` of the reference's
first.  A dense model's data-parallel step on placed params (tensor
parallel on "model", FSDP on "data", the batch split over "data") gives
the single-rank step's gradients and AdamW update, and its checkpoint
restores on another mesh and without one."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import (checkpoint_rank, moe_grads_rank, run_ranks,
                         train_step_rank)
from _torch_train import OPT, one_thread, train_case
from repro.configs import MoEConfig as JMoEConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import moe as jmoe
from repro_torch.configs import MoEConfig, get_config, reduced
from repro_torch.core.optim import tree_leaves
from repro_torch.models import moe
from repro_torch.train import optimizer as opt
from repro_torch.train.steps import make_grad_step, make_train_step

_one_thread = pytest.fixture(autouse=True)(one_thread)

TOL = 1e-4
RNG = np.random.default_rng(4)
# (E, K, d, x shape): four experts, and two (each expert's FFN split over
# f_par = 2 on the (1, 4) mesh).  K = 2 of 2 rather than 1: with one
# expert a token the renormalised gate is identically 1, and the router's
# gradient through it is rounding noise in both packages
LAYERS = {"e4": (4, 2, 64, (8, 4)), "e2": (2, 2, 64, (4, 8))}


def _cfgs(E, K, d):
    def one(get, red, moe_cls):
        base = red(get("mixtral-8x22b"))
        return dataclasses.replace(
            base, d_model=d, d_ff=96, head_dim=d // base.num_heads,
            moe=moe_cls(num_experts=E, top_k=K, capacity_factor=2.0))
    return (one(jax_get_config, jax_reduced, JMoEConfig),
            one(get_config, reduced, MoEConfig))


def _local(tcfg, jp, x, w, c, groups):
    """The local path's output and gradients with ``groups`` routing
    groups of T / groups rows (the sharded path over that many data
    ranks routes, caps and balances each rank's rows on their own)."""
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe.apply_moe(tp, tcfg, tx, groups=groups)
    ((out * torch.from_numpy(w)).sum() + float(c) * aux).backward()
    grads = {k: v.grad.numpy() for k, v in tp.items()}
    grads["x"] = tx.grad.numpy()
    return out.detach().numpy(), grads


def _layer_case(name, tmp_path):
    """The inputs file of a layer case and, for 1, 2 and 4 routing
    groups, the local path's output and gradients (one group held to the
    reference's ``jax.grad``)."""
    E, K, d, xshape = LAYERS[name]
    jcfg, tcfg = _cfgs(E, K, d)
    jp = {k: np.asarray(v) for k, v in
          jmoe.init_moe(jax.random.key(3), jcfg, jnp.float32).items()}
    x = RNG.standard_normal(xshape + (d,)).astype(np.float32)
    w = RNG.standard_normal(xshape + (d,)).astype(np.float32)
    c = np.float32(3.0)

    def jloss(p, xx):
        out, aux = jmoe.apply_moe(p, jcfg, xx)
        return (out * w).sum() + c * aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x))
    local = {g: _local(tcfg, jp, x, w, c, g) for g in (1, 2, 4)}
    for k, v in {**jg_p, "x": jg_x}.items():
        _close(local[1][1][k], np.asarray(v), f"local {k} vs the reference")
    path = str(tmp_path / f"{name}.npz")
    np.savez(path, x=x, w=w, c=c, **jp)
    return tcfg, path, local


def _close(got, want, what, tol=TOL):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x " \
                               f"{scale:.3e}"


def _layer_cases(shapes, tmp_path):
    cases, want = [], {}
    for name in LAYERS:
        tcfg, path, local = _layer_case(name, tmp_path)
        for shape in shapes:
            for stationary in (False, True):
                # the stationary path routes every row together
                out, grads = local[1 if stationary else shape[0]]
                for placed in (True, False):
                    key = (f"{name}_{shape[0]}x{shape[1]}_"
                           f"{'stat' if stationary else 'shard'}_"
                           f"{'placed' if placed else 'whole'}")
                    cases.append((key, tcfg, path, shape, stationary, placed))
                    want[key] = (tcfg, shape, placed, grads, out)
    return cases, want


def _check_layer(key, want, tmp_path, world):
    tcfg, (D, M), placed, grads, out = want
    for r in range(world):
        got = np.load(tmp_path / f"{key}.{r}.npz")
        j = r % M                         # row-major (data, model) grid
        _close(got["out"], out, f"{key} rank {r} out")
        _close(got["x"], grads["x"], f"{key} rank {r} dx")
        _close(got["router"], grads["router"], f"{key} rank {r} router")
        for k in ("we_up", "we_down", "we_gate"):
            full = torch.from_numpy(grads[k])
            if placed:
                want_k = moe.expert_block(full, tcfg, M, j,
                                          rows=k == "we_down").numpy()
                got_k = got[k][0]
            else:
                want_k, got_k = grads[k], got[k]
            _close(got_k, want_k, f"{key} rank {r} {k}")
        assert int(got["all_reduce"]) > 0 and int(got["all_gather"]) > 0


def _step_case(name, tmp_path, data_ranks=1):
    """A reduced 2-layer mixtral (4 experts), its params and batch saved
    for the ranks, and the local step's gradients and new params.  Over
    several data ranks each rank's rows are routed and balanced on their
    own; with capacity for every token (factor E / K) and no balance term
    that is the whole batch's function, so the local step is the oracle."""
    kw = {}
    if data_ranks > 1:
        kw["moe"] = MoEConfig(num_experts=4, top_k=2, capacity_factor=2.0,
                              router_aux_weight=0.0)
    _, tcfg, _, tp, _, tb = train_case("mixtral-8x22b", batch=2, **kw)
    params_file, batch_file = (str(tmp_path / f"{name}.{k}.pt")
                               for k in ("params", "batch"))
    torch.save(tp, params_file)
    torch.save(tb, batch_file)
    grads, _ = make_grad_step(tcfg)(tp, tb)
    new, _, _ = make_train_step(tcfg, opt.AdamWConfig(**OPT))(
        tp, opt.init(tp), tb)
    return tcfg, params_file, batch_file, tree_leaves(grads), \
        tree_leaves(new)


def _check_step(key, world, tmp_path, grads, new):
    for r in range(world):
        got = np.load(tmp_path / f"{key}.{r}.npz")
        for i, g in enumerate(grads):
            _close(got[f"g{i}"], g.numpy(), f"{key} rank {r} grad {i}")
        for i, p in enumerate(new):
            _close(got[f"p{i}"], p.numpy(), f"{key} rank {r} param {i}")


def test_mesh_gradients_on_2_ranks(tmp_path):
    """(1, 2) and (2, 1): the layer's gradients on every rank, the hoisted
    train step on (1, 2), and on (2, 1) the whole step's gradients (every
    weight but the experts is replicated there) and new params."""
    cases, want = _layer_cases([(1, 2), (2, 1)], tmp_path)
    hoist = _step_case("hoist", tmp_path)
    flat = _step_case("dp", tmp_path, data_ranks=2)
    steps = [("step_1x2_hoist", dataclasses.replace(
        hoist[0], hoist_moe_layout=True), *hoist[1:3], (1, 2), OPT),
        ("step_2x1", *flat[:3], (2, 1), OPT)]
    run_ranks(_both, 2, tmp_path, cases, steps, str(tmp_path))
    for key, w in want.items():
        _check_layer(key, w, tmp_path, 2)
    _check_step("step_1x2_hoist", 2, tmp_path, *hoist[3:])
    _check_step("step_2x1", 2, tmp_path, *flat[3:])


def test_mesh_gradients_on_4_ranks(tmp_path):
    """(2, 2), (4, 1) and (1, 4): the layer's gradients on every rank, and
    the hoisted train step on (2, 2)."""
    cases, want = _layer_cases([(2, 2), (4, 1), (1, 4)], tmp_path)
    tcfg, pf, bf, grads, new = _step_case("step", tmp_path, data_ranks=2)
    steps = [("step_2x2_hoist", dataclasses.replace(
        tcfg, hoist_moe_layout=True), pf, bf, (2, 2), OPT)]
    run_ranks(_both, 4, tmp_path, cases, steps, str(tmp_path))
    for key, w in want.items():
        _check_layer(key, w, tmp_path, 4)
    _check_step("step_2x2_hoist", 4, tmp_path, grads, new)


def _both(rank, layer_cases, step_cases, out_dir):
    moe_grads_rank(rank, layer_cases, out_dir)
    train_step_rank(rank, step_cases, out_dir)


# ---------------------------------------------------------------------------
# the data-parallel step on placed params
# ---------------------------------------------------------------------------

DP_TOL = 1e-5
# AdamW without clipping, and with a clip far below the gradient norm.
# eps 1e-2: the first update is g / (|g| + eps) times lr, whose slope in g
# is eps / (|g| + eps)^2; at eps 1e-4 the gradient entries near 1e-4 turn
# the data-parallel sums' f32 rounding (6e-7 of a leaf's largest
# gradient) into 2e-5 of its largest update, at 1e-2 into far less, so
# the comparison holds the step rather than that rounding (the gradients
# themselves are compared at 1e-5 too)
DP_OPT = dict(OPT, eps=1e-2)
CLIPS = {"noclip": None, "clip": 1e-2}


def _dp_case(tmp_path):
    """Reduced qwen2-1.5b (2 layers, f32), a batch of 4 rows, and the
    single-rank step's gradients and new params under each clip."""
    _, tcfg, _, tp, _, tb = train_case("qwen2-1.5b", batch=4)
    params_file, batch_file = (str(tmp_path / f"dp.{k}.pt")
                               for k in ("params", "batch"))
    torch.save(tp, params_file)
    torch.save(tb, batch_file)
    grads, _ = make_grad_step(tcfg)(tp, tb)
    want = {}
    for name, clip in CLIPS.items():
        kw = dict(DP_OPT, grad_clip_norm=clip)
        new, _, m = make_train_step(tcfg, opt.AdamWConfig(**kw))(
            tp, opt.init(tp), tb)
        if clip is not None:
            assert float(m["grad_norm"]) > 10 * clip   # clipping is active
        want[name] = (kw, tree_leaves(new))
    return tcfg, params_file, batch_file, tree_leaves(grads), want


def _dp_both(rank, step_cases, ckpt_args, out_dir):
    train_step_rank(rank, step_cases, out_dir)
    checkpoint_rank(rank, *ckpt_args, out_dir)


def test_data_parallel_step_and_checkpoint_on_4_ranks(tmp_path):
    """Reduced qwen2-1.5b on placed params: on (2, 2), (4, 1) and (1, 4)
    the batch of 4 splits over "data" (each rank its rows; tensor- and
    FSDP-sharded weights), and every rank's gradients and AdamW step,
    gathered whole, equal the single-rank step's within 1e-5 of each
    leaf's largest entry, without clipping and with clipping active.  A
    checkpoint written on (2, 2) restores without a mesh to that step's
    params, and onto (4, 1) to the same tree, moments included."""
    from repro_torch.train.checkpoint import restore_checkpoint
    tcfg, pf, bf, grads, want = _dp_case(tmp_path)
    steps = [(f"dp_{D}x{M}_{name}", tcfg, pf, bf, (D, M), kw)
             for D, M in ((2, 2), (4, 1), (1, 4))
             for name, (kw, _) in want.items()]
    run_ranks(_dp_both, 4, tmp_path, steps,
              (tcfg, pf, bf, want["clip"][0]), str(tmp_path))
    for key, *_ in steps:
        new = want[key.rsplit("_", 1)[1]][1]
        for r in range(4):
            got = np.load(tmp_path / f"{key}.{r}.npz")
            for i, g in enumerate(grads):
                _close(got[f"g{i}"], g.numpy(), f"{key} rank {r} grad {i}",
                       DP_TOL)
            for i, p in enumerate(new):
                _close(got[f"p{i}"], p.numpy(), f"{key} rank {r} param {i}",
                       DP_TOL)
    tp = torch.load(pf, weights_only=True)
    back, state, step = restore_checkpoint(str(tmp_path / "ckpt.npz"), tp,
                                           tcfg, opt.init(tp))
    assert step == 1 and int(state.step) == 1
    for i, (a, b) in enumerate(zip(tree_leaves(back), want["clip"][1])):
        _close(a.numpy(), b.numpy(), f"meshless restore param {i}", DP_TOL)
    mu = tree_leaves(state.mu)
    for r in range(4):
        got = np.load(tmp_path / f"restored.{r}.npz")
        assert int(got["step"]) == 1
        for i, a in enumerate(tree_leaves(back)):
            np.testing.assert_array_equal(got[f"p{i}"], a.numpy())
        for i, a in enumerate(mu):
            np.testing.assert_array_equal(got[f"m{i}"], a.numpy())
