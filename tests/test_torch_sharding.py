"""Port sharding rules and meshes against the JAX package: the cases of
``tests/test_sharding_rules.py``, ``_leaf_spec`` on every leaf of the
reference's full mixtral-8x22b and dbrx-132b trees at two mesh sizes,
``param_pspecs`` and ``state_pspecs`` on reduced engines leaf for leaf,
the placement of the experts, and the mesh guards."""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_parity import CPU, configs, params_pair
from repro.configs import get_config as jax_get_config
from repro.launch import sharding as jsh
from repro.models.transformer import abstract_params
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.core.optim import tree_leaves
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import (Mesh, make_production_mesh,
                                     make_smoke_mesh, mesh_chips)
from repro_torch.models import moe
from repro_torch.serving.engine import ServeEngine

SIZES = {"data": 16, "model": 16}


def test_col_row_rules():
    assert sh._leaf_spec(("layers", "scan", "mixer", "wq"),
                         (28, 1536, 1536), SIZES) == (None, "data", "model")
    assert sh._leaf_spec(("layers", "scan", "mixer", "wo"),
                         (28, 1536, 1536), SIZES) == (None, "model", "data")
    assert sh._leaf_spec(("layers", "3", "ffn", "w_down"),
                         (8960, 1536), SIZES) == ("model", "data")


def test_vocab_rule_with_codebooks():
    assert sh._leaf_spec(("embed", "embed"), (151936, 1536), SIZES) == \
        ("model", "data")
    assert sh._leaf_spec(("embed", "embed"), (4, 2048, 2048), SIZES) == \
        (None, "model", "data")


def test_expert_rule_and_fallback():
    # dbrx: 16 experts divide 16 -> expert parallel
    assert sh._leaf_spec(("layers", "scan", "ffn", "we_up"),
                         (40, 16, 6144, 10752), SIZES) == \
        (None, "model", "data", None)
    # mixtral: 8 experts don't divide 16 -> fall back to d_ff
    assert sh._leaf_spec(("layers", "scan", "ffn", "we_up"),
                         (56, 8, 6144, 16384), SIZES) == \
        (None, None, "data", "model")
    assert sh._leaf_spec(("layers", "scan", "ffn", "we_down"),
                         (56, 8, 16384, 6144), SIZES) == \
        (None, None, "model", "data")


def test_indivisible_dims_replicate():
    assert sh._leaf_spec(("final_norm", "scale"), (1536,), SIZES) == (None,)
    assert sh._leaf_spec(("m", "wq"), (17, 33), SIZES) == (None, None)


def test_state_specs():
    assert sh._state_leaf_spec(("scan", "k"), (12, 32, 8, 32768, 128),
                               "data") == (None, "data", None, "model", None)
    assert sh._state_leaf_spec(("3", "C"), (2, 4, 256, 256), "data") == \
        ("data", None, "model", None)
    assert sh._state_leaf_spec(("3", "pos"), (), "data") == ()
    assert sh._state_leaf_spec(("3", "h"), (2, 1024), "data") == \
        ("data", None)


def test_state_specs_divisibility_guard():
    sizes = {"data": 4, "model": 16}
    assert sh._state_leaf_spec(("scan", "k"), (12, 6, 8, 32768, 128),
                               "data", sizes) == \
        (None, None, None, "model", None)
    assert sh._state_leaf_spec(("scan", "k"), (12, 8, 8, 100, 128), "data",
                               sizes) == (None, "data", None, None, None)
    assert sh._state_leaf_spec(("3", "h"), (6, 1024), ("pod", "data"),
                               {"pod": 2, "data": 4}) == (None, None)


def _paths(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                   for k in kp), leaf) for kp, leaf in flat]


def _is_spec(x):
    return isinstance(x, P)


@pytest.mark.parametrize("sizes", [{"data": 16, "model": 16},
                                   {"data": 2, "model": 4}],
                         ids=["16x16", "2x4"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "dbrx-132b"])
def test_leaf_spec_matches_reference_on_full_trees(arch, sizes):
    """Every (path, shape) of the reference's published-size params
    (``jax.eval_shape``; scanned layers) gives the reference's spec."""
    tree = abstract_params(jax_get_config(arch))
    leaves = _paths(tree)
    assert any(p[-1] == "we_down" for p, _ in leaves)
    for path, leaf in leaves:
        want = jsh._leaf_spec(path, leaf.shape, sizes)
        assert sh._leaf_spec(path, tuple(leaf.shape), sizes) == \
            tuple(want), path


def _strip_flat(path):
    return tuple(p for p in path if p != "flat")


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "dbrx-132b",
                                  "qwen2-1.5b"])
def test_param_pspecs_match_reference_leaf_for_leaf(arch):
    """The port's flat layer list gives the specs of the reference's
    ``{"flat": [...]}`` tree, leaf for leaf."""
    jcfg, tcfg = configs(num_layers=2, arch=arch)
    jparams, tparams = params_pair(jcfg, tcfg)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4},
                                 axis_names=("data", "model"))
    want = {_strip_flat(p): tuple(s) for p, s in _paths(
        jsh.param_pspecs(jparams, mesh), _is_spec)}
    assert len(want) == len(_paths(jparams))
    got = dict(_spec_leaves(sh.param_pspecs(tparams, mesh)))
    assert got == want


def _spec_leaves(tree, path=()):
    """(path, spec) pairs of a spec tree (dicts and lists of tuples)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, path + (str(i),))
    else:
        yield path, tree


def _engine_states(arch, paged):
    """The reference's and the port's engine states after one request."""
    jcfg, tcfg = configs(num_layers=2, arch=arch)
    jparams, tparams = params_pair(jcfg, tcfg)
    kw = dict(max_len=40, kv_slots=2, paged=paged, prefill_chunk=8)
    je = JServeEngine(jcfg, jparams, **kw)
    te = ServeEngine(tcfg, tparams, device=CPU, **kw)
    prompt = np.arange(10, dtype=np.int32)[None] % jcfg.vocab_size
    je.generate(prompt, 3)
    te.generate(prompt, 3)
    if paged:
        return je._paged_states, te._paged_states
    return je._pool_states, te._pool_states


MESHES = {"none": None,
          "4x2": types.SimpleNamespace(shape={"data": 4, "model": 2},
                                       axis_names=("data", "model")),
          "pod": types.SimpleNamespace(
              shape={"pod": 2, "data": 1, "model": 2},
              axis_names=("pod", "data", "model"))}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,paged", [("mixtral-8x22b", False),
                                        ("dbrx-132b", True),
                                        ("recurrentgemma-9b", False),
                                        ("xlstm-350m", False)])
def test_state_pspecs_match_reference_on_engine_states(arch, paged, mesh):
    """The engines' slot pools and page pools: every leaf of the port's
    per-layer states gets the spec the reference's rules give its shape
    and name.  The page pools have the reference's shapes, so there the
    port's specs are the reference engine's own."""
    mesh = MESHES[mesh]
    jst, tst = _engine_states(arch, paged)
    shapes = {"flat": [{k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
                        for k, v in layer.items()} for layer in tst]}
    want = [{k: tuple(v) for k, v in layer.items()}
            for layer in jsh.state_pspecs(shapes, mesh)["flat"]]
    got = sh.state_pspecs(tst, mesh)
    assert got == want
    if paged:
        assert got == [{k: tuple(v) for k, v in layer.items()}
                       for layer in jsh.state_pspecs(jst, mesh)["flat"]]


def test_sharding_context_rules():
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 1},
                                 axis_names=("data", "model"))
    ctx = sh.ShardingContext(mesh)
    assert ctx.spec("batch", None, "ff") == ("data", None, "model")
    pod = types.SimpleNamespace(axis_names=("pod", "data", "model"))
    assert sh.ShardingContext(pod).rules["batch"] == ("pod", "data")
    assert sh.current() is None
    x = torch.ones((2, 2))
    with sh.use(ctx):
        assert sh.current() is ctx
        assert sh.act(x, "batch", None) is x
    assert sh.current() is None


def test_place_params_keeps_only_the_ranks_expert_block():
    """On the 1 x 1 mesh the MoE leaves are the rank's (1, r, d, f_lp)
    block; every other leaf's block is the whole leaf, and is the
    caller's tensor (no copy)."""
    _, tcfg = configs(num_layers=2, arch="mixtral-8x22b")
    _, tparams = params_pair(*configs(num_layers=2, arch="mixtral-8x22b"))
    mesh = make_smoke_mesh(CPU)
    placed = sh.place_params(mesh, tparams, tcfg)
    for src, got in zip(tparams["layers"], placed["layers"]):
        for k, v in src["mixer"].items():
            assert got["mixer"][k] is v
        assert got["ffn"]["router"] is src["ffn"]["router"]
        for k in ("we_up", "we_gate", "we_down"):
            want = moe.prepare_tree(src["ffn"], tcfg, 1)[k]
            assert got["ffn"][k].shape == want.shape
            np.testing.assert_array_equal(got["ffn"][k].numpy(),
                                          want.numpy())
    assert placed["embed"]["embed"] is tparams["embed"]["embed"]
    jd, dense = configs(num_layers=1)
    _, dparams = params_pair(jd, dense)
    same = sh.place_params(mesh, dparams, dense)
    assert all(a is b for a, b in zip(tree_leaves(same),
                                      tree_leaves(dparams)))


def test_smoke_mesh_is_one_rank_and_idempotent():
    mesh = make_smoke_mesh("cpu")
    assert isinstance(mesh, Mesh)
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh_chips(mesh) == 1
    assert make_smoke_mesh("cpu") is mesh
    assert make_production_mesh(shape=(1, 1), axes=("data", "model"),
                                device="cpu") == mesh
    assert hash(mesh) == hash(make_production_mesh(
        shape=(1, 1), axes=("data", "model"), device="cpu"))
    assert mesh.local_rank("model") == mesh.local_rank("data") == 0
    t = torch.ones(3)
    torch.distributed.all_reduce(t, group=mesh.get_group("model"))
    assert t.tolist() == [1.0, 1.0, 1.0]


def test_production_mesh_rejects_mismatched_world_size():
    with pytest.raises(ValueError, match="world size 1"):
        make_production_mesh(shape=(4, 4), axes=("data", "model"),
                             device="cpu")
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh(device="cpu")


def test_production_mesh_shape_axes_must_pair():
    with pytest.raises(ValueError, match="together"):
        make_production_mesh(shape=(4, 4))
    with pytest.raises(ValueError, match="together"):
        make_production_mesh(axes=("data", "model"))
