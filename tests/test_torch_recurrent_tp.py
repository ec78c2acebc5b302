"""Tensor-parallel RG-LRU and mLSTM blocks on gloo meshes (1, 4), (2, 2)
and (4, 1), and on (1, 3): the RG-LRU where the rank's channels cut the
block-diagonal gates' blocks (their inputs are all-gathered over
"model"), the mLSTM where 3 does not divide head_dim 64 (every rank
holds every row of ``C`` / ``n``).  At the block, each rank's outputs of the prompt's scan (the
RG-LRU's time loop and prefix scan, the mLSTM's loop) and of one decode
step from a state placed by ``state_pspecs``, and its states (the
RG-LRU's ``h`` / ``conv`` whole, the mLSTM's ``C`` / ``n`` its rows),
equal the reference's within 1e-5 (RG-LRU) and 1e-4 (mLSTM); a train
step of the reduced model (the RG-LRU's autograd branch, the mLSTM's
rows) gives the reference's loss, gradients and new params within
1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import (each, ranks_running, recurrent_block_rank,
                         train_step_rank)
from _torch_parity import configs
from _torch_train import OPT, one_thread, reference_step, train_case
from repro.models import rglru as jrglru
from repro.models import xlstm as jxlstm
from repro_torch.convert import params_from_jax
from repro_torch.core.optim import tree_leaves

MESHES = [(1, 4), (2, 2), (4, 1)]
B, S = 3, 11
# name: (arch, overrides, meshes, tolerance)
BLOCKS = {
    "rglru": ("recurrentgemma-9b", {}, MESHES, 1e-5),
    "rglru_cut_blocks": ("recurrentgemma-9b", dict(rg_lru_dim=384),
                         [(1, 3)], 1e-5),
    "mlstm": ("xlstm-350m", {}, MESHES, 1e-4),
    "mlstm_whole_rows": ("xlstm-350m", {}, [(1, 3)], 1e-4),
}
STEPS = {"rg": ("recurrentgemma-9b", dict(num_layers=3), MESHES),
         "rg_cut_blocks": ("recurrentgemma-9b",
                           dict(num_layers=2, rg_lru_dim=384), [(1, 3)]),
         "xlstm": ("xlstm-350m", dict(num_layers=4), MESHES),
         "xlstm_whole_rows": ("xlstm-350m", dict(num_layers=2), [(1, 3)])}

# AdamW's eps at 1e-2, as for the data-parallel step of
# test_torch_train_mesh.py: the update of a gradient entry near eps is
# steep in it, and the ranks' sums round differently from one device's
_thread = pytest.fixture(autouse=True)(one_thread)
DP_OPT = dict(OPT, eps=1e-2)


def _block_case(name, tmp_path):
    """The reference's outputs and states, and the inputs file."""
    arch, over, _, _ = BLOCKS[name]
    jcfg, tcfg = configs(arch=arch, **over)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    xt = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    if tcfg.layer_pattern()[0].mixer == "rglru":
        jp = jrglru.init_rglru(jax.random.key(3), jcfg, jnp.float32)
        out, st = jrglru.rglru_scan(jp, jcfg, jnp.asarray(x))
        assoc, _ = jrglru.rglru_scan(jp, jcfg, jnp.asarray(x),
                                     use_assoc_scan=True)
        out1, st1 = jrglru.rglru_step(jp, jcfg, jnp.asarray(xt), st)
        want = {"assoc": assoc}
    else:
        jp = jxlstm.init_mlstm(jax.random.key(3), jcfg, jnp.float32)
        out, st = jxlstm.mlstm_scan(jp, jcfg, jnp.asarray(x))
        out1, st1 = jxlstm.mlstm_step(jp, jcfg, jnp.asarray(xt), st)
        want = {}
    want.update(scan=out, step=out1,
                **{f"scan_{k}": v for k, v in st.items() if k != "pos"},
                **{f"step_{k}": v for k, v in st1.items() if k != "pos"})
    whole = {k: np.broadcast_to(np.asarray(v), (B,)).astype(np.int32)
             if k == "pos" else np.asarray(v) for k, v in st.items()}
    path = str(tmp_path / f"{name}.npz")
    np.savez(path, x=x, xt=xt, **{f"p:{k}": np.asarray(v)
                                  for k, v in jp.items()},
             **{f"s:{k}": v for k, v in whole.items()})
    return tcfg, path, {k: np.asarray(v) for k, v in want.items()}


def _rows(a: np.ndarray, name: str, j: int, M: int) -> np.ndarray:
    """The block of a reference state a "model" rank holds: the mLSTM's
    ``C`` / ``n`` rows (dim 2) where M divides them, anything else
    whole."""
    if (name.endswith("_C") or name.endswith("_n")) and a.shape[2] % M == 0:
        c = a.shape[2] // M
        return a[:, :, j * c:(j + 1) * c]
    return a


def _step_case(name, tmp_path):
    arch, over, _ = STEPS[name]
    jcfg, tcfg, jp, tp, jb, tb = train_case(arch, batch=4, **over)
    pf, bf = (str(tmp_path / f"step_{name}.{k}.pt") for k in ("p", "b"))
    torch.save(tp, pf)
    torch.save(tb, bf)
    return jcfg, tcfg, jp, jb, pf, bf


def _check_step(name, want, tmp_path, world, meshes):
    loss, g, p = want
    for D, M in meshes:
        for r in range(world):
            got = np.load(tmp_path / f"step_{name}_{D}x{M}.{r}.npz")
            np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-4)
            for i, (a, b) in enumerate(zip(g, p)):
                for blob, w in ((f"g{i}", a), (f"p{i}", b)):
                    err = float(np.abs(got[blob] - w).max())
                    assert err <= 1e-4 * max(float(np.abs(w).max()), 1e-6), \
                        f"{name} {D}x{M} rank {r} {blob}: {err:.2e}"


def _run(world, blocks, steps, tmp_path):
    block_cases, block_want, step_cases, step_want = [], {}, [], {}
    for name in blocks:
        tcfg, path, want = _block_case(name, tmp_path)
        for shape in BLOCKS[name][2]:
            block_cases.append((f"{name}_{shape[0]}x{shape[1]}", tcfg, path,
                                shape))
        block_want[name] = want
    made = {}
    for name in steps:
        jcfg, tcfg, jp, jb, pf, bf = _step_case(name, tmp_path)
        for shape in STEPS[name][2]:
            step_cases.append((f"step_{name}_{shape[0]}x{shape[1]}", tcfg,
                               pf, bf, shape, DP_OPT))
        made[name] = (jcfg, tcfg, jp, jb)
    calls = [(recurrent_block_rank, (block_cases, str(tmp_path))),
             (train_step_rank, (step_cases, str(tmp_path)))]
    with ranks_running(each, world, tmp_path, calls, timeout=300.0):
        for name, (jcfg, tcfg, jp, jb) in made.items():
            _, grads, new, metrics = reference_step(jcfg, jp, jb, DP_OPT)
            step_want[name] = (
                metrics["loss"],
                [t.numpy() for t in tree_leaves(params_from_jax(
                    grads, tcfg, "cpu"))],
                [t.numpy() for t in tree_leaves(params_from_jax(
                    new, tcfg, "cpu"))])
    for name, want in block_want.items():
        tol = BLOCKS[name][3]
        for D, M in BLOCKS[name][2]:
            for r in range(world):
                got = np.load(tmp_path / f"{name}_{D}x{M}.{r}.npz")
                for k, w in want.items():
                    np.testing.assert_allclose(
                        got[k], _rows(w, k, r % M, M), atol=tol, rtol=tol,
                        err_msg=f"{name} {D}x{M} rank {r} {k}")
    for name, want in step_want.items():
        _check_step(name, want, tmp_path, world, STEPS[name][2])


def test_tensor_parallel_recurrent_blocks_on_4_ranks(tmp_path):
    """RG-LRU and mLSTM on (1, 4), (2, 2), (4, 1): blocks and train
    steps equal the reference."""
    _run(4, ("rglru", "mlstm"), ("rg", "xlstm"), tmp_path)


def test_rglru_channels_that_cut_the_gate_blocks(tmp_path):
    """rd 384 over 3 "model" ranks: 128 channels a rank against gate
    blocks of 48, so each rank all-gathers the gates' inputs; the block
    and a train step equal the reference."""
    _run(3, ("rglru_cut_blocks",), ("rg_cut_blocks",), tmp_path)


def test_mlstm_whole_where_model_does_not_divide_head_dim(tmp_path):
    """head_dim 64 over 3 "model" ranks: ``state_pspecs`` leaves ``C`` /
    ``n`` whole, so every rank computes every row with nothing reduced;
    the block and a train step equal the reference."""
    _run(3, ("mlstm_whole_rows",), ("xlstm_whole_rows",), tmp_path)
