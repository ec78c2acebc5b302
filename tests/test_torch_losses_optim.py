"""Port CE loss, AdamW, checkpoints and the layer restacking against the
reference: the chunked CE's loss within 1e-6 and its gradient with respect
to the hidden states within 1e-5 of ``jax.grad``; AdamW's params and
moments within 1e-6 after a few updates, weight decay on the reference's
layout; checkpoints restored across the two packages bit for bit; and
``params_to_jax`` / ``params_from_jax`` round trips.  Reduced configs in
f32 unless stated."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, configs, params_pair
from repro.models.transformer import init_params as jax_init_params
from repro.train import optimizer as jopt
from repro.train.checkpoint import restore_checkpoint as jax_restore
from repro.train.checkpoint import save_checkpoint as jax_save
from repro.train.losses import chunked_ce_loss as jax_ce
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.optim import tree_leaves
from repro_torch.models.transformer import apply_head
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.losses import chunked_ce_loss

RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops on the CPU: one intra-op thread each, so parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(got, want):
    """Two numpy trees of the same structure, leaf for leaf bit-equal."""
    g, gdef = jax.tree_util.tree_flatten(got)
    w, wdef = jax.tree_util.tree_flatten(want)
    assert gdef == wdef
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8))


def _close_trees(got, want, tol):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------


def _dense_ce(params, cfg, hidden, labels, mask=None):
    """The whole sequence's CE in one piece (the port's plain oracle)."""
    logits = apply_head(params, cfg, hidden).float()
    if cfg.num_codebooks:
        labels = labels.transpose(1, 2)
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels.long()[..., None])[..., 0]
    if cfg.num_codebooks:
        nll = nll.mean(-1)
    if mask is None:
        mask = torch.ones(nll.shape)
    return (nll * mask).sum() / mask.sum()


def _ce_case(arch, B, S, masked):
    jcfg, tcfg = configs(arch=arch)
    jp, tp = params_pair(jcfg, tcfg)
    h = RNG.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    shape = (B, tcfg.num_codebooks, S) if tcfg.num_codebooks else (B, S)
    labels = RNG.integers(0, tcfg.vocab_size, shape).astype(np.int32)
    mask = None
    if masked:
        mask = np.zeros((B, S), np.float32)
        mask[:, S // 2:] = 1.0
    return jcfg, tcfg, jp, tp, h, labels, mask


CE_CASES = {"text": ("qwen2-1.5b", 2, 64, False, 16),
            "codebooks": ("musicgen-large", 2, 32, False, 8),
            "masked": ("qwen2-1.5b", 2, 32, True, 8),
            "uneven_chunk": ("qwen2-1.5b", 1, 48, False, 32)}


@pytest.mark.parametrize("case", list(CE_CASES))
def test_chunked_ce_and_its_grad_match_the_reference(case):
    arch, B, S, masked, chunk = CE_CASES[case]
    jcfg, tcfg, jp, tp, h, labels, mask = _ce_case(arch, B, S, masked)
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(hh):
        return jax_ce(jp, jcfg, hh, jnp.asarray(labels), jmask, chunk=chunk)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(h))
    ht = torch.from_numpy(h).requires_grad_()
    got = chunked_ce_loss(tp, tcfg, ht, torch.from_numpy(labels),
                          None if mask is None else torch.from_numpy(mask),
                          chunk=chunk)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["text", "codebooks", "masked"])
def test_chunked_ce_matches_dense(case):
    arch, B, S, masked, chunk = CE_CASES[case]
    _, tcfg, _, tp, h, labels, mask = _ce_case(arch, B, S, masked)
    h, labels = torch.from_numpy(h), torch.from_numpy(labels)
    mask = None if mask is None else torch.from_numpy(mask)
    got = chunked_ce_loss(tp, tcfg, h, labels, mask, chunk=chunk)
    want = _dense_ce(tp, tcfg, h, labels, mask)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    if masked:
        # corrupting masked labels must not change the loss
        bad = labels.clone()
        bad[:, 0] = 0
        again = chunked_ce_loss(tp, tcfg, h, bad, mask, chunk=chunk)
        np.testing.assert_allclose(float(got), float(again), rtol=1e-6)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip", [1.0, None], ids=["clipped", "unclipped"])
def test_adamw_updates_match_the_reference(clip):
    jcfg, tcfg = configs()
    jp, tp = params_pair(jcfg, tcfg)
    ocfg = dict(learning_rate=1e-2, warmup_steps=2, total_steps=6,
                grad_clip_norm=clip)
    jstate, tstate = jopt.init(jp), opt.init(tp)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: RNG.standard_normal(p.shape).astype(np.float32) * 0.3,
            _np(jp))
        tgrads = params_from_jax(grads, tcfg, CPU)
        jgrads = jax.tree_util.tree_map(jnp.asarray, grads)
        jp, jstate, jm = jopt.update(jopt.AdamWConfig(**ocfg), jgrads,
                                     jstate, jp)
        tp, tstate, tm = opt.update(opt.AdamWConfig(**ocfg), tgrads, tstate,
                                    tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 3
    for got, want in ((tp, jp), (tstate.mu, jstate.mu),
                      (tstate.nu, jstate.nu)):
        _close_trees(got, params_from_jax(_np(want), tcfg, CPU), 1e-6)


def test_weight_decay_follows_the_reference_layout():
    """A config that scans its layers decays the stacked vectors too: the
    port's flat list with ``decay_mask`` updates as the reference's
    scan / rem tree does (4 recurrentgemma layers: one group of 3, one
    remainder layer)."""
    jcfg, tcfg = configs(arch="recurrentgemma-9b", num_layers=4,
                         scan_layers=True)
    jp = jax_init_params(jax.random.key(1), jcfg)
    tp = params_from_jax(_np(jp), tcfg, CPU)
    mask = opt.decay_mask(tp, tcfg)
    assert mask["layers"][0]["norm1"]["scale"] is True
    assert mask["layers"][3]["norm1"]["scale"] is False
    grads = jax.tree_util.tree_map(
        lambda p: RNG.standard_normal(p.shape).astype(np.float32), _np(jp))
    ocfg = opt.AdamWConfig(learning_rate=1e-2, warmup_steps=1,
                           total_steps=4, weight_decay=0.5)
    jnew, _, _ = jopt.update(jopt.AdamWConfig(**dataclasses.asdict(ocfg)),
                             jax.tree_util.tree_map(jnp.asarray, grads),
                             jopt.init(jp), jp)
    tnew, _, _ = opt.update(ocfg, params_from_jax(grads, tcfg, CPU),
                            opt.init(tp), tp, decay=mask)
    got = params_to_jax(tnew, tcfg, "scan")
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(_np(jnew))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_adamw_minimises_quadratic():
    cfg = opt.AdamWConfig(learning_rate=0.1, weight_decay=0.0,
                          warmup_steps=1, total_steps=200,
                          grad_clip_norm=None)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(150):
        params, state, _ = opt.update(cfg, {"w": 2 * params["w"]}, state,
                                      params)
    assert float(params["w"].abs().max()) < 0.3


def test_grad_clip_bounds_update():
    cfg = opt.AdamWConfig(learning_rate=1.0, grad_clip_norm=1.0,
                          weight_decay=0.0, warmup_steps=1, total_steps=10)
    params = {"w": torch.zeros(3)}
    new, _, metrics = opt.update(cfg, {"w": torch.full((3,), 1e6)},
                                 opt.init(params), params)
    assert float(metrics["grad_norm"]) > 1e5      # reported before clipping
    assert float(new["w"].abs().max()) <= 1.0 + 1e-6


# ---------------------------------------------------------------------------
# layer restacking and checkpoints
# ---------------------------------------------------------------------------


LAYOUTS = {"flat": dict(arch="xlstm-350m"),
           "scan_rem": dict(arch="recurrentgemma-9b", num_layers=4,
                            scan_layers=True),
           "scan_bf16": dict(arch="qwen2-1.5b", num_layers=3,
                             scan_layers=True, dtype="bfloat16")}


def _layout_case(name, seed=0):
    kw = dict(LAYOUTS[name])
    jcfg, tcfg = configs(**kw)
    jp = jax_init_params(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp, "scan" if tcfg.scan_layers else "flat"


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_params_to_jax_round_trips_bit_for_bit(name):
    _, tcfg, jp, layout = _layout_case(name)
    tree = _np(jp)
    port = params_from_jax(tree, tcfg, CPU)
    _assert_trees_equal(params_to_jax(port, tcfg, layout), tree)
    again = params_from_jax(params_to_jax(port, tcfg, layout), tcfg, CPU)
    for a, b in zip(tree_leaves(again), tree_leaves(port)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _trained(jcfg, tcfg, jp):
    """The reference's params and optimizer state after one update on
    seeded grads (nonzero moments), and the port's copies."""
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(RNG.standard_normal(p.shape), p.dtype), jp)
    jp, jst, _ = jopt.update(jopt.AdamWConfig(), grads, jopt.init(jp), jp)
    tst = opt.AdamWState(
        step=torch.tensor(int(jst.step), dtype=torch.int32),
        mu=params_from_jax(_np(jst.mu), tcfg, CPU),
        nu=params_from_jax(_np(jst.nu), tcfg, CPU))
    return jp, jst, params_from_jax(_np(jp), tcfg, CPU), tst


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_a_reference_checkpoint_restores_in_the_port(name, tmp_path):
    jcfg, tcfg, jp, layout = _layout_case(name)
    jp, jst, tp, tst = _trained(jcfg, tcfg, jp)
    path = os.path.join(tmp_path, "ref.npz")
    jax_save(path, jp, jst, step=11)
    like = jax.tree_util.tree_map(torch.zeros_like, tp)
    opt_like = opt.init(like)
    got, got_opt, step = restore_checkpoint(path, like, tcfg, opt_like)
    assert step == 11 and int(got_opt.step) == 1
    for a, b in zip(tree_leaves((got, got_opt.mu, got_opt.nu)),
                    tree_leaves((tp, tst.mu, tst.nu))):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_a_port_checkpoint_restores_in_the_reference(name, tmp_path):
    jcfg, tcfg, jp, layout = _layout_case(name)
    jp, jst, tp, tst = _trained(jcfg, tcfg, jp)
    path = os.path.join(tmp_path, "port.npz")
    save_checkpoint(path, tp, tcfg, tst, step=5)
    like = jax_init_params(jax.random.key(3), jcfg)
    got, got_opt, step = jax_restore(path, like, jopt.init(like))
    assert step == 5
    _assert_trees_equal(_np(got), params_to_jax(tp, tcfg, layout))
    _assert_trees_equal(_np(got_opt), _np(jst))


def test_checkpoint_roundtrip(tmp_path):
    """The reference's own round trip, on the port (xLSTM, step 17)."""
    _, tcfg, jp, _ = _layout_case("flat")
    tp = params_from_jax(_np(jp), tcfg, CPU)
    state = opt.init(tp)
    path = os.path.join(tmp_path, "ckpt.npz")
    save_checkpoint(path, tp, tcfg, state, step=17)
    p2, o2, step = restore_checkpoint(path, tp, tcfg, state)
    assert step == 17
    for a, b in zip(tree_leaves((tp, state.mu)), tree_leaves((p2, o2.mu))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_bf16_checkpoint_roundtrip(tmp_path):
    _, tcfg, jp, _ = _layout_case("scan_bf16")
    tp = params_from_jax(_np(jp), tcfg, CPU)
    assert tp["embed"]["embed"].dtype == torch.bfloat16
    path = os.path.join(tmp_path, "bf16.npz")
    save_checkpoint(path, tp, tcfg)
    with np.load(path) as z:
        assert "params/embed/embed__bf16__" in z.files
    p2, _, _ = restore_checkpoint(path, tp, tcfg)
    for a, b in zip(tree_leaves(tp), tree_leaves(p2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
