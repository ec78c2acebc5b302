"""Port of ``repro.core`` against the reference on the CPU: the diffusion
schedule and reverse step, the networks on stacked agents, Adam, the
replay pool, the environment (with and without the QoS and fault
extensions), and one act and one update per learned method from one
state carried across by ``convert.agent_states_from_jax``.

Both packages get the same inputs as numpy arrays; the port's random
draws are the ones the reference makes from its keys, reconstructed here
from the same key splits.  Tolerances: f32 arithmetic in another order,
1e-6 for single ops, 1e-5 (relative for losses, absolute for parameters)
for an agent update.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import agents_to_torch, episode_to_torch
from repro.core import agents as jag
from repro.core import diffusion as jdiff
from repro.core import env as jenv
from repro.core import networks as jnets
from repro.core import optim as joptim
from repro.core import replay as jreplay
from repro.core.trainer import make_agent_fns as jax_make_agent_fns
from repro.faults.simfault import FaultParams as JFaultParams
from repro.workload import DEFAULT_MIX as JDEFAULT_MIX
from repro_torch.core import agents as ag
from repro_torch.core import diffusion as diff
from repro_torch.core import env as envlib
from repro_torch.core import networks as nets
from repro_torch.core import optim
from repro_torch.core import replay
from repro_torch.core.optim import tree_leaves
from repro_torch.core.trainer import make_agent_fns
from repro_torch.faults import FaultParams, mask_actions, step_avail
from repro_torch.workload import DEFAULT_MIX

TOL = 1e-6


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# diffusion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("I", [1, 3, 5, 8])
def test_schedule_matches_reference(I):  # noqa: E741
    want = jdiff.make_schedule(I, 0.1, 10.0)
    got = diff.make_schedule(I, 0.1, 10.0)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=TOL, rtol=TOL)
    for w, g in zip(jdiff.make_schedule_np(I), diff.make_schedule_np(I)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("paper_variance", [True, False])
def test_reverse_step_and_forward_sample_match_reference(paper_variance):
    I = 5  # noqa: E741
    rng = np.random.default_rng(0)
    x, eps, noise = (rng.standard_normal((4, 6)).astype(np.float32)
                     for _ in range(3))
    jsched, tsched = jdiff.make_schedule(I), diff.make_schedule(I)
    for i in range(1, I + 1):
        want = jdiff.reverse_step(jsched, eps, x, i, noise, paper_variance)
        got = diff.reverse_step(tsched, _t(eps), _t(x), i, _t(noise),
                                paper_variance)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(
            diff.forward_sample(tsched, _t(x), i, _t(eps)).numpy(),
            _np(jdiff.forward_sample(jsched, x, i, eps)), atol=TOL,
            rtol=TOL)
    # no noise on the final step
    a = diff.reverse_step(tsched, _t(eps), _t(x), 1, _t(noise))
    b = diff.reverse_step(tsched, _t(eps), _t(x), 1, 0 * _t(noise))
    torch.testing.assert_close(a, b, atol=0.0, rtol=0.0)


# ---------------------------------------------------------------------------
# networks, Adam, replay
# ---------------------------------------------------------------------------


def _jax_stacked(init, G, seed=0):
    keys = jax.random.split(jax.random.key(seed), G)
    tree = jax.vmap(init)(keys)
    return tree, [{k: _t(v) for k, v in layer.items()}
                  for layer in jax.tree_util.tree_map(np.asarray, tree)]


def test_timestep_embed_matches_reference():
    for i in (1, 3, 5):
        np.testing.assert_allclose(nets.timestep_embed(i).numpy(),
                                   _np(jnets.timestep_embed(i)), atol=TOL)
    steps = np.arange(5, 0, -1)
    np.testing.assert_allclose(
        nets.timestep_embed(_t(steps)).numpy(),
        _np(jnets.timestep_embed(jnp.asarray(steps))), atol=TOL)


def test_apply_ladn_and_critic_on_stacked_agents():
    G, S, A, T = 3, 10, 4, 5
    jl, tl = _jax_stacked(lambda k: jnets.init_ladn(k, S, A, (20, 20)), G)
    jc, tc = _jax_stacked(lambda k: jnets.init_critic(k, S, A, (20, 20)), G,
                          seed=1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((G, T, A)).astype(np.float32)
    s = rng.standard_normal((G, T, S)).astype(np.float32)
    want = jax.vmap(lambda p, xx, ss: jnets.apply_ladn(p, xx, 3, ss))(jl, x,
                                                                       s)
    got = nets.apply_ladn(tl, _t(x), 3, _t(s))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL, rtol=TOL)
    want = jax.vmap(jnets.apply_critic)(jc, s)
    np.testing.assert_allclose(nets.apply_critic(tc, _t(s)).numpy(),
                               _np(want), atol=TOL, rtol=TOL)
    # one row per agent: (G, S) -> (G, A)
    np.testing.assert_allclose(nets.apply_critic(tc, _t(s[:, 0])).numpy(),
                               _np(want)[:, 0], atol=TOL, rtol=TOL)


def test_adam_matches_reference_per_agent():
    G = 3
    jp, tp = _jax_stacked(lambda k: jnets.init_critic(k, 6, 4, (8,)), G)
    jstate = jax.vmap(joptim.adam_init)(jp)
    tstate = optim.adam_init(tp)
    rng = np.random.default_rng(2)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), jp)
        jp, jstate = jax.vmap(
            lambda p, gg, s: joptim.adam_update(p, gg, s, 1e-3))(jp, g,
                                                                  jstate)
        tg = [{k: _t(v) for k, v in layer.items()} for layer in g]
        tp, tstate = optim.adam_update(tp, tg, tstate, 1e-3)
    for w, got in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(got.numpy(), _np(w), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(tstate.step.numpy(), _np(jstate.step))


def test_replay_add_and_sample_match_reference():
    G, cap = 3, 5
    spec = jag.transition_spec(4, 2)
    jstate = jax.vmap(lambda _: jreplay.replay_init(cap, spec))(
        jnp.arange(G))
    tstate = replay.replay_init(cap, ag.transition_spec(4, 2), G)
    rng = np.random.default_rng(3)
    for j in range(9):
        item = jax.tree_util.tree_map(
            lambda a: (rng.integers(0, 2, (G,) + a.shape).astype(np.int32)
                       if a.dtype == jnp.int32 else
                       rng.standard_normal((G,) + a.shape)
                       .astype(np.float32)), spec)
        valid = rng.random(G) < 0.7
        jstate = jax.vmap(jreplay.replay_add)(jstate, item, valid)
        tstate = replay.replay_add(
            tstate, ag.Transition(*(_t(v) for v in item)), _t(valid))
    np.testing.assert_array_equal(tstate.ptr.numpy(), _np(jstate.ptr))
    np.testing.assert_array_equal(tstate.size.numpy(), _np(jstate.size))
    for w, got in zip(jstate.data, tstate.data):
        np.testing.assert_array_equal(got.numpy(), _np(w))
    keys = jax.random.split(jax.random.key(4), G)
    want = jax.vmap(lambda s, k: jreplay.replay_sample(s, k, 6))(jstate,
                                                                  keys)
    idx = np.stack([_np(jax.random.randint(k, (6,), 0,
                                           max(int(n), 1)))
                    for k, n in zip(keys, _np(jstate.size))])
    got = replay.replay_sample(tstate, 6, idx=_t(idx).long())
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    drawn = replay.sample_indices(tstate, 1000, torch.Generator())
    assert (drawn >= 0).all() and (drawn < tstate.size[:, None]).all()


# ---------------------------------------------------------------------------
# environment
# ---------------------------------------------------------------------------

ENVS = {
    "plain": ({}, {}),
    "qos": ({"qos_mix": JDEFAULT_MIX, "deadline_penalty": 1.0},
            {"qos_mix": DEFAULT_MIX, "deadline_penalty": 1.0}),
    "fault": ({"fault": JFaultParams(p_down=0.3)},
              {"fault": FaultParams(p_down=0.3)}),
}


def _env_pair(name, **kw):
    jkw, tkw = ENVS[name]
    base = dict(num_bs=4, num_slots=3, max_tasks=5, **kw)
    return (jenv.EnvParams(**base, **jkw), envlib.EnvParams(**base, **tkw))


@pytest.mark.parametrize("name", list(ENVS))
def test_env_step_functions_match_reference(name):
    jp, tp = _env_pair(name)
    assert tp.state_dim == jp.state_dim
    np.testing.assert_array_equal(envlib.state_scale(tp).numpy(),
                                  _np(jenv.state_scale(jp)))
    jep = jenv.sample_episode(jax.random.key(5), jp)
    tep = episode_to_torch(jep)
    rng = np.random.default_rng(5)
    q = rng.uniform(0, 3, (2, 4)).astype(np.float32)
    jqs = jenv.QueueState(q_prev=q[0], q_bef=q[1])
    tqs = envlib.QueueState(q_prev=_t(q[0]), q_bef=_t(q[1]))
    av = np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)
    for t, n in [(0, 0), (1, 3), (2, 4)]:
        wl = jep.rho[t, n] * jep.z[t, n]
        want = jenv.observe(jp, jqs, jep.d[t, n], wl,
                            slack=jep.deadline[t, n], f=jep.f, avail=av)
        got = envlib.observe(tp, tqs, tep.d[t, n],
                             tep.rho[t, n] * tep.z[t, n],
                             slack=tep.deadline[t, n], f=tep.f,
                             avail=_t(av))
        np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL,
                                   rtol=TOL)
        # duplicate picks: several stations choose the same ES
        actions = np.asarray([2, 2, 0, 2], np.int32)
        np.testing.assert_allclose(
            envlib.task_delays(tp, tep, tqs, t, n, _t(actions).long())
            .numpy(), _np(jenv.task_delays(jp, jep, jqs, t, n, actions)),
            atol=TOL, rtol=TOL)
        jqs = jenv.apply_actions(jp, jep, jqs, t, n, actions)
        tqs = envlib.apply_actions(tp, tep, tqs, t, n, _t(actions).long())
        np.testing.assert_allclose(tqs.q_bef.numpy(), _np(jqs.q_bef),
                                   atol=TOL, rtol=TOL)
        jqs = jenv.end_slot(jp, jep, jqs, avail=av if tp.has_faults
                            else None)
        tqs = envlib.end_slot(tp, tep, tqs, avail=_t(av) if tp.has_faults
                              else None)
        np.testing.assert_allclose(tqs.q_prev.numpy(), _np(jqs.q_prev),
                                   atol=TOL, rtol=TOL)
        assert float(tqs.q_bef.abs().max()) == 0.0


def test_fault_process_matches_reference():
    from repro.faults import simfault as jsf
    jfp, tfp = JFaultParams(p_down=0.4, p_up=0.6), FaultParams(p_down=0.4,
                                                               p_up=0.6)
    rng = np.random.default_rng(6)
    av = np.asarray([1, 0, 1, 0, 1], np.float32)
    for _ in range(5):
        u = rng.random(5).astype(np.float32)
        want = jsf.step_avail(jfp, av, u)
        got = step_avail(tfp, _t(av), _t(u))
        np.testing.assert_array_equal(got.numpy(), _np(want))
        av = _np(want)
    for avail in ([1, 0, 1, 0, 1], [0, 0, 0, 0, 0]):
        avail = np.asarray(avail, np.float32)
        load = rng.random(5).astype(np.float32)
        actions = np.asarray([1, 3, 0, 1, 4], np.int32)
        wa, ww = jsf.mask_actions(avail, load, actions)
        ga, gw = mask_actions(_t(avail), _t(load), _t(actions).long())
        np.testing.assert_array_equal(ga.numpy(), _np(wa))
        np.testing.assert_array_equal(gw.numpy(), _np(ww))


@pytest.mark.parametrize("name", list(ENVS))
def test_sample_episode_shapes_and_ranges(name):
    _, tp = _env_pair(name)
    ep = envlib.sample_episode(torch.Generator().manual_seed(0), tp)
    shape = (tp.num_slots, tp.max_tasks, tp.num_bs)
    for field in ("d", "d_out", "z", "rho", "v_up", "v_down", "mask", "cls",
                  "deadline", "priority"):
        assert tuple(getattr(ep, field).shape) == shape, field
    assert tuple(ep.f.shape) == (tp.num_bs,)
    assert ((ep.f >= 10) & (ep.f <= 50)).all()
    # at least min_tasks per (slot, station), a prefix of the task slots
    m = ep.mask
    assert (m[:, 0] == 1).all() and (m[:, 1:] <= m[:, :-1]).all()
    if tp.has_qos:
        assert set(ep.cls.unique().tolist()) <= {0, 1, 2}
        assert torch.isinf(ep.deadline[ep.cls == 2]).all()
    else:
        assert ((ep.z >= 1) & (ep.z <= 15)).all()


# ---------------------------------------------------------------------------
# one act and one update per learned method
# ---------------------------------------------------------------------------

P = jenv.EnvParams(num_bs=3, num_slots=2, max_tasks=4)
CFG_J = jag.AgentConfig(batch_size=8, replay_capacity=40, train_after=5)
CFG_T = ag.AgentConfig(batch_size=8, replay_capacity=40, train_after=5)
LEARNED = ["lad-ts", "d2sac-ts", "sac-ts", "dqn-ts"]


def _filled_state(method, seed=0):
    """The reference's B = 3 stacked agents with 20 random transitions
    each, and the port's copy."""
    from repro.core.trainer import init_agents
    init, act, update, add, latent = jax_make_agent_fns(method, CFG_J)
    states = init_agents(method, P, CFG_J, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    spec = jag.transition_spec(P.state_dim, P.action_dim)
    for _ in range(20):
        item = jax.tree_util.tree_map(
            lambda a: (rng.integers(0, P.action_dim, (3,) + a.shape)
                       .astype(np.int32) if a.dtype == jnp.int32 else
                       rng.standard_normal((3,) + a.shape)
                       .astype(np.float32)), spec)
        states = jax.vmap(add)(states, item, rng.random(3) < 0.9)
    return states, agents_to_torch(states, method)


def _chain_draws(key, rows, A, I):  # noqa: E741
    """What ``agents._policy_probs`` draws from ``key`` for ``rows``
    chains (None = one unbatched chain): eps0 and the chain noise."""
    def one(k):
        k_noise, k_chain = jax.random.split(k)
        return (_np(jax.random.normal(k_noise, (A,))),
                _np(jax.random.normal(k_chain, (I, A))))
    if rows is None:
        return [x[None] for x in one(key)]
    pairs = [one(k) for k in jax.random.split(key, rows)]
    return [np.stack(x) for x in zip(*pairs)]


def _act_draws(method, keys, A, I):  # noqa: E741
    """The reference's act draws for each agent's key, as the port's
    noise dict."""
    per = []
    for k in keys:
        if method in ("lad-ts", "d2sac-ts"):
            k_chain, k_samp = jax.random.split(k)
            eps0, chain = _chain_draws(k_chain, None, A, I)
            per.append({"eps0": eps0, "chain": chain,
                        "gumbel": _np(jax.random.gumbel(k_samp, (A,))),
                        "x_used": _np(jax.random.normal(
                            jax.random.fold_in(k, 7), (A,)))})
        elif method == "sac-ts":
            per.append({"gumbel": _np(jax.random.gumbel(k, (A,)))})
        else:
            k1, k2 = jax.random.split(k)
            per.append({"rand_a": _np(jax.random.randint(k1, (), 0, A)),
                        "u": _np(jax.random.uniform(k2))})
    out = {name: _t(np.stack([d[name] for d in per])) for name in per[0]}
    if "eps0" in out:
        out["chain"] = ag.ChainNoise(out.pop("eps0"), out["chain"])
    if "rand_a" in out:
        out["rand_a"] = out["rand_a"].long()
    return out


def _update_draws(method, keys, sizes, K, A, I):  # noqa: E741
    per = []
    for k, n in zip(keys, sizes):
        hi = max(int(n), 1)
        if method in ("lad-ts", "d2sac-ts"):
            k_samp, k_pi, k_next, k_actor = jax.random.split(k, 4)
            d = {"idx": _np(jax.random.randint(k_samp, (K,), 0, hi))}
            for name, kk in (("next", k_next), ("actor", k_actor),
                             ("now", k_pi)):
                d[name] = _chain_draws(kk, K, A, I)
        elif method == "sac-ts":
            d = {"idx": _np(jax.random.randint(jax.random.split(k)[0], (K,),
                                               0, hi))}
        else:
            d = {"idx": _np(jax.random.randint(k, (K,), 0, hi))}
        per.append(d)
    out = {"idx": _t(np.stack([d["idx"] for d in per])).long()}
    for name in ("next", "actor", "now"):
        if name in per[0]:
            out[name] = ag.ChainNoise(
                _t(np.stack([d[name][0] for d in per])),
                _t(np.stack([d[name][1] for d in per])))
    return out


def _assert_states_close(got, want_jax, method, atol):
    want = agents_to_torch(want_jax, method)
    for w, g in zip(tree_leaves(want), tree_leaves(got)):
        if w.is_floating_point():
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=atol,
                                       rtol=0)
        else:
            np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("method", LEARNED)
def test_act_matches_reference(method):
    jstates, tstates = _filled_state(method)
    _, jact, *_ = jax_make_agent_fns(method, CFG_J)
    fns = make_agent_fns(method, CFG_T)
    rng = np.random.default_rng(7)
    s = rng.standard_normal((3, P.state_dim)).astype(np.float32)
    keys = jax.random.split(jax.random.key(8), 3)
    for n in (1, 3):
        want_a, want_x, jstates = jax.vmap(
            jact, in_axes=(0, 0, None, 0, None))(jstates, s, n, keys, False)
        noise = _act_draws(method, keys, P.action_dim,
                           CFG_T.diffusion.num_steps)
        got_a, got_x, tstates = fns.act(tstates, _t(s), n, noise=noise)
        np.testing.assert_array_equal(got_a.numpy(), _np(want_a))
        np.testing.assert_allclose(got_x.numpy(), _np(want_x), atol=1e-5,
                                   rtol=0)
        _assert_states_close(tstates, jstates, method, atol=1e-5)
        keys = jax.random.split(keys[0], 3)


@pytest.mark.parametrize("method", LEARNED)
def test_update_matches_reference(method):
    jstates, tstates = _filled_state(method, seed=1)
    _, _, jupdate, *_ = jax_make_agent_fns(method, CFG_J)
    fns = make_agent_fns(method, CFG_T)
    keys = jax.random.split(jax.random.key(9), 3)
    want, jmetrics = jax.vmap(jupdate)(jstates, keys)
    noise = _update_draws(method, keys, _np(jstates.replay.size),
                          CFG_T.batch_size, P.action_dim,
                          CFG_T.diffusion.num_steps)
    got, metrics = fns.update(tstates, noise=noise)
    for name, value in jmetrics.items():
        np.testing.assert_allclose(metrics[name].numpy(), _np(value),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    _assert_states_close(got, want, method, atol=1e-5)
    # the update changed what it trains
    nets_before = tstates.theta if method in ("lad-ts", "d2sac-ts") else (
        tstates.actor if method == "sac-ts" else tstates.q)
    nets_after = got.theta if method in ("lad-ts", "d2sac-ts") else (
        got.actor if method == "sac-ts" else got.q)
    assert max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(nets_before), tree_leaves(nets_after))) > 0


def test_act_draws_reproduce_reference_categorical():
    """The Gumbel draw the port takes from a key is what
    ``jax.random.categorical`` adds to the logits."""
    logits = jnp.asarray(np.random.default_rng(0).standard_normal(7),
                         jnp.float32)
    for seed in range(20):
        k = jax.random.key(seed)
        want = int(jax.random.categorical(k, logits))
        g = jax.random.gumbel(k, (7,))
        assert int(jnp.argmax(logits + g)) == want


def test_latent_write_back_standardizes_with_population_std():
    """The latent store keeps z-scored x_0 with ``correction=0`` (jnp.std),
    only at the acted task slot."""
    _, tstates = _filled_state("lad-ts", seed=2)
    fns = make_agent_fns("lad-ts", dataclasses.replace(CFG_T))
    s = torch.randn((3, P.state_dim), generator=torch.Generator())
    _, _, new = fns.act(tstates, s, 2, torch.Generator().manual_seed(1))
    row = new.X[:, 2]
    torch.testing.assert_close(row.mean(-1), torch.zeros(3), atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(row.std(-1, correction=0), torch.ones(3),
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(new.X[:, [0, 1, 3]], tstates.X[:, [0, 1, 3]],
                               atol=0.0, rtol=0.0)
