"""Port of the Algorithm-1 trainer, the simulator's scheduler evaluation
and the learned scheduler against the reference on the CPU.

Heuristic episodes are deterministic given the episode, so the port runs
the reference's own ``EpisodeData`` and must give its average delay and
its delay percentiles (1e-5 relative: f32 sums in another order).
Learned episodes draw from another generator than the reference's keys,
so they are held to running, staying finite and learning.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import FakeClock, episode_to_torch
from repro.cluster import make_scheduler as jax_make_scheduler
from repro.cluster.simulate import evaluate_scheduler as jax_evaluate
from repro.core import agents as jag
from repro.core import env as jenv
from repro.core.trainer import build_episode_fn as jax_build_episode_fn
from repro.faults.simfault import FaultParams as JFaultParams
from repro.workload import DEFAULT_MIX as JDEFAULT_MIX
from repro_torch.cluster import (EdgeCluster, PolicyScheduler,
                                 make_scheduler, poisson_trace)
from repro_torch.cluster import simulate
from repro_torch.core import agents as ag
from repro_torch.core import env as envlib
from repro_torch.core.optim import tree_leaves
from repro_torch.core.trainer import (LEARNED, build_episode_fn,
                                      init_agents, train_method)
from repro_torch.faults import FaultParams
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.serving.builders import build_engines
from repro_torch.workload import DEFAULT_MIX

REL = 1e-5
ENVS = {
    "plain": ({}, {}),
    "qos": ({"qos_mix": JDEFAULT_MIX, "deadline_penalty": 1.0},
            {"qos_mix": DEFAULT_MIX, "deadline_penalty": 1.0}),
    "fault": ({"fault": JFaultParams(p_down=0.3)},
              {"fault": FaultParams(p_down=0.3)}),
}
CFG_J = jag.AgentConfig(train_after=30, replay_capacity=200, batch_size=16)
CFG_T = ag.AgentConfig(train_after=30, replay_capacity=200, batch_size=16)


def _env_pair(name, **kw):
    jkw, tkw = ENVS[name]
    base = {**dict(num_bs=4, num_slots=4, max_tasks=5), **kw}
    return jenv.EnvParams(**base, **jkw), envlib.EnvParams(**base, **tkw)


@pytest.mark.parametrize("name", list(ENVS))
@pytest.mark.parametrize("method", ["opt-ts", "local-ts"])
def test_heuristic_episode_gives_reference_delay(method, name):
    jp, tp = _env_pair(name)
    key = jax.random.key(1)
    ep = jenv.sample_episode(key, jp)
    _, want = jax.jit(jax_build_episode_fn(method, jp, CFG_J))(None, ep, key)
    _, got = build_episode_fn(method, tp, CFG_T)(None, episode_to_torch(ep),
                                                 torch.Generator())
    assert float(got) == pytest.approx(float(want), rel=REL)


@pytest.mark.parametrize("method", list(LEARNED) + ["random-ts"])
def test_episode_runs_and_delay_finite(method):
    _, tp = _env_pair("plain")
    gen = torch.Generator().manual_seed(0)
    states = init_agents(method, tp, CFG_T, gen)
    ep = envlib.sample_episode(gen, tp)
    _, avg = build_episode_fn(method, tp, CFG_T)(states, ep, gen)
    assert np.isfinite(float(avg)) and float(avg) > 0


def test_opt_beats_random():
    _, tp = _env_pair("plain", num_slots=6)
    ep = envlib.sample_episode(torch.Generator().manual_seed(1), tp)
    _, d_opt = build_episode_fn("opt-ts", tp, CFG_T)(
        None, ep, torch.Generator().manual_seed(2))
    _, d_rnd = build_episode_fn("random-ts", tp, CFG_T)(
        None, ep, torch.Generator().manual_seed(2))
    assert float(d_opt) < float(d_rnd)


def test_training_updates_only_agents_past_train_after():
    """An agent trains once its pool holds more than ``train_after`` items
    (the per-agent ``torch.where``); below that it keeps its weights."""
    _, tp = _env_pair("plain", num_slots=2)
    cfg = dataclasses.replace(CFG_T, train_after=6)
    gen = torch.Generator().manual_seed(3)
    states = init_agents("lad-ts", tp, cfg, gen)
    ep = envlib.sample_episode(gen, tp)
    # station 0 gets a task in every slot, the others none after slot 0
    mask = torch.zeros_like(ep.mask)
    mask[:, :, 0] = 1.0
    mask[0, 0, :] = 1.0
    ep = ep._replace(mask=mask)
    new, avg = build_episode_fn("lad-ts", tp, cfg)(states, ep, gen)
    assert np.isfinite(float(avg))
    assert new.replay.size.tolist() == [9, 1, 1, 1]
    assert new.steps.tolist()[0] > 0 and new.steps.tolist()[1:] == [0, 0, 0]
    for a, b in zip(tree_leaves(states.theta), tree_leaves(new.theta)):
        assert (a[0] != b[0]).any()
        torch.testing.assert_close(a[1:], b[1:], atol=0.0, rtol=0.0)


def test_training_on_cpu_launches_no_kernel():
    _, tp = _env_pair("plain", num_slots=2)
    before = dict(ops.launches)
    delays, states = train_method("lad-ts", tp, CFG_T, episodes=1,
                                  device="cpu")
    assert np.isfinite(delays).all() and ops.launches == before
    assert isinstance(states, ag.LadtsState)


# ---------------------------------------------------------------------------
# evaluate_scheduler and the learned scheduler
# ---------------------------------------------------------------------------


def _reference_episodes(jp, key, episodes):
    """The capacities and episodes the reference's evaluate_scheduler
    draws from ``key``."""
    key, k_f = jax.random.split(key)
    f = jenv.sample_capacities(k_f, jp)
    eps = []
    for _ in range(episodes):
        key, k_ep, _ = jax.random.split(key, 3)
        eps.append(episode_to_torch(jenv.sample_episode(k_ep, jp, f=f)))
    return f, eps


def _compare(got, want):
    for k, v in want.items():
        if k == "carry":
            continue
        if isinstance(v, dict):
            assert got[k].keys() == v.keys(), k
            _compare(got[k], v)
        elif isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=REL, abs=1e-7), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("name", list(ENVS))
@pytest.mark.parametrize("sched", ["jsq", "local", "round-robin"])
def test_evaluate_scheduler_baselines_match_reference(sched, name,
                                                      monkeypatch):
    jp, tp = _env_pair(name)
    key = jax.random.key(11)
    want = jax_evaluate(jax_make_scheduler(sched, 4), jp, 2, key)
    f, eps = _reference_episodes(jp, key, 2)
    it = iter(eps)
    monkeypatch.setattr(simulate.envlib, "sample_episode",
                        lambda gen, p, f=None: next(it))
    got = simulate.evaluate_scheduler(make_scheduler(sched, 4), tp, 2,
                                      f=torch.from_numpy(np.array(f)),
                                      device="cpu")
    assert set(got) == set(want)
    _compare(got, want)


def _trained_policy(method="lad-ts", num_bs=2):
    p = envlib.EnvParams(num_bs=num_bs, num_slots=3, max_tasks=4)
    cfg = ag.AgentConfig(train_after=10, replay_capacity=50, batch_size=8,
                         diffusion=dataclasses.replace(
                             ag.AgentConfig().diffusion, num_steps=3))
    _, states = train_method(method, p, cfg, episodes=1, device="cpu")
    return p, cfg, states


@pytest.mark.parametrize("method", LEARNED)
def test_policy_scheduler_in_the_simulator(method):
    p, cfg, states = _trained_policy(method, num_bs=3)
    sched = make_scheduler(method, 3, cfg=cfg, states=states,
                           n_max=p.max_tasks)
    assert isinstance(sched, PolicyScheduler)
    assert sched.state_dim == p.state_dim
    res = simulate.evaluate_scheduler(sched, p, 1, device="cpu")
    assert res["count"] > 0 and np.isfinite(res["mean_s"])
    assert isinstance(res["carry"], type(states))


def test_policy_select_one_touches_only_its_origin():
    """``select_one`` runs the origin's agent alone: only that agent's
    latent row at slot n changes, and the carry passed in is left as it
    was."""
    p, cfg, states = _trained_policy(num_bs=3)
    sched = PolicyScheduler("lad-ts", cfg, states, num_engines=3,
                            n_max=p.max_tasks)
    carry = sched.init_carry()
    X0 = carry.X.clone()
    row = torch.zeros((p.state_dim,))
    eng, new = sched.select_one(carry, row, 1, 6, torch.Generator())
    assert 0 <= eng < 3
    torch.testing.assert_close(carry.X, X0, atol=0.0, rtol=0.0)
    changed = (new.X != X0).any(-1)
    assert changed.tolist() == [[False] * 4, [False, False, True, False],
                                [False] * 4]       # 6 % n_max = 2
    assert all(a is b for a, b in zip(tree_leaves(new.theta_act),
                                      tree_leaves(carry.theta_act)))


def test_policy_scheduler_drives_the_live_cluster():
    p, cfg, states = _trained_policy()
    sched = PolicyScheduler("lad-ts", cfg, states, num_engines=2,
                            n_max=p.max_tasks)
    engines = build_engines("qwen2-1.5b", 2, 32, device="cpu",
                            kv_slots=2, page_size=8, prefill_chunk=8)
    for e in engines:
        e._clock = FakeClock()
    cluster = EdgeCluster(engines, sched, seed=0, clock=FakeClock())
    trace = poisson_trace(6, rate=1000.0, prompt_len=8, max_new_tokens=4,
                          vocab_size=engines[0].cfg.vocab_size,
                          num_origins=2, seed=0)
    done = cluster.run(trace)
    assert len(done) == 6 and all(r.status == "ok" for r in done)
    assert all(e.kv_leak == 0 for e in engines)
    assert cluster.carry is not sched.states     # the latents evolved


def test_serve_main_with_lad_ts_on_cpu(capsys):
    st = serve.main(["--arch", "qwen2-1.5b", "--edges", "2", "--requests",
                     "4", "--tokens", "3", "--prompt-len", "8", "--rate",
                     "200", "--scheduler", "lad-ts", "--train-episodes",
                     "1", "--device", "cpu"])
    assert st["completed"] == st["count"] == 4
    assert [e["kv_leak"] for e in st["engines"]] == [0, 0]
    assert st["launches"] == {"paged_flash_decode": 0, "ladn_denoise": 0,
                              "flash_attention": 0, "flash_decode": 0,
                              "flash_decode_partials": 0, "decode_merge": 0,
                              "paged_flash_decode_partials": 0,
                              "paged_flash_decode_window": 0}
    assert st["train_s"] > 0
    out = capsys.readouterr().out
    assert "training lad-ts in-sim" in out and "[serve] lad-ts: n=4" in out


@pytest.mark.slow
def test_learned_methods_improve_over_training():
    """After a few episodes on an easy env (one clearly-fastest ES), the
    learned scheduler must beat random (the reference's slow test)."""
    p = envlib.EnvParams(num_bs=4, num_slots=8, max_tasks=6,
                         f_range=(5.0, 50.0))
    cfg = ag.AgentConfig(train_after=50, replay_capacity=500,
                         batch_size=32)
    delays, _ = train_method("lad-ts", p, cfg, episodes=8, seed=4,
                             device="cpu")
    rand_delays, _ = train_method("random-ts", p, cfg, episodes=3, seed=4,
                                  device="cpu")
    assert min(delays[-3:]) < np.mean(rand_delays) * 1.05
