"""Port workload layer against the JAX one: QoS traces (classes, demand,
absolute deadlines, model preferences, per-class prompt lengths, prefix
flags), the class helpers, and the deadline-aware scheduler in the QoS
simulator and on a live QoS cluster; the launcher's ``--qos``."""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.cluster import poisson_trace as jax_poisson_trace
from repro.workload import DEFAULT_MIX as JAX_DEFAULT_MIX
from repro.workload import QoSClass as JQoSClass
from repro.workload import normalized_weights as jax_normalized_weights
from repro.workload import priority_of as jax_priority_of
from repro.workload import qos_poisson_trace as jax_qos_poisson_trace
from repro.workload import scaled as jax_scaled
from repro_torch.cluster import (DeadlineAwareScheduler, EdgeCluster,
                                 PolicyScheduler, Request,
                                 evaluate_scheduler, poisson_trace,
                                 summarize)
from repro_torch.core.agents import AgentConfig
from repro_torch.core.diffusion import DiffusionPolicyConfig
from repro_torch.core.env import EnvParams
from repro_torch.core.trainer import init_agents
from repro_torch.launch import serve
from repro_torch.serving.builders import build_fleet
from repro_torch.workload import (BEST_EFFORT, DEFAULT_MIX, INTERACTIVE,
                                  STANDARD, QoSClass, normalized_weights,
                                  priority_of, qos_poisson_trace, scaled)

ACFG = AgentConfig(train_after=10, replay_capacity=60, batch_size=16,
                   diffusion=DiffusionPolicyConfig(num_steps=2))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small eager ops on the CPU: one intra-op thread each, so parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mix(port: bool):
    """The closed-loop bench's mix at 8 tokens and a 16-token prompt:
    per-class prompt lengths, a model preference, a best-effort class."""
    sc, inter, std, be = ((scaled, INTERACTIVE, STANDARD, BEST_EFFORT)
                          if port else
                          (jax_scaled,) + tuple(c for c, _ in
                                                JAX_DEFAULT_MIX))
    return ((sc(inter, z_range=(1, 8), prompt_len=8,
                model_pref="xlstm-350m"), 0.4),
            (sc(std, z_range=(4, 16)), 0.4),
            (sc(be, prompt_len=32, z_range=(8, 24)), 0.2))


def _shared_flags(reqs, shared):
    """Which requests open with the trace's shared prefix (cut to their
    own prompt length)."""
    return [np.array_equal(np.asarray(r.prompt)[..., :shared.shape[-1]],
                           shared[..., :r.prompt.shape[-1]])
            for r in reqs]


def _same_trace(got, want, seed=0, prefix=0, vocab=97):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.rid, g.arrival_s, g.max_new_tokens, g.origin,
                g.deadline_s, g.model_pref) == \
            (w.rid, w.arrival_s, w.max_new_tokens, w.origin, w.deadline_s,
             w.model_pref)
        assert g.qos.name == w.qos.name
        assert dataclasses.asdict(g.qos) == dataclasses.asdict(w.qos)
        assert g.prompt.shape == tuple(w.prompt.shape)
        assert g.prompt.dtype == np.int32
    if prefix:
        # each package's own shared prefix, from the seeds the two share
        mine = np.random.default_rng(seed * 77_003 + 13).integers(
            0, vocab, (1, prefix), dtype=np.int32)
        ref = np.asarray(jax.random.randint(
            jax.random.key(seed * 77_003 + 13), (1, prefix), 0, vocab,
            jax.numpy.int32))
        flags = _shared_flags(got, mine)
        assert flags == _shared_flags(want, ref) and any(flags)


@pytest.mark.parametrize("seed,prefix", [(0, 0), (1, 0), (7, 0), (3, 12),
                                         (11, 24)])
def test_qos_trace_matches_reference(seed, prefix):
    """Arrivals, classes, z, absolute deadlines, preferences, per-class
    prompt lengths, origins and prefix flags equal the reference's."""
    kw = dict(rate=40.0, prompt_len=16, max_new_tokens=8, vocab_size=97,
              num_origins=3, seed=seed, prefix_len=prefix,
              prefix_frac=0.75)
    want = jax_poisson_trace(30, qos_mix=_mix(False), **kw)
    got = poisson_trace(30, qos_mix=_mix(True), **kw)
    _same_trace(got, want, seed, prefix)
    assert {r.prompt.shape[-1] for r in got} == {8, 16, 32}
    for r in got:
        if math.isinf(r.qos.deadline_s):
            assert r.deadline_s is None
        else:
            assert r.deadline_s == r.arrival_s + r.qos.deadline_s


@pytest.mark.parametrize("seed", [0, 5])
def test_qos_poisson_trace_matches_reference(seed):
    kw = dict(rate=50.0, prompt_len=8, vocab_size=64, num_origins=2,
              seed=seed)
    _same_trace(qos_poisson_trace(25, **kw),
                jax_qos_poisson_trace(25, **kw))


def test_qos_trace_refuses_weights_that_do_not_sum_positive():
    mix = ((INTERACTIVE, 0.0), (STANDARD, 0.0))
    with pytest.raises(ValueError, match="positive"):
        poisson_trace(2, rate=1.0, prompt_len=4, max_new_tokens=2,
                      vocab_size=8, qos_mix=mix)


def test_class_helpers_match_reference():
    jcls = [c for c, _ in JAX_DEFAULT_MIX]
    for port_c, jax_c in zip((INTERACTIVE, STANDARD, BEST_EFFORT), jcls):
        kw = dict(deadline_s=3.5, z_range=(2, 5), prompt_len=12,
                  model_pref="starcoder2-3b")
        assert dataclasses.asdict(scaled(port_c, **kw)) == \
            dataclasses.asdict(jax_scaled(jax_c, **kw))
        assert dataclasses.asdict(scaled(port_c)) == \
            dataclasses.asdict(jax_c)
    classes, w = normalized_weights(DEFAULT_MIX)
    jclasses, jw = jax_normalized_weights(JAX_DEFAULT_MIX)
    assert [c.name for c in classes] == [c.name for c in jclasses]
    assert w == jw
    with pytest.raises(ValueError, match="positive"):
        normalized_weights(((INTERACTIVE, 0.0),))
    reqs = [Request(rid=0, prompt=None, max_new_tokens=1, qos=STANDARD),
            Request(rid=1, prompt=None, max_new_tokens=1)]
    jreqs = [Request(rid=0, prompt=None, max_new_tokens=1, qos=jcls[1]),
             Request(rid=1, prompt=None, max_new_tokens=1)]
    assert [priority_of(r) for r in reqs] == \
        [jax_priority_of(r) for r in jreqs] == [2.0, 1.0]


def test_deadline_scheduler_in_qos_sim():
    p = EnvParams(num_bs=2, num_slots=3, max_tasks=3, qos_mix=DEFAULT_MIX)
    r = evaluate_scheduler(DeadlineAwareScheduler(2), p, episodes=1,
                           seed=1, device="cpu")
    assert r["count"] > 0 and r["mean_s"] > 0
    assert 0.0 <= r["deadline_miss_rate"] <= 1.0
    assert 0.0 <= r["weighted_goodput"] <= 1.0
    assert set(r["classes"]) <= {c.name for c, _ in DEFAULT_MIX}


def test_policy_state_dim_inferred_and_validated():
    """A policy trained on the base observation is refused by a QoS
    cluster at construction, and the other way round."""
    base = EnvParams(num_bs=2, num_slots=2, max_tasks=2)
    qos = dataclasses.replace(base, qos_mix=DEFAULT_MIX)
    gen = torch.Generator().manual_seed(0)
    s_base, s_qos = (PolicyScheduler("lad-ts", ACFG,
                                     init_agents("lad-ts", p, ACFG, gen),
                                     num_engines=2, n_max=p.max_tasks)
                     for p in (base, qos))
    assert (s_base.state_dim, s_qos.state_dim) == (4, 7)
    fleet = build_fleet(("qwen2-1.5b", "xlstm-350m"), 32, kv_slots=2,
                        device="cpu")
    with pytest.raises(ValueError, match="state_dim"):
        EdgeCluster(fleet, s_base, qos_obs=True)
    with pytest.raises(ValueError, match="state_dim"):
        EdgeCluster(fleet, s_qos, qos_obs=False)
    assert EdgeCluster(fleet, s_qos).qos_obs
    assert not EdgeCluster(fleet, s_base).qos_obs


def test_deadline_scheduler_drives_live_qos_cluster():
    """The same DeadlineAwareScheduler runs a paged qwen2 engine beside a
    dense xLSTM engine on the extended observation; the trace-level QoS
    accounting holds up and no KV is held after."""
    fleet = build_fleet(("qwen2-1.5b", "xlstm-350m"), 64, kv_slots=2,
                        device="cpu")
    assert [e.paged for e in fleet] == [True, False]
    vocab = min(e.cfg.vocab_size for e in fleet)
    mix = ((scaled(QoSClass("fast", priority=4.0, deadline_s=30.0),
                   z_range=(1, 2), model_pref="xlstm-350m"), 0.5),
           (QoSClass("slow", priority=1.0, z_range=(2, 4)), 0.5))
    cluster = EdgeCluster(fleet, DeadlineAwareScheduler(2), qos_obs=True)
    assert cluster.obs_dim == 3 + 2 * 2
    trace = poisson_trace(6, rate=50.0, prompt_len=8, max_new_tokens=4,
                          vocab_size=vocab, num_origins=2, seed=11,
                          qos_mix=mix)
    stats = summarize(cluster.run(trace))
    assert stats["count"] == stats["completed"] == 6
    assert stats["unfinished"] == 0
    assert stats["p99_s"] >= stats["p50_s"] > 0
    assert 0.0 <= stats["deadline_miss_rate"] <= 1.0
    assert 0.0 <= stats["weighted_goodput"] <= 1.0
    assert set(stats["classes"]) <= {"fast", "slow"}
    assert [e.kv_leak for e in fleet] == [0, 0]


@pytest.mark.parametrize("arch", ["starcoder2-3b", "xlstm-350m"])
def test_serve_main_qos_deadline_on_cpu(arch, capsys):
    st = serve.main(["--arch", arch, "--qos", "--scheduler", "deadline",
                     "--requests", "6", "--rate", "200", "--prompt-len",
                     "12", "--device", "cpu"])
    assert st["completed"] == st["count"] == 6 and st["unfinished"] == 0
    assert [e["kv_leak"] for e in st["engines"]] == [0, 0]
    assert [e["paged"] for e in st["engines"]] == [arch != "xlstm-350m"] * 2
    out = capsys.readouterr().out
    assert "[serve] deadline: n=6" in out and "goodput=" in out
    assert "class " in out


def test_qos_class_mirrors_reference_fields():
    assert [f.name for f in dataclasses.fields(QoSClass)] == \
        [f.name for f in dataclasses.fields(JQoSClass)]
