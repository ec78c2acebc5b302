"""Port cluster layer against the JAX one: trace streams, summaries, and
two clusters driven by submit/step in lockstep; plus the launcher on the
CPU and the no-card rule of the entry points."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import CPU, FakeClock, tokens_of
from repro.cluster import EdgeCluster as JEdgeCluster
from repro.cluster import make_scheduler as jax_make_scheduler
from repro.cluster import poisson_trace as jax_poisson_trace
from repro.cluster import summarize as jax_summarize
from repro.serving.builders import build_engines as jax_build_engines
from repro_torch.cluster import (EdgeCluster, PolicyScheduler, Request,
                                 Scheduler, make_scheduler, poisson_trace,
                                 summarize)
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.faults import RetryPolicy
from repro_torch.launch import serve
from repro_torch.serving.builders import build_engines
from repro_torch.serving.engine import ServeEngine


@pytest.mark.parametrize("seed,prefix", [(0, 0), (5, 0), (3, 12)],
                         ids=["seed0", "seed5", "prefix"])
def test_poisson_trace_stream_matches_reference(seed, prefix):
    """Arrivals, generation lengths, origins and which requests share the
    system prompt come from the same numpy stream as the reference."""
    kw = dict(rate=7.0, prompt_len=16, max_new_tokens=9, vocab_size=97,
              num_origins=3, seed=seed, prefix_len=prefix, prefix_frac=0.5)
    want = jax_poisson_trace(20, **kw)
    got = poisson_trace(20, **kw)
    for w, g in zip(want, got):
        assert (g.rid, g.arrival_s, g.max_new_tokens, g.origin) == \
            (w.rid, w.arrival_s, w.max_new_tokens, w.origin)
        assert g.prompt.shape == w.prompt.shape and g.prompt.dtype == np.int32
        assert 0 <= g.prompt.min() and g.prompt.max() < 97
    if prefix:
        def sharing(reqs):
            head = np.asarray(reqs[0].prompt)[..., :prefix]
            return [np.array_equal(np.asarray(r.prompt)[..., :prefix], head)
                    for r in reqs]
        assert sharing(got) == sharing(want)


def test_summarize_matches_reference():
    from repro.cluster.request import Request as JRequest
    rows = [(0.0, 1.5, 0), (0.2, 0.9, 8), (0.5, None, 0), (0.1, 2.0, 3)]
    reqs = {cls: [] for cls in (JRequest, Request)}
    for cls, out in reqs.items():
        for i, (t0, t1, saved) in enumerate(rows):
            r = cls(rid=i, prompt=None, max_new_tokens=1)
            r.t_arrival, r.prefix_tokens = t0, saved
            if t1 is not None:
                r.finish(t1)
            out.append(r)
    assert summarize(reqs[Request]) == jax_summarize(reqs[JRequest])


@pytest.mark.parametrize("name", ["jsq", "round-robin", "local"])
def test_masked_selection_matches_reference(name):
    """A pick that lands on a DOWN engine is redirected to the least
    loaded available one, as in the reference."""
    row = np.asarray([0.5, 0.2, 0.0, 3.0, 1.0], np.float32)
    avail = [False, True, True]
    jsched, tsched = jax_make_scheduler(name, 3), make_scheduler(name, 3)
    jc, tc = jsched.init_carry(), tsched.init_carry()
    for origin in range(3):
        want, jc = jsched.select_one_masked(jc, jax.numpy.asarray(row),
                                            origin, 0, jax.random.key(0),
                                            avail)
        got, tc = tsched.select_one_masked(tc, torch.from_numpy(row),
                                           origin, 0, torch.Generator(),
                                           avail)
        assert got == want and avail[got]


def _clusters(name):
    """The reference's 2-engine cluster (depths 2 and 4) and the port's
    built from the same weights, both on injected clocks."""
    kw = dict(kv_slots=2, page_size=8, prefill_chunk=8)
    jeng = jax_build_engines("qwen2-1.5b", 2, 40, **kw)
    teng = []
    for e in jeng:
        cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")),
                                  num_layers=e.cfg.num_layers)
        tree = jax.tree_util.tree_map(np.asarray, e.params)
        teng.append(ServeEngine(cfg, params_from_jax(tree, cfg, CPU),
                                max_len=40, clock=FakeClock(), device=CPU,
                                **kw))
    return (JEdgeCluster(jeng, jax_make_scheduler(name, 2), seed=1,
                         clock=FakeClock()),
            EdgeCluster(teng, make_scheduler(name, 2), seed=1,
                        clock=FakeClock()))


@pytest.mark.parametrize("name", ["jsq", "round-robin"])
def test_clusters_in_lockstep_place_and_decode_alike(name):
    jc, tc = _clusters(name)
    trace = jax_poisson_trace(6, rate=10.0, prompt_len=16, max_new_tokens=6,
                              vocab_size=512, num_origins=2, seed=2)
    jreqs, treqs = [], []
    for r in trace:
        jreqs.append(r)
        treqs.append(Request(rid=r.rid, prompt=np.asarray(r.prompt),
                             max_new_tokens=r.max_new_tokens,
                             arrival_s=r.arrival_s, origin=r.origin))
    placements = []
    for batch in (slice(0, 3), slice(3, 6)):
        for jr, tr in zip(jreqs[batch], treqs[batch]):
            placements.append((jc.submit(jr), tc.submit(tr)))
        for _ in range(2):
            jc.step()
            tc.step()
    while jc.busy or tc.busy:
        jc.step()
        tc.step()
    assert all(a == b for a, b in placements)
    assert len({a for a, _ in placements}) == 2     # both engines used
    for jr, tr in zip(jreqs, treqs):
        assert tr.status == jr.status == "ok"
        np.testing.assert_array_equal(tokens_of(tr), tokens_of(jr))
    assert all(e.kv_leak == 0 for e in tc.engines)


def test_serve_main_on_cpu_completes_every_request(capsys):
    st = serve.main(["--arch", "qwen2-1.5b", "--edges", "2", "--requests",
                     "5", "--tokens", "4", "--prompt-len", "16", "--rate",
                     "200", "--prefix-len", "8", "--device", "cpu"])
    assert st["completed"] == st["count"] == 5 and st["unfinished"] == 0
    assert [e["kv_leak"] for e in st["engines"]] == [0, 0]
    assert sum(e["decode_rounds"] for e in st["engines"]) > 0
    assert st["launches"] == {"paged_flash_decode": 0,    # plain on CPU
                              "ladn_denoise": 0, "flash_attention": 0,
                              "flash_decode": 0, "flash_decode_partials": 0,
                              "decode_merge": 0,
                              "paged_flash_decode_partials": 0,
                              "paged_flash_decode_window": 0}
    out = capsys.readouterr().out
    assert out.count("[serve] req ") == 5 and "[serve] jsq: n=5" in out


def _reference_serve_lines(monkeypatch, capsys, argv):
    """The reference launcher's printed lines for ``argv``."""
    import sys
    from repro.launch import serve as jax_serve
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    capsys.readouterr()
    jax_serve.main()
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("flag", [["--chaos"],
                                  ["--scheduler", "failure-aware"],
                                  ["--qos", "--chaos"]],
                         ids=["chaos", "failure-aware", "qos-chaos"])
def test_serve_main_runs_the_fault_layer(flag, capsys, monkeypatch):
    """``--chaos``, ``--scheduler failure-aware`` and both with ``--qos``
    serve every request to a terminal state on the CPU; under
    ``--chaos`` the schedule lines equal the reference launcher's and
    the injector has run out."""
    argv = ["--arch", "qwen2-1.5b", "--edges", "2", "--requests", "4",
            "--tokens", "3", "--prompt-len", "8", "--rate", "8", *flag]
    st = serve.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert st["count"] + st["failed"] + st["abandoned"] == 4
    assert st["completion_rate"] == 1.0 and st["unfinished"] == 0
    assert [e["kv_leak"] for e in st["engines"]] == [0, 0]
    assert st["fault_stats"]["quarantined"] == 0
    chaos = "--chaos" in flag
    assert len(st["fault_schedule"]) == (4 if chaos else 0)
    assert st["fault_stats"]["injected"] == len(st["fault_schedule"])
    summary = out[-1] if "--qos" not in flag else [
        line for line in out if line.startswith("[serve] jsq:")][0]
    assert (" cr=1.000 retries=" in summary) == chaos
    if flag == ["--chaos"]:
        want = _reference_serve_lines(monkeypatch, capsys, argv)
        assert [line for line in out if line.startswith("[serve] fault")] \
            == [line for line in want if line.startswith("[serve] fault")]


def test_entry_points_without_a_card_raise(monkeypatch):
    """With no card and no explicit device the port refuses to run rather
    than quietly using the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_engines("qwen2-1.5b", 1, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen2-1.5b", "--requests", "1"])
    eng = build_engines("qwen2-1.5b", 1, 32, device="cpu")[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(eng.cfg, eng.params)


def test_agent_states_from_jax_without_a_device_needs_a_card(monkeypatch):
    """The converter, like every entry point, goes to ``cuda`` unless the
    caller asks for the CPU."""
    from repro.core import agents as jag
    from repro.core import env as jenv
    from repro.core.trainer import init_agents as jax_init_agents
    from repro_torch.convert import agent_states_from_jax
    p = jenv.EnvParams(num_bs=2, num_slots=1, max_tasks=3)
    states = jax.tree_util.tree_map(np.asarray, jax_init_agents(
        "sac-ts", p, jag.AgentConfig(replay_capacity=8), jax.random.key(0)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        agent_states_from_jax(states, "sac-ts")
    got = agent_states_from_jax(states, "sac-ts", "cpu")
    assert got.log_alpha.device == CPU


def test_greedy_policy_scheduler_picks_the_reference_engine():
    """``PolicyScheduler(greedy=True)`` for LAD-TS places by Eqn (8) as
    the reference's does, on the reference's own chain draws, through
    ``select`` (every origin) and ``select_one`` (one origin), and keeps
    the same latent store."""
    from _torch_parity import act_draws, agents_to_torch
    from repro.cluster import PolicyScheduler as JPolicyScheduler
    from repro.core import agents as jag
    from repro.core import env as jenv
    from repro.core.trainer import init_agents as jax_init_agents
    from repro_torch.core import agents as ag
    p = jenv.EnvParams(num_bs=3, num_slots=1, max_tasks=4)
    jcfg = jag.AgentConfig(replay_capacity=8)
    tcfg = ag.AgentConfig(replay_capacity=8)
    I = tcfg.diffusion.num_steps  # noqa: E741
    jstates = jax_init_agents("lad-ts", p, jcfg, jax.random.key(3))
    jsched = JPolicyScheduler("lad-ts", jcfg, jstates, num_engines=3,
                              n_max=4, greedy=True)
    tsched = PolicyScheduler("lad-ts", tcfg,
                             agents_to_torch(jstates, "lad-ts"),
                             num_engines=3, n_max=4, greedy=True)
    s = np.random.default_rng(4).standard_normal(
        (3, p.state_dim)).astype(np.float32)

    def inject(noise):
        tsched._fns = tsched._fns._replace(
            draw_act=lambda carry, generator: noise)

    key = jax.random.key(5)
    want, jcarry = jsched.select(jsched.init_carry(), s, 6, key)
    inject(act_draws("lad-ts", jax.random.split(key, 3), p.action_dim, I))
    got, tcarry = tsched.select(tsched.init_carry(), torch.from_numpy(s), 6,
                                torch.Generator())
    assert got.tolist() == np.asarray(want).tolist()
    np.testing.assert_allclose(tcarry.X.numpy(), np.asarray(jcarry.X),
                               atol=1e-5, rtol=0)
    for origin, n, seed in ((1, 7, 6), (2, 2, 7)):
        key = jax.random.key(seed)
        want, jcarry = jsched.select_one(jcarry, s[origin], origin, n, key)
        inject(act_draws("lad-ts", [key], p.action_dim, I))
        got, tcarry = tsched.select_one(tcarry, torch.from_numpy(s[origin]),
                                        origin, n, torch.Generator())
        assert got == want
        np.testing.assert_allclose(tcarry.X.numpy(), np.asarray(jcarry.X),
                                   atol=1e-5, rtol=0)


class _Engine:
    """Engine stand-in for placement tests: always up, never busy."""

    def __init__(self):
        self.admitted = []
        self.available = True
        self.has_work = False
        self.pending_tokens = 0

    def admit(self, req):
        self.admitted.append(req.rid)


class _RecordingScheduler(Scheduler):
    """Places everything on engine 0 and records the carry and task slot
    of every call; each call returns a new carry."""

    name = "recording"

    def __init__(self, num_engines, n_max):
        super().__init__(num_engines)
        self.n_max = n_max
        self.calls = []

    def init_carry(self):
        return "init"

    def select(self, carry, s, n, generator):
        self.calls.append((carry, n, tuple(s.shape)))
        return (torch.zeros((s.shape[0],), dtype=torch.int64),
                f"after-{len(self.calls)}")


def _trace(n):
    return poisson_trace(n, rate=1000.0, prompt_len=4, max_new_tokens=2,
                         vocab_size=16, num_origins=2, seed=0)


def test_submit_wraps_the_task_slot_at_n_max():
    """A learned policy's latent store has n_max rows: the cluster hands
    the scheduler ``count % n_max``, as the reference does."""
    sched = _RecordingScheduler(2, n_max=3)
    cluster = EdgeCluster([_Engine(), _Engine()], sched, clock=FakeClock())
    for r in _trace(7):
        cluster.submit(r)
    assert [n for _, n, _ in sched.calls] == [0, 1, 2, 0, 1, 2, 0]


def test_run_warms_the_scheduler_and_drops_the_warm_up_carry():
    """``run`` calls the scheduler once on a zero row before the first
    arrival, and the first placement still starts from the initial
    carry."""
    sched = _RecordingScheduler(2, n_max=4)
    engines = [_Engine(), _Engine()]
    cluster = EdgeCluster(engines, sched, clock=FakeClock())
    cluster.run(_trace(3))
    assert len(sched.calls) == 4 and engines[0].admitted == [0, 1, 2]
    assert sched.calls[0] == ("init", 0, (1, cluster.obs_dim))
    assert [c for c, _, _ in sched.calls[1:]] == ["init", "after-2",
                                                  "after-3"]
    assert cluster.carry == "after-4"


# ---------------------------------------------------------------------------
# the QoS- and prefix-extended observations and their schedulers
# ---------------------------------------------------------------------------


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_request(r, classes):
    """The port's twin of a reference request: same prompt, demand,
    timing, origin and class (by name)."""
    return Request(rid=r.rid, prompt=np.asarray(r.prompt),
                   max_new_tokens=r.max_new_tokens, arrival_s=r.arrival_s,
                   origin=r.origin, qos=classes[r.qos.name],
                   deadline_s=r.deadline_s, model_pref=r.model_pref)


def _warm_fleets():
    """The reference's fleet (paged qwen2, dense xLSTM, paged starcoder2)
    and the port's on the same weights, each fed the same two requests
    (a shared 16-token prefix) so the paged engines' prefix caches are
    warm, with the same measured token times; plus the rest of the
    trace as (reference, port) request pairs."""
    from repro.serving.builders import build_fleet as jax_build_fleet
    from repro.workload import DEFAULT_MIX as JMIX
    from repro.workload import scaled as jax_scaled
    from repro_torch.serving.builders import build_fleet
    from repro_torch.workload import DEFAULT_MIX, scaled
    kw = dict(kv_slots=2, page_size=8, prefill_chunk=8)
    archs = ["qwen2-1.5b", "xlstm-350m", "starcoder2-3b"]
    jeng = jax_build_fleet(archs, 48, **kw)
    teng = build_fleet(archs, 48, device=CPU, **kw)
    for je, te in zip(jeng, teng):
        te.params = params_from_jax(_np(je.params), te.cfg, CPU)
    jmix = tuple((jax_scaled(c, model_pref="xlstm-350m") if i == 0 else c,
                  w) for i, (c, w) in enumerate(JMIX))
    tmix = tuple((scaled(c, model_pref="xlstm-350m") if i == 0 else c, w)
                 for i, (c, w) in enumerate(DEFAULT_MIX))
    classes = {c.name: c for c, _ in tmix}
    trace = jax_poisson_trace(8, rate=10.0, prompt_len=24,
                              max_new_tokens=4, vocab_size=512,
                              num_origins=3, seed=4, qos_mix=jmix,
                              prefix_len=16, prefix_frac=0.9)
    pairs = [(r, _port_request(r, classes)) for r in trace]
    for jr, tr in pairs[:2]:
        for je, te in ((jeng[0], teng[0]), (jeng[2], teng[2])):
            je.admit(jr)
            je.run_to_completion()
            te.admit(tr)
            te.run_to_completion()
            jr.tokens.clear()
            tr.tokens.clear()
    for i, (je, te) in enumerate(zip(jeng, teng)):
        je._ewma_tok_s = te._ewma_tok_s = 0.01 * (i + 1)
    return jeng, teng, pairs[2:]


@pytest.mark.parametrize("qos,prefix", [(True, False), (False, True),
                                        (True, True)],
                         ids=["qos", "prefix", "qos+prefix"])
def test_observe_rows_match_reference(qos, prefix):
    """``observe`` with the QoS block, the prefix block or both equals
    the reference's row for engines fed the same requests: slack capped
    and scaled, affinity penalised off the preferred arch, expected
    prefix hits from a pure peek (nothing retained, no LRU bump)."""
    jeng, teng, pairs = _warm_fleets()
    if prefix:
        jsched = jax_make_scheduler("prefix-affinity", 3, qos=qos)
        tsched = make_scheduler("prefix-affinity", 3, qos=qos)
    else:
        jsched, tsched = jax_make_scheduler("jsq", 3), make_scheduler(
            "jsq", 3)

    def now():
        return 10.0

    jc = JEdgeCluster(jeng, jsched, clock=now, qos_obs=qos)
    tc = EdgeCluster(teng, tsched, clock=now, qos_obs=qos)
    assert (tc.qos_obs, tc.prefix_obs, tc.obs_dim) == \
        (jc.qos_obs, jc.prefix_obs, jc.obs_dim)
    refs_before = [e._pool.total_refs for e in teng if e.paged]
    hits = []
    for k, (jr, tr) in enumerate(pairs):
        jr.t_arrival = tr.t_arrival = 9.0 - 3.0 * k
        want = np.asarray(jc.observe(jr))
        got = tc.observe(tr).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        if prefix:
            hits.append(got[-3:])
    assert [e._pool.total_refs for e in teng if e.paged] == refs_before
    if prefix:
        hits = np.stack(hits)
        assert hits[:, 0].max() > 0 and hits[:, 2].max() > 0
        assert hits[:, 1].max() == 0            # the dense xLSTM engine
    for je, te in zip(jeng, teng):
        assert te.prefix_evictions == je.prefix_evictions
        assert te.expected_prefix_tokens(pairs[0][1]) == \
            je.expected_prefix_tokens(pairs[0][0])


@pytest.mark.parametrize("name,kw", [
    ("deadline", {}), ("prefix-affinity", {}),
    ("prefix-affinity", {"qos": True}),
    ("prefix-affinity", {"qos": True, "hit_weight": 2.0})],
    ids=["deadline", "prefix", "prefix-qos", "prefix-qos-hit2"])
def test_select_matches_reference(name, kw):
    jsched = jax_make_scheduler(name, 4, **dict(kw))
    tsched = make_scheduler(name, 4, **dict(kw))
    assert tsched.state_dim == jsched.state_dim
    assert getattr(tsched, "prefix_obs", False) == \
        getattr(jsched, "prefix_obs", False)
    rows = np.random.default_rng(len(name) + len(kw)).uniform(
        0, 2, (9, tsched.state_dim)).astype(np.float32)
    want, _ = jsched.select(jsched.init_carry(), jax.numpy.asarray(rows), 0,
                            jax.random.key(0))
    got, _ = tsched.select(tsched.init_carry(), torch.from_numpy(rows), 0,
                           torch.Generator())
    assert got.tolist() == np.asarray(want).tolist()
    for i in range(3):
        assert tsched.select_one(tsched.init_carry(),
                                 torch.from_numpy(rows[i]), i, 0,
                                 torch.Generator())[0] == int(want[i])


class _Engine2(_Engine):
    est_token_seconds = 0.01
    arch_id = "x"

    def expected_prefix_tokens(self, req):
        return 0


def _fixed(base, dim, prefix):
    """A scheduler of ``base``'s class that claims a fixed width."""
    class Fixed(base):
        name = "fixed"
        prefix_obs = prefix

        def __init__(self):
            super().__init__(2)
            self.state_dim = dim

    return Fixed()


@pytest.mark.parametrize("qos,prefix", [(False, False), (True, False),
                                        (False, True), (True, True)],
                         ids=["base", "qos", "prefix", "qos+prefix"])
def test_width_mismatch_errors_match_reference(qos, prefix):
    """A scheduler one column off the cluster's layout is refused at
    construction with the reference's message, for each layout."""
    from repro.cluster import Scheduler as JScheduler
    want_dim = (7 if qos else 4) + (2 if prefix else 0)
    errors = []
    for base, cluster in ((JScheduler, JEdgeCluster),
                          (Scheduler, EdgeCluster)):
        with pytest.raises(ValueError, match="state_dim") as exc:
            cluster([_Engine2(), _Engine2()],
                    _fixed(base, want_dim + 1, prefix), qos_obs=qos)
        errors.append(str(exc.value))
        assert cluster([_Engine2(), _Engine2()],
                       _fixed(base, want_dim, prefix)).obs_dim == want_dim
    assert errors[0] == errors[1]


def test_fault_observation_and_fault_layout_are_accepted():
    """The availability block is ported: a width only it explains turns
    fault observation on; ``faults=``, ``retry=``, ``fault_obs=True``, a
    fault-aware prefix-affinity scheduler and ``failure-aware`` build,
    with the reference's layouts."""
    from repro.cluster import Scheduler as JScheduler
    engines = [_Engine2(), _Engine2()]
    for dim in (2 + 2 + 2, 3 + 4 + 2):    # base + E, QoS + E
        got = EdgeCluster(engines, _fixed(Scheduler, dim, False))
        want = JEdgeCluster(engines, _fixed(JScheduler, dim, False))
        assert (got.fault_obs, got.qos_obs, got.obs_dim) == \
            (want.fault_obs, want.qos_obs, want.obs_dim) == \
            (True, dim == 9, dim)
    for kw in ({"faults": []}, {"retry": RetryPolicy()},
               {"fault_obs": True}):
        c = EdgeCluster(engines, make_scheduler("jsq", 2), **kw)
        assert c.obs_dim == 4 + 2 * (c.fault_obs)
        assert c._watchdog == ("fault_obs" not in kw)
    for name, kw, dim in (("prefix-affinity", {"fault": True}, 8),
                          ("failure-aware", {}, 6),
                          ("failure-aware", {"qos": True}, 9)):
        sched = make_scheduler(name, 2, **kw)
        assert sched.state_dim == dim
        assert EdgeCluster(engines, sched).fault_obs
