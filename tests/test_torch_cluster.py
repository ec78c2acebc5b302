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
from repro_torch.cluster import (EdgeCluster, Request, Scheduler,
                                 make_scheduler, poisson_trace, summarize)
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
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
                              "ladn_denoise": 0}
    out = capsys.readouterr().out
    assert out.count("[serve] req ") == 5 and "[serve] jsq: n=5" in out


@pytest.mark.parametrize("flag", [["--qos"], ["--chaos"],
                                  ["--scheduler", "deadline"]])
def test_serve_main_refuses_what_is_not_ported(flag):
    with pytest.raises(SystemExit, match="not yet ported"):
        serve.main(["--arch", "qwen2-1.5b", "--device", "cpu", *flag])


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
