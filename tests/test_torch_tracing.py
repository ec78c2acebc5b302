"""The port's tracer: spans along the serving path.

A tiny paged pair of qwen2-1.5b engines (reduced, on the CPU) behind
LAD-TS serves a few prompts of several chunks; the spans it leaves are
held to the engines' own counters and to each other.  No JAX:
the tracer has no reference module."""
import numpy as np
import pytest
import torch

from _torch_parity import FakeClock, tokens_of
from repro_torch import tracing
from repro_torch.cluster import EdgeCluster, PolicyScheduler, Request
from repro_torch.core import agents
from repro_torch.core.diffusion import DiffusionPolicyConfig
from repro_torch.serving.builders import build_engines
from repro_torch.serving.engine import ServeEngine

CHUNK = 8
# each span's parent, by name
PARENT = {"engine.dispatch": "cluster.step",
          "engine.collect": "cluster.step",
          "engine.admission": "engine.dispatch",
          "engine.prefill_chunk": "engine.dispatch",
          "engine.decode_round": "engine.dispatch",
          "engine.collect_wait": "engine.collect"}
TOPS = {"scheduler.select", "cluster.step"}


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _lad_ts(engines: int) -> PolicyScheduler:
    acfg = agents.AgentConfig(
        hidden=(20, 20), train_after=40, replay_capacity=200,
        diffusion=DiffusionPolicyConfig(num_steps=3))
    state = agents.ladts_init(torch.Generator().manual_seed(0), acfg,
                              2 + engines, engines, 6, engines)
    return PolicyScheduler("lad-ts", acfg, state, num_engines=engines,
                           n_max=6)


def _cluster(arch="qwen2-1.5b", num_pages=None, **kw):
    """Two engines of ``arch``; ``num_pages`` rebuilds them on a pool of
    that many pages."""
    engines = build_engines(arch, 2, 48, device="cpu", **kw)
    if num_pages is not None:
        engines = [ServeEngine(e.cfg, e.params, max_len=48,
                               num_pages=num_pages, device="cpu", **kw)
                   for e in engines]
    for e in engines:
        e._clock = FakeClock()
    return EdgeCluster(engines, _lad_ts(2), seed=3, clock=FakeClock())


def _requests(n=7, seed=1):
    rng = np.random.default_rng(seed)
    lens = [3, 8, 9, 17, 24, 30, 12, 5][:n]
    return [Request(rid=r, prompt=rng.integers(0, 512, (1, lens[r]),
                                              dtype=np.int32),
                    max_new_tokens=int(rng.integers(2, 6)), origin=r % 2)
            for r in range(n)]


def _serve(cluster, reqs):
    """Submit in two bursts, step until every request finished."""
    for r in reqs[:5]:
        cluster.submit(r)
    cluster.step()
    for r in reqs[5:]:
        cluster.submit(r)
    while cluster.busy:
        cluster.step()
    assert all(r.status == "ok" for r in reqs)


PAGED = dict(kv_slots=2, page_size=8, prefill_chunk=CHUNK)


def _traced_run(**kw):
    cluster = _cluster(**{**PAGED, **kw})
    reqs = _requests()
    before = [(e.prefills, e.decode_rounds) for e in cluster.engines]
    tracing.enable()
    _serve(cluster, reqs)
    tracing.disable()
    return cluster, reqs, before, tracing.drain()


def _named(rec, name, engine=None):
    return [s for s in rec if s["name"] == name
            and (engine is None or s["attrs"].get("engine") == engine)]


def test_off_records_nothing():
    assert tracing.span("x", rid=1) is tracing.span("y")
    with tracing.span("engine.dispatch", engine=0) as sp:
        pass
    assert sp is None
    cluster = _cluster(**PAGED)
    _serve(cluster, _requests())
    assert tracing.drain() == []


def test_greedy_tokens_equal_on_and_off():
    off = _requests()
    _serve(_cluster(**PAGED), off)
    _, on, _, rec = _traced_run()
    assert rec
    for a, b in zip(off, on):
        assert (a.engine_id, len(a.tokens)) == (b.engine_id, len(b.tokens))
        np.testing.assert_array_equal(tokens_of(a), tokens_of(b))


def test_children_lie_inside_their_parents():
    _, reqs, _, rec = _traced_run()
    by_id = {s["id"]: s for s in rec}
    assert set(PARENT) | TOPS == {s["name"] for s in rec}
    for s in rec:
        assert s["start_ns"] <= s["end_ns"]
        if s["name"] in TOPS:
            assert s["parent"] is None
            continue
        p = by_id[s["parent"]]
        assert p["name"] == PARENT[s["name"]], s
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
        for key in ("rid", "engine"):
            if key in s["attrs"] and key in p["attrs"]:
                assert s["attrs"][key] == p["attrs"][key]
    # one decision per request, each naming its request
    selects = _named(rec, "scheduler.select")
    assert [s["attrs"]["rid"] for s in selects] == [r.rid for r in reqs]


def test_prefill_chunks_match_the_engines_counters():
    cluster, reqs, before, rec = _traced_run()
    for e, (prefills, _) in zip(cluster.engines, before):
        chunks = _named(rec, "engine.prefill_chunk", e.engine_id)
        assert len(chunks) == e.prefills - prefills > 0
        assert all(c["attrs"]["tokens"] + c["attrs"]["padded"] == CHUNK
                   for c in chunks)
    # each prompt's chunks cover it once, in order
    for r in reqs:
        mine = [c["attrs"] for c in _named(rec, "engine.prefill_chunk")
                if c["attrs"]["rid"] == r.rid]
        assert [c["start"] for c in mine] == \
            list(range(0, r.prompt.shape[-1], CHUNK))
        assert sum(c["tokens"] for c in mine) == r.prompt.shape[-1]


def test_decode_rounds_match_the_engines_counters():
    cluster, _, before, rec = _traced_run()
    for e, (_, rounds) in zip(cluster.engines, before):
        spans = _named(rec, "engine.decode_round", e.engine_id)
        assert len(spans) == e.decode_rounds - rounds > 0


@pytest.mark.parametrize("num_pages", [None, 6],
                         ids=["lane-bound", "page-bound"])
def test_admission_spans_say_why_it_stopped(num_pages):
    cluster, _, _, rec = _traced_run(max_lanes=2, num_pages=num_pages)
    for e in cluster.engines:
        adm = [s["attrs"] for s in _named(rec, "engine.admission",
                                          e.engine_id)]
        assert adm and all(0 <= a["held"] <= a["lanes"] == 2 for a in adm)
        # the most lanes held after an admission is the engine's peak
        assert max(a["held"] for a in adm) == e.peak_inflight
    stops = {s["attrs"]["stop"] for s in _named(rec, "engine.admission")}
    assert stops <= {"empty", "lanes", "pages"}
    assert "lanes" in stops
    assert ("pages" in stops) == (num_pages is not None)


def test_dense_path_has_only_the_outer_spans():
    """A dense pool has no admission, chunk or round spans: its dispatch
    and collect still nest under the step."""
    cluster = _cluster("recurrentgemma-9b", kv_slots=2)
    reqs = _requests(4)
    tracing.enable()
    _serve(cluster, reqs)
    tracing.disable()
    rec = tracing.drain()
    assert {s["name"] for s in rec} == {
        "scheduler.select", "cluster.step", "engine.dispatch",
        "engine.collect", "engine.collect_wait"}
    steps = {s["id"] for s in _named(rec, "cluster.step")}
    assert all(s["parent"] in steps for s in _named(rec, "engine.dispatch"))
    assert len(_named(rec, "scheduler.select")) == len(reqs)


def test_spans_appear_as_ranges_in_the_profiler():
    cluster = _cluster(**PAGED)
    reqs = _requests()
    tracing.enable()
    for r in reqs[:3]:
        cluster.submit(r)
    cluster.step()
    tracing.drain()                      # spans before the profiler
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for r in reqs[3:]:
            cluster.submit(r)
        for _ in range(3):
            cluster.step()
    inside = tracing.drain()
    while cluster.busy:
        cluster.step()
    tracing.disable()
    ranges = [e.name for e in prof.events()
              if e.name.startswith(tracing.PREFIX)]
    want = sorted(tracing.PREFIX + s["name"] for s in inside)
    assert want and sorted(ranges) == want
