"""Port fault layer against the JAX one: the injector's schedules, the
retry policy, the engines' crash / recovery / degradation, and the live
cluster's retries, watchdog, quarantine, availability observation and
failure-aware placement, on the same inputs.  Reduced qwen2-1.5b, 2
layers, f32, greedy decoding; clocks are injected, never slept on."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import CPU, FakeClock, configs, params_pair, tokens_of
from repro.cluster import EdgeCluster as JEdgeCluster
from repro.cluster import make_scheduler as jax_make_scheduler
from repro.cluster import poisson_trace as jax_poisson_trace
from repro.cluster import summarize as jax_summarize
from repro.cluster.request import Request as JRequest
from repro.faults import FaultEvent as JFaultEvent
from repro.faults import FaultInjector as JFaultInjector
from repro.faults import FaultSpec as JFaultSpec
from repro.faults import RetryPolicy as JRetryPolicy
from repro.faults import single_crash as jax_single_crash
from repro.serving.engine import ServeEngine as JServeEngine
from repro.workload import BEST_EFFORT as J_BEST_EFFORT
from repro.workload import INTERACTIVE as J_INTERACTIVE
from repro.workload import STANDARD as J_STANDARD
from repro_torch.cluster import (EdgeCluster, Request, make_scheduler,
                                 poisson_trace, summarize)
from repro_torch.faults import (FaultEvent, FaultInjector, FaultSpec,
                                Health, RetryPolicy, single_crash)
from repro_torch.serving.engine import ServeEngine
from repro_torch.workload import BEST_EFFORT, INTERACTIVE, STANDARD

QOS = {"interactive": (J_INTERACTIVE, INTERACTIVE),
       "standard": (J_STANDARD, STANDARD),
       "batch": (J_BEST_EFFORT, BEST_EFFORT)}


class ManualClock:
    """A clock the test sets; reading it does not advance it."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _engine_pair(paged, seed=0, clocks=None, **kw):
    """The reference's engine and the port's on the same weights."""
    jcfg, tcfg = configs(num_layers=2)
    jparams, tparams = params_pair(jcfg, tcfg, seed=seed)
    kw = {"max_len": 40, "kv_slots": 2, **kw}
    jclock, tclock = clocks or (FakeClock(), FakeClock())
    je = JServeEngine(jcfg, jparams, paged=paged, clock=jclock, **kw)
    te = ServeEngine(tcfg, tparams, paged=paged, clock=tclock, device=CPU,
                     **kw)
    return je, te


def _pair(rid, prompt, tokens=4, qos=None, deadline_s=None,
          arrival_s=0.0):
    """(reference request, port request) with the same fields; ``qos``
    is a class name."""
    jq, tq = QOS[qos] if qos else (None, None)
    return (JRequest(rid=rid, prompt=prompt, max_new_tokens=tokens,
                     qos=jq, deadline_s=deadline_s, arrival_s=arrival_s),
            Request(rid=rid, prompt=prompt, max_new_tokens=tokens, qos=tq,
                    deadline_s=deadline_s, arrival_s=arrival_s))


def _prompts(n, S, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (n, S),
                                                dtype=np.int32)


def _rids(reqs):
    return [r.rid for r in reqs]


# ---------------------------------------------------------------------------
# injector and retry policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,E,horizon,seed", [
    (dict(crashes=2, stalls=1, slowdowns=1), 4, 10.0, 7),
    (dict(crashes=2, stalls=1, slowdowns=1), 4, 10.0, 8),
    (dict(crashes=1, slowdowns=1), 2, 4.0, 0),
    (dict(crashes=3, stalls=2, slowdowns=0, downtime_frac=0.1,
          slow_factor=5), 3, 2.5, 11),
    (dict(crashes=0, stalls=3, slowdowns=2, stall_frac=0.2), 5, 60.0, 3)],
    ids=["mixed-seed7", "mixed-seed8", "serve", "crashes", "soft"])
def test_fault_schedule_matches_reference_bit_for_bit(spec, E, horizon,
                                                      seed):
    """Same (spec, seed, horizon) -> the reference's schedule exactly;
    every finite crash or slowdown gets its recover event."""
    want = JFaultInjector.from_spec(JFaultSpec(**spec), E,
                                    horizon_s=horizon, seed=seed).describe()
    inj = FaultInjector.from_spec(FaultSpec(**spec), E, horizon_s=horizon,
                                  seed=seed)
    assert inj.describe() == want
    assert FaultInjector.from_spec(FaultSpec(**spec), E, horizon_s=horizon,
                                   seed=seed + 1).describe() != want
    kinds = [e["kind"] for e in want]
    assert kinds.count("recover") == (spec.get("crashes", 1)
                                      + spec.get("slowdowns", 0))


def test_injector_fires_each_event_once_and_replays():
    got, want = [], []
    for mk, out in ((single_crash, got), (jax_single_crash, want)):
        inj = mk(engine=1, t_s=1.0, downtime_s=2.0, num_engines=2)
        for now in (0.5, 1.5, 1.5, 10.0):
            out.append([e.kind for e in inj.due(now)])
        out.append(inj.exhausted)
        inj.reset()
        out.append(inj.exhausted)
        out.append([e.kind for e in inj.due(10.0)])
    assert got == want
    assert got == [[], ["crash"], [], ["recover"], True, False,
                   ["crash", "recover"]]


@pytest.mark.parametrize("bad", [
    dict(t_s=1.0, engine=0, kind="meltdown"),
    dict(t_s=-1.0, engine=0, kind="crash"),
    dict(t_s=1.0, engine=0, kind="stall", duration_s=0.0),
    dict(t_s=1.0, engine=0, kind="slowdown", factor=0)],
    ids=["kind", "time", "duration", "factor"])
def test_injector_rejects_bad_events(bad):
    for cls in (JFaultEvent, FaultEvent):
        with pytest.raises(ValueError):
            cls(**bad)


def test_injector_rejects_an_engine_out_of_range():
    for ev, inj in ((JFaultEvent, JFaultInjector), (FaultEvent,
                                                    FaultInjector)):
        with pytest.raises(ValueError, match="cluster has 2") as exc:
            inj([ev(t_s=0.0, engine=5, kind="crash")], num_engines=2)
        assert "targets engine 5" in str(exc.value)


def test_retry_policy_backoff_and_watchdog_match_reference():
    kw = dict(max_attempts=4, backoff_base_s=0.1, backoff_factor=2.0,
              deadline_grace=2.0, best_effort_timeout_s=5.0)
    jp, tp = JRetryPolicy(**kw), RetryPolicy(**kw)
    assert [tp.backoff_s(a) for a in range(6)] == \
        [jp.backoff_s(a) for a in range(6)]
    assert tp.backoff_s(3) == pytest.approx(0.4)
    assert RetryPolicy().backoff_s(2) == JRetryPolicy().backoff_s(2)
    for budget in (1.0, None):
        jr, tr = _pair(0, None, 1, deadline_s=budget)
        jr.t_arrival = tr.t_arrival = 100.0
        for now in np.linspace(99.0, 107.0, 33):
            assert tp.hopeless(tr, now) == jp.hopeless(jr, now)
        if budget:      # past grace x budget
            assert tp.hopeless(tr, 102.1) and not tp.hopeless(tr, 101.9)
        else:           # the flat best-effort timeout
            assert tp.hopeless(tr, 105.1) and not tp.hopeless(tr, 104.0)
    # no arrival stamp and no enqueue: never hopeless
    assert not tp.hopeless(_pair(1, None)[1], 1e9)


@pytest.mark.parametrize("bad", [dict(max_attempts=0),
                                 dict(backoff_base_s=-0.1),
                                 dict(backoff_factor=0.5),
                                 dict(deadline_grace=0.9)],
                         ids=["attempts", "base", "factor", "grace"])
def test_retry_policy_validation_matches_reference(bad):
    for cls in (JRetryPolicy, RetryPolicy):
        with pytest.raises(ValueError):
            cls(**bad)


# ---------------------------------------------------------------------------
# engine health: crashes reclaim KV, degraded modes, shedding
# ---------------------------------------------------------------------------


def _retry_on(engines, orphans):
    """Recover each engine and re-admit its orphans (reset first)."""
    for e, reqs in zip(engines, orphans):
        e.recover()
        for r in reqs:
            r.reset_for_retry()
            e.admit(r)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_crash_mid_prefill_and_mid_decode_matches_reference(paged):
    """A crash after the first step (paged: mid-prefill), after several
    decode rounds, and with a dispatched round not yet collected: the
    same orphans in the same order as the reference, no KV left held;
    the retried requests then give the reference's greedy tokens."""
    kw = {"prefill_chunk": 4} if paged else {}
    je, te = _engine_pair(paged, **kw)
    prompts = _prompts(2, 12)
    pairs = [_pair(i, prompts[i:i + 1], tokens=8) for i in range(2)]
    for jr, tr in pairs:
        je.admit(jr)
        te.admit(tr)
    for steps in (1, 4):
        for _ in range(steps):
            je.step()
            te.step()
        assert te.kv_leak == je.kv_leak > 0
        jo, to = je.fail("test crash"), te.fail("test crash")
        assert _rids(to) == _rids(jo) and sorted(_rids(to)) == [0, 1]
        assert te.kv_leak == je.kv_leak == 0
        assert te.health is Health.DOWN and te.fail_reason == "test crash"
        _retry_on((je, te), (jo, to))
    # a round dispatched and then dropped by the crash
    assert je.dispatch() and te.dispatch()
    jo, to = je.fail("pending"), te.fail("pending")
    assert _rids(to) == _rids(jo) and len(to) == 2
    assert te._pending is None and te.collect() == []
    assert te.kv_leak == je.kv_leak == 0
    _retry_on((je, te), (jo, to))
    jdone, tdone = je.run_to_completion(), te.run_to_completion()
    assert _rids(tdone) == _rids(jdone) and sorted(_rids(tdone)) == [0, 1]
    for jr, tr in pairs:
        assert tr.status == jr.status == "ok" and len(tr.tokens) == 8
        np.testing.assert_array_equal(tokens_of(tr), tokens_of(jr))
    assert te.kv_leak == je.kv_leak == 0


def test_crash_on_a_shared_prefix_keeps_the_reference_refcounts():
    """A crash mid-prefill on a lane that shares a cached prefix drops
    only that lane's references: the cached pages stay, the pool holds
    one reference per cache entry, and the retry hits the cache again."""
    je, te = _engine_pair(True, max_len=64, page_size=8, prefill_chunk=8)
    prompt = _prompts(1, 24, seed=42)
    for e in (je, te):
        assert len(e.generate(prompt, 2).tokens) == 2
    assert te.prefix_cached_pages == je.prefix_cached_pages == 3
    jr, tr = _pair(1, prompt, tokens=4)
    je.admit(jr)
    te.admit(tr)
    je.step()
    te.step()
    assert tr.prefix_tokens == jr.prefix_tokens == 23
    assert te.kv_leak == je.kv_leak > 0
    assert te.fail("crash") == [tr] and je.fail("crash") == [jr]
    assert te.kv_leak == je.kv_leak == 0
    assert te.prefix_cached_pages == 3
    assert te._pool.total_refs == je._pool.total_refs == 3
    saved0 = te.prefill_tokens_saved
    _retry_on((je, te), ([jr], [tr]))
    assert _rids(te.run_to_completion()) == _rids(je.run_to_completion()) \
        == [1]
    assert te.prefill_tokens_saved == saved0 + 23
    np.testing.assert_array_equal(tokens_of(tr), tokens_of(jr))
    assert te.kv_leak == je.kv_leak == 0


def test_down_engine_refuses_admission_and_degraded_gating_matches():
    """DOWN refuses admission with the reference's message; a stall
    freezes dispatch until its window ends and then heals; a slowdown of
    3 lets one dispatch in three through until ``recover``: the same
    True/False sequence as the reference."""
    clocks = (ManualClock(), ManualClock())
    je, te = _engine_pair(False, kv_slots=1, clocks=clocks)
    prompt = _prompts(1, 8)
    msgs = []
    for e, r in zip((je, te), _pair(0, prompt, tokens=2)):
        e.fail("boom")
        with pytest.raises(RuntimeError, match="DOWN") as exc:
            e.admit(r)
        msgs.append(str(exc.value))
        assert e.availability == 0.0 and not e.available
        with pytest.raises(RuntimeError, match="DOWN"):
            e.degrade(stall_s=1.0)
        e.recover()
        assert e.health.value == "healthy" and e.availability == 1.0
    assert msgs[0] == msgs[1]
    seqs = []
    for e, clock, (r1, r2) in zip((je, te), clocks,
                                  zip(_pair(1, prompt, tokens=1),
                                      _pair(2, prompt, tokens=12))):
        e.degrade(stall_s=5.0)
        assert e.availability == 0.5 and e.available
        e.admit(r1)
        assert e.step() == []                       # frozen
        clock.t = 6.0
        assert _rids(e.run_to_completion()) == [1]
        assert e.health.value == "healthy"          # healed by itself
        e.degrade(slow_every=3)
        e.admit(r2)
        seq = []
        for _ in range(9):
            seq.append(e.dispatch())
            e.collect()
        e.recover()
        seq.append(e.dispatch())
        e.collect()
        seqs.append(seq)
        e.run_to_completion()
        assert e.kv_leak == 0
    assert seqs[0] == seqs[1]
    assert seqs[1] == [False, False, True] * 3 + [True]


def test_orphans_reenter_the_edf_queue_in_the_reference_order():
    """Orphans of a crash re-enter another engine's EDF queue and drain
    by (priority desc, deadline asc), whatever order the crash gave."""
    ja, ta = _engine_pair(False, kv_slots=1, seed=0)
    jb, tb = _engine_pair(False, kv_slots=1, seed=1)
    p = _prompts(1, 8)
    spec = [("batch", None), ("interactive", 2.0), ("standard", 6.0),
            ("interactive", 1.0)]
    pairs = [_pair(i, p, qos=q, deadline_s=d)
             for i, (q, d) in enumerate(spec)]
    orders = []
    for a, b, reqs in ((ja, jb, [j for j, _ in pairs]),
                       (ta, tb, [t for _, t in pairs])):
        for r in reqs:
            a.admit(r)
        orphans = a.fail("crash")
        assert len(orphans) == 4
        for r in orphans:
            r.reset_for_retry()
            b.admit(r)
        order = []
        while b._queue:
            order.append(b._queue.popleft().rid)
        orders.append(order)
    assert orders[1] == orders[0] == [3, 1, 2, 0]


def test_shed_drains_matching_queued_requests_only():
    _, te = _engine_pair(False, kv_slots=1)
    p = _prompts(1, 8)
    for i, q in enumerate(["batch", "interactive", "batch"]):
        te.admit(_pair(i, p, qos=q, deadline_s=None if q == "batch"
                       else 1.0)[1])
    te.dispatch()                     # request 1 takes the slot
    te.collect()
    shed = te.shed(lambda r: r.qos is BEST_EFFORT)
    assert sorted(_rids(shed)) == [0, 2] and not te._queue
    assert te._inflight_requests()[0].rid == 1


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_cuda_fail_with_a_round_pending_leaks_no_kv(paged):
    """On the card: a crash with a dispatched round not yet collected
    (its kernels enqueued) drops the round, orphans both requests and
    holds no KV; after recovery the retried requests give the tokens an
    uncrashed engine gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models.transformer import init_params
    _, cfg = configs(num_layers=2)
    dev = torch.device("cuda")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    kw = dict(max_len=40, kv_slots=2, paged=paged, device=dev)
    if paged:
        kw["prefill_chunk"] = 4
    crashed = ServeEngine(cfg, params, **kw)
    clean = ServeEngine(cfg, params, **kw)
    prompts = _prompts(2, 12)
    reqs = [[Request(rid=i, prompt=prompts[i:i + 1], max_new_tokens=6)
             for i in range(2)] for _ in range(2)]
    for e, rs in ((crashed, reqs[0]), (clean, reqs[1])):
        for r in rs:
            e.admit(r)
    for _ in range(3):
        crashed.step()
    assert crashed.dispatch() and crashed.pending_collect
    orphans = crashed.fail("pending round")
    torch.cuda.synchronize()
    assert sorted(_rids(orphans)) == [0, 1] and crashed.kv_leak == 0
    _retry_on([crashed], [orphans])
    crashed.run_to_completion()
    clean.run_to_completion()
    torch.cuda.synchronize()
    for a, b in zip(*reqs):
        assert a.status == b.status == "ok"
        np.testing.assert_array_equal(tokens_of(a), tokens_of(b))
    assert crashed.kv_leak == clean.kv_leak == 0


# ---------------------------------------------------------------------------
# cluster: crash recovery, retries, watchdog, quarantine
# ---------------------------------------------------------------------------


def _cluster_pair(name, clock_pair, faults=None, retry=None, **kw):
    """A paged and a dense engine behind the reference's cluster and the
    port's, each package on its own manual clock (engines included)."""
    jp, tp = _engine_pair(True, seed=0, clocks=clock_pair, page_size=8,
                          prefill_chunk=8)
    jd, td = _engine_pair(False, seed=1, clocks=clock_pair)
    jfaults = tfaults = None
    if faults is not None:
        jfaults = [JFaultEvent(**ev) for ev in faults]
        tfaults = [FaultEvent(**ev) for ev in faults]
    jc = JEdgeCluster([jp, jd], jax_make_scheduler(name, 2, **kw),
                      clock=clock_pair[0], faults=jfaults,
                      retry=retry and JRetryPolicy(**retry))
    tc = EdgeCluster([tp, td], make_scheduler(name, 2, **kw),
                     clock=clock_pair[1], faults=tfaults,
                     retry=retry and RetryPolicy(**retry))
    return jc, tc


CHAOS = [dict(t_s=0.03, engine=0, kind="crash", duration_s=0.1),
         dict(t_s=0.04, engine=1, kind="slowdown", duration_s=0.05,
              factor=2),
         dict(t_s=0.25, engine=1, kind="stall", duration_s=0.03)]
STEP_S = 0.005      # lockstep clock advance per cluster step


@pytest.mark.parametrize("name,kw", [("failure-aware", {}),
                                     ("failure-aware", {"qos": True}),
                                     ("jsq", {}), ("round-robin", {}),
                                     ("deadline", {})],
                         ids=["failure-aware", "failure-aware-qos", "jsq",
                              "round-robin", "deadline"])
def test_cluster_crash_and_recovery_match_reference(name, kw):
    """A crash, a slowdown and a stall mid-trace, both clusters stepped in
    lockstep on the same clock: the same placements, terminal order,
    statuses, attempts, fault counters and greedy tokens; every request
    completes exactly once and no KV is left held."""
    clocks = (ManualClock(), ManualClock())
    jc, tc = _cluster_pair(name, clocks, faults=CHAOS, retry={}, **kw)
    trace = jax_poisson_trace(10, rate=300.0, prompt_len=8,
                              max_new_tokens=8, vocab_size=512,
                              num_origins=2, seed=5)
    pairs = [(r, Request(rid=r.rid, prompt=np.asarray(r.prompt),
                         max_new_tokens=r.max_new_tokens,
                         arrival_s=r.arrival_s, origin=r.origin))
             for r in trace]
    placed, ended, i = [], ([], []), 0
    for k in range(1000):
        clocks[0].t = clocks[1].t = STEP_S * k
        while i < len(pairs) and pairs[i][0].arrival_s <= STEP_S * k:
            for r in pairs[i]:
                r.t_arrival = r.arrival_s
            placed.append((jc.submit(pairs[i][0]), tc.submit(pairs[i][1])))
            i += 1
        ended[0].extend(_rids(jc.step()))
        ended[1].extend(_rids(tc.step()))
        if i == len(pairs) and not (jc.busy or tc.busy) and \
                jc.injector.exhausted and tc.injector.exhausted:
            break
    assert [b for _, b in placed] == [a for a, _ in placed]
    assert ended[1] == ended[0] and sorted(ended[1]) == list(range(10))
    jfs, tfs = dict(jc.fault_stats), dict(tc.fault_stats)
    assert tfs == jfs and tfs["injected"] == 5 and tfs["orphaned"] > 0
    assert tfs["retries"] >= 1 and tfs["quarantined"] == 0
    for jr, tr in pairs:
        assert (tr.status, tr.attempts, tr.engine_id) == \
            (jr.status, jr.attempts, jr.engine_id)
        assert tr.status == "ok" and len(tr.tokens) == tr.max_new_tokens
        np.testing.assert_array_equal(tokens_of(tr), tokens_of(jr))
    assert summarize([t for _, t in pairs])["completion_rate"] == 1.0
    assert [e.kv_leak for e in tc.engines] == [0, 0]


def test_run_recovers_from_a_crash_with_real_arrivals():
    """``run`` on the wall clock: a mid-trace crash and recovery, each
    request terminal exactly once, whole token streams, attempts within
    the cap, no KV held."""
    _, tp = _engine_pair(True, seed=0, page_size=8, prefill_chunk=8)
    _, td = _engine_pair(False, seed=1)
    cluster = EdgeCluster([tp, td], make_scheduler("jsq", 2),
                          faults=single_crash(engine=0, t_s=0.02,
                                              downtime_s=0.2,
                                              num_engines=2),
                          retry=RetryPolicy())
    trace = poisson_trace(10, rate=100.0, prompt_len=8, max_new_tokens=4,
                          vocab_size=512, num_origins=2, seed=5)
    done = cluster.run(trace)
    assert sorted(_rids(done)) == list(range(10))
    st = summarize(done)
    assert st["completion_rate"] == 1.0 and st["completed"] == 10
    for r in done:
        assert r.status == "ok" and len(r.tokens) == r.max_new_tokens
        assert 1 <= r.attempts <= cluster.retry.max_attempts
    assert [e.kv_leak for e in cluster.engines] == [0, 0]
    assert cluster.fault_stats["injected"] == 2 and cluster.injector.exhausted
    assert len(cluster.fault_stats["orphan_recovery_s"]) == \
        cluster.fault_stats["retries"]


def test_run_parks_arrivals_through_a_total_outage():
    """Both engines crash while the first request is served: it is
    retried, the arrivals during the outage are parked (no attempt
    spent) and placed once the engines recover.  The cluster runs on a
    fake clock (a millisecond a read), so the timing is the same on any
    host."""
    _, tp = _engine_pair(True, seed=0, page_size=8, prefill_chunk=8)
    _, td = _engine_pair(False, seed=1)
    down = [FaultEvent(t_s=0.001, engine=e, kind="crash", duration_s=0.05)
            for e in (0, 1)]
    cluster = EdgeCluster([tp, td], make_scheduler("failure-aware", 2),
                          faults=down, retry=RetryPolicy(),
                          clock=FakeClock())
    assert cluster.fault_obs and cluster.obs_dim == 6
    parked, park = [], cluster._park
    cluster._park = lambda r, ready: (parked.append(r.rid), park(r, ready))
    trace = poisson_trace(3, rate=1000.0, prompt_len=8, max_new_tokens=3,
                          vocab_size=512, num_origins=2, seed=1)
    for r, t in zip(trace, (0.0, 0.02, 0.03)):
        r.arrival_s = t
    done = cluster.run(trace)
    assert sorted(_rids(done)) == [0, 1, 2] and parked == [1, 2]
    assert all(r.status == "ok" for r in done)
    assert [r.attempts for r in sorted(done, key=lambda r: r.rid)] == \
        [2, 1, 1]
    assert cluster.fault_stats["injected"] == 4
    assert cluster.fault_stats["orphaned"] == 1


def test_total_outage_raises_like_the_reference():
    clocks = (ManualClock(), ManualClock())
    jc, tc = _cluster_pair("jsq", clocks)
    msgs = []
    for c, r in zip((jc, tc), _pair(0, _prompts(1, 8), tokens=2)):
        for e in c.engines:
            e.fail("both down")
        with pytest.raises(RuntimeError, match="all 2 engines are DOWN") \
                as exc:
            c.submit(r)
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0]


@pytest.mark.parametrize("overlap,where", [(True, "dispatch"),
                                           (True, "collect"),
                                           (False, "step")])
def test_cluster_quarantines_a_raising_engine(monkeypatch, overlap, where):
    """A Python exception escaping one engine marks it DOWN and
    re-offloads its requests; the other engine serves them all."""
    _, t0 = _engine_pair(False, seed=0)
    _, t1 = _engine_pair(False, seed=1)
    cluster = EdgeCluster([t0, t1], make_scheduler("round-robin", 2),
                          retry=RetryPolicy(), overlap=overlap,
                          clock=FakeClock())

    def explode():
        raise RuntimeError("synthetic engine fault")

    monkeypatch.setattr(t0, where, explode)
    trace = poisson_trace(6, rate=200.0, prompt_len=8, max_new_tokens=3,
                          vocab_size=512, num_origins=2, seed=2)
    done = cluster.run(trace)
    assert t0.health is Health.DOWN and "quarantined" in t0.fail_reason
    assert "synthetic engine fault" in t0.fail_reason
    assert cluster.fault_stats["quarantined"] == 1
    assert summarize(done)["completion_rate"] == 1.0 and len(done) == 6
    assert all(r.status == "ok" and r.engine_id == 1 for r in done)
    assert t0.kv_leak == t1.kv_leak == 0


@pytest.mark.parametrize("overlap", [True, False],
                         ids=["overlap", "serial"])
@pytest.mark.parametrize("fault", ["kernel", "cuda"])
def test_kernel_and_card_faults_are_not_quarantined(monkeypatch, overlap,
                                                    fault):
    """A fault raised inside ``repro_torch.kernels`` (here the attention
    plain version, reached through its ``ops`` wrapper in every prefill)
    or a CUDA error is not absorbed by quarantine: it fails the run."""
    from repro_torch.cluster.live import kernel_fault
    from repro_torch.kernels import ref
    _, tp = _engine_pair(True, seed=0, page_size=8, prefill_chunk=8)
    _, td = _engine_pair(False, seed=1)
    cluster = EdgeCluster([tp, td], make_scheduler("round-robin", 2),
                          retry=RetryPolicy(), overlap=overlap,
                          clock=FakeClock())
    if fault == "kernel":
        def broken(*args, **kw):
            raise RuntimeError("flash_attention launch failed")
        monkeypatch.setattr(ref, "attention_ref", broken)
    else:
        def broken():
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        monkeypatch.setattr(tp, "step" if not overlap else "dispatch",
                            broken)
    trace = poisson_trace(4, rate=200.0, prompt_len=8, max_new_tokens=3,
                          vocab_size=512, num_origins=2, seed=2)
    with pytest.raises(RuntimeError) as exc:
        cluster.run(trace)
    assert kernel_fault(exc.value)
    assert cluster.fault_stats["quarantined"] == 0
    assert tp.health is Health.HEALTHY
    assert not kernel_fault(RuntimeError("synthetic engine fault"))


def test_watchdog_abandons_without_counting_delay():
    """An overdue request in the retry queue is abandoned (no t_finish),
    never enters the delay percentiles, and counts as shed, not failed;
    the summaries equal the reference's."""
    clocks = (ManualClock(100.0), ManualClock(100.0))
    jc, tc = _cluster_pair("jsq", clocks, retry=dict(
        best_effort_timeout_s=0.001, deadline_grace=1.0))
    sums = []
    for c, r in zip((jc, tc), _pair(0, _prompts(1, 8), tokens=2)):
        r.t_arrival = 90.0
        c._park(r, 99.0)
        assert [x.status for x in c.step()] == ["abandoned"]
        assert r.t_finish is None and "watchdog" in r.fail_reason
        assert c.fault_stats["abandoned"] == 1
        sums.append((jax_summarize if c is jc else summarize)([r]))
    assert sums[1] == sums[0]
    assert sums[1]["abandoned"] == 1 and sums[1]["count"] == 0
    assert sums[1]["p99_s"] == 0.0 and sums[1]["completion_rate"] == 1.0


def test_watchdog_sheds_hopeless_queued_requests():
    clocks = (ManualClock(50.0), ManualClock(50.0))
    jc, tc = _cluster_pair("jsq", clocks, retry=dict(deadline_grace=1.0))
    shed = []
    for c, (r0, r1) in zip((jc, tc), zip(
            _pair(0, _prompts(1, 8), tokens=2, deadline_s=1.0),
            _pair(1, _prompts(1, 8), tokens=2))):
        r0.t_arrival = r1.t_arrival = 40.0
        c.engines[1].admit(r0)          # 10 s into a 1 s budget
        c.engines[1].admit(r1)          # best effort, 30 s timeout
        out = c._shed_hopeless(50.0)
        shed.append((_rids(out), [r.fail_reason for r in out],
                     c.fault_stats["abandoned"]))
    assert shed[1] == shed[0] and shed[1][0] == [0]


def test_retries_exhausted_marks_failed():
    clocks = (ManualClock(), ManualClock())
    jc, tc = _cluster_pair("jsq", clocks, retry=dict(max_attempts=2))
    for c, r in zip((jc, tc), _pair(0, _prompts(1, 8), tokens=2)):
        r.t_arrival = 0.0
        r.attempts = 2                      # already placed twice
        assert c._requeue(r, 0.0) == [r] and r.status == "failed"
        assert r.fail_reason == "retries exhausted (2 attempts)"
        assert c.fault_stats["failed"] == 1


def test_fault_free_cluster_has_no_watchdog_effects():
    """Without faults= or retry= the watchdog never sheds: the cluster
    behaves as one without the fault layer."""
    clocks = (ManualClock(), ManualClock())
    jc, tc = _cluster_pair("jsq", clocks)
    for c, r in zip((jc, tc), _pair(0, _prompts(1, 8), tokens=2,
                                    deadline_s=1e-9)):
        assert not c._watchdog and not c.fault_obs
        r.t_arrival = -100.0                # hopeless by any watchdog
        c.engines[0].admit(r)
        assert c._shed_hopeless(0.0) == []
        assert r.status == "pending"


# ---------------------------------------------------------------------------
# failure-aware placement and the availability observation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("failure-aware", {}), ("failure-aware", {"qos": True}),
    ("prefix-affinity", {"fault": True}),
    ("prefix-affinity", {"fault": True, "qos": True})],
    ids=["fa", "fa-qos", "prefix-fault", "prefix-fault-qos"])
def test_failure_aware_picks_match_reference(name, kw):
    """Random rows whose availability columns are 1, 0.5 or 0: the same
    picks as the reference, never a DOWN engine."""
    E = 4
    jsched = jax_make_scheduler(name, E, **dict(kw))
    tsched = make_scheduler(name, E, **dict(kw))
    assert tsched.state_dim == jsched.state_dim
    rng = np.random.default_rng(7)
    rows = rng.uniform(0, 2, (32, tsched.state_dim)).astype(np.float32)
    avail = rng.choice([0.0, 0.5, 1.0], (32, E)).astype(np.float32)
    avail[np.arange(32), rng.integers(0, E, 32)] = 1.0   # one up per row
    hi = -E if name == "prefix-affinity" else None
    rows[:, (hi or 0) - E:hi] = avail
    want, _ = jsched.select(jsched.init_carry(), jax.numpy.asarray(rows), 0,
                            jax.random.key(0))
    got, _ = tsched.select(tsched.init_carry(), torch.from_numpy(rows), 0,
                           torch.Generator())
    assert got.tolist() == np.asarray(want).tolist()
    assert (avail[np.arange(32), got.numpy()] > 0).all()


@pytest.mark.parametrize("name,kw,faults", [
    ("jsq", {}, None), ("jsq", {}, CHAOS[:1]), ("failure-aware", {}, None),
    ("failure-aware", {"qos": True}, None),
    ("prefix-affinity", {"fault": True}, None),
    ("prefix-affinity", {"fault": True, "qos": True}, CHAOS)],
    ids=["jsq", "jsq-faults", "fa", "fa-qos", "prefix", "prefix-qos"])
def test_live_availability_row_matches_reference(name, kw, faults):
    """The availability block sits after the QoS block and before the
    prefix block, 1 / 0.5 / 0 per engine; an infinite token time is guarded; the row equals the reference's."""
    clocks = (ManualClock(5.0), ManualClock(5.0))
    jc, tc = _cluster_pair(name, clocks, faults=faults, **kw)
    assert (tc.qos_obs, tc.fault_obs, tc.prefix_obs, tc.obs_dim) == \
        (jc.qos_obs, jc.fault_obs, jc.prefix_obs, jc.obs_dim)
    for c in (jc, tc):
        c.engines[1].fail("test")
        c.engines[0].degrade(slow_every=2)
        c.engines[0]._ewma_tok_s = float("inf")
    for jr, tr in [_pair(0, _prompts(1, 8)), _pair(1, _prompts(1, 12), 6,
                                                   deadline_s=3.0)]:
        jr.t_arrival = tr.t_arrival = 4.0
        want = np.asarray(jc.observe(jr))
        got = tc.observe(tr).numpy()
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        if tc.fault_obs:
            lo = 2 + 2 + (3 if tc.qos_obs else 0)
            np.testing.assert_array_equal(got[lo:lo + 2], [0.5, 0.0])


@pytest.mark.parametrize("name,kw,fault_obs", [
    ("failure-aware", {}, False), ("deadline", {}, True),
    ("prefix-affinity", {"fault": True}, False)],
    ids=["fa-without", "deadline-with", "prefix-without"])
def test_width_mismatch_message_names_faults(name, kw, fault_obs):
    clocks = (ManualClock(), ManualClock())
    jc, tc = _cluster_pair("jsq", clocks)
    msgs = []
    for c, sched in ((JEdgeCluster, jax_make_scheduler(name, 2, **kw)),
                     (EdgeCluster, make_scheduler(name, 2, **kw))):
        engines = (jc if c is JEdgeCluster else tc).engines
        with pytest.raises(ValueError, match="state_dim") as exc:
            c(engines, sched, fault_obs=fault_obs)
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0] and "+faults adds 2" in msgs[1]
    assert ("E availability" in msgs[1]) == fault_obs


def test_overlap_flag_and_fault_defaults_match_reference():
    clocks = (ManualClock(), ManualClock())
    jc, tc = _cluster_pair("jsq", clocks)
    for c in (jc, tc):
        assert c.overlap and c.injector is None and not c._watchdog
        assert c.retry == type(c.retry)()
    assert dataclasses.asdict(tc.retry) == dataclasses.asdict(jc.retry)
    assert tc.fault_stats == jc.fault_stats
