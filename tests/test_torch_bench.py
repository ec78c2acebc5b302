"""The port's closed-loop bench on the CPU at a small size: every
scheduler serves every request ``ok`` with no KV left held, and the CSV
rows and records carry the reference's names and keys
(``benchmarks/serving.py::bench_closed_loop``)."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.cluster import evaluate_scheduler as jax_evaluate_scheduler
from repro.cluster import make_scheduler as jax_make_scheduler
from repro.cluster import summarize as jax_summarize
from repro.cluster.request import Request as JRequest
from repro.core.env import EnvParams as JEnvParams
from repro.workload import DEFAULT_MIX as JAX_DEFAULT_MIX
from repro_torch.bench import __main__ as bench_main
from repro_torch.bench.serving import (FLEET_ARCHS, bench_closed_loop,
                                       bench_qos_mix)

SCHEDULERS = ["lad-ts", "deadline", "prefix-affinity", "jsq",
              "round-robin", "random", "local"]
# the keys the reference's live records set beside summarize()'s
LIVE_KEYS = {"bench", "scheduler", "wall_s", "throughput_rps", "fleet",
             "paged", "kv_slots", "prefill_chunk", "prompt_len",
             "page_size", "prefix_len", "prefix_frac", "peak_inflight",
             "engine_prefill_tokens_saved", "engine_prefix_hit_rate",
             "cow_forks", "prefix_evictions"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small eager ops on the CPU: one intra-op thread each, so parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_summary_keys():
    """summarize()'s keys for a QoS trace, from the reference."""
    r = JRequest(rid=0, prompt=None, max_new_tokens=1,
                 qos=JAX_DEFAULT_MIX[0][0], deadline_s=2.0)
    r.t_arrival = 0.0
    r.finish(0.5)
    return set(jax_summarize([r]))


def _reference_sim_keys():
    p = JEnvParams(num_bs=2, num_slots=1, max_tasks=2,
                   qos_mix=JAX_DEFAULT_MIX)
    r = jax_evaluate_scheduler(jax_make_scheduler("jsq", 2), p, episodes=1,
                               key=jax.random.key(1))
    r.pop("carry", None)
    return {"bench", "scheduler", "wall_s"} | set(r)


def test_closed_loop_serves_every_request_with_the_reference_keys():
    rows, records = bench_closed_loop(num_requests=8, rate=200.0,
                                      device="cpu")
    live = [r for r in records if r["bench"] == "closedloop_live"]
    sim = [r for r in records if r["bench"] == "closedloop_sim"]
    assert [r["scheduler"] for r in live] == SCHEDULERS
    assert [r["scheduler"] for r in sim] == [n for n in SCHEDULERS
                                            if n != "prefix-affinity"]
    assert [row.split(",")[0] for row in rows] == \
        [f"closedloop_sim/{r['scheduler']}" for r in sim] + \
        [f"closedloop_live/{r['scheduler']}" for r in live]
    want_live = LIVE_KEYS | _reference_summary_keys()
    want_sim = _reference_sim_keys()
    for r in live:
        assert want_live <= set(r), want_live - set(r)
        assert r["completed"] == r["count"] == 8 and r["unfinished"] == 0
        assert r["fleet"] == [FLEET_ARCHS[i % 3] for i in range(4)]
        assert r["paged"] == [True, True, False, True]
        assert [e["kv_leak"] for e in r["engines"]] == [0, 0, 0, 0]
        assert [e["layers"] for e in r["engines"]] == [2, 3, 2, 3]
        # the CPU takes the plain versions: nothing is launched
        assert not any(r["launches"].values())
        assert r["peak_mem_gib"] is None and r["tok_s"] > 0
        assert set(r["classes"]) <= {"interactive", "standard", "batch"}
    for r in sim:
        assert want_sim <= set(r), want_sim - set(r)
        assert "carry" not in r and r["count"] > 0
    json.dumps(records)


def test_qos_mix_matches_the_reference_scale():
    """Interactive half-length prompts preferring xLSTM, batch double,
    each class's z range scaled to the bench's token count."""
    from benchmarks.serving import bench_qos_mix as jax_bench_qos_mix
    for plen in (0, 32):
        got = bench_qos_mix(8, prompt_len=plen)
        want = jax_bench_qos_mix(8, prompt_len=plen)
        assert [(dataclasses.asdict(c), w) for c, w in got] == \
            [(dataclasses.asdict(c), w) for c, w in want]


def test_runner_writes_records_only_where_asked(tmp_path, capsys,
                                                monkeypatch):
    """``python -m repro_torch.bench closedloop`` prints the CSV and, with
    ``--out``, writes the records there and nothing else."""
    import repro_torch.bench.serving as serving
    seen = {}

    def fake(device=None, full_scale=False):
        seen.update(device=device, full_scale=full_scale)
        return (["closedloop_live/jsq,1,mean=0.100s"],
                [{"bench": "closedloop_live", "scheduler": "jsq",
                  "mean_s": np.float64(0.1)}])

    monkeypatch.setattr(serving, "bench_closed_loop", fake)
    monkeypatch.chdir(tmp_path)
    bench_main.main(["closedloop", "--device", "cpu"])
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "closedloop.json"
    bench_main.main(["closedloop", "--device", "cpu", "--full-scale",
                     "--out", str(out)])
    assert seen == {"device": "cpu", "full_scale": True}
    printed = capsys.readouterr().out.splitlines()
    assert printed[:2] == ["name,us_per_call,derived",
                           "closedloop_live/jsq,1,mean=0.100s"]
    data = json.loads(out.read_text())
    assert data == {"bench": "closedloop", "full_scale": True,
                    "records": [{"bench": "closedloop_live",
                                 "scheduler": "jsq", "mean_s": 0.1}]}
    assert [p.name for p in tmp_path.iterdir()] == ["closedloop.json"]


# ---------------------------------------------------------------------------
# the chaos and stress benches
# ---------------------------------------------------------------------------

# the keys the reference's chaos_live records set beside summarize()'s and
# the cluster's fault counters (benchmarks/serving.py::bench_chaos)
CHAOS_KEYS = {"bench", "scheduler", "wall_s", "makespan_calib_s",
              "goodput_rps", "fault_schedule", "fault_seed",
              "orphan_recovery_mean_s", "kv_leak"}
# benchmarks/stress.py: run_stage's keys plus bench_stress's, per record
STAGE_KEYS = {"bench", "scheduler", "fleet", "stage", "num_requests",
              "offered_rate", "wall_s", "overlap", "throughput_rps",
              "goodput_rps", "on_time", "count", "completed", "abandoned",
              "failed", "p50_s", "p95_s", "p99_s", "mean_s",
              "deadline_miss_rate", "weighted_goodput",
              "prefill_tokens_saved", "prefix_hit_rate"}
SUMMARY_KEYS = {"bench", "scheduler", "window_s", "saturation_stage",
                "saturation_rate", "peak_goodput_rps", "stages"}
AB_KEYS = {"bench", "scheduler", "engines", "offered_rate",
           "serial_wall_s", "overlap_wall_s", "overlap_speedup",
           "serial_p95_s", "overlap_p95_s"}


def _reference_fault_stat_keys():
    from repro.cluster import EdgeCluster as JEdgeCluster

    class Stub:
        pass

    c = JEdgeCluster([Stub(), Stub()], jax_make_scheduler("jsq", 2))
    return set(c.fault_stats) - {"orphan_recovery_s"}


def _reference_chaos_sim_keys():
    from repro.faults import FaultParams as JFaultParams
    p = JEnvParams(num_bs=2, num_slots=1, max_tasks=2,
                   fault=JFaultParams(p_down=0.15, p_up=0.5))
    r = jax_evaluate_scheduler(jax_make_scheduler("failure-aware", 2), p,
                               episodes=1, key=jax.random.key(0))
    r.pop("carry", None)
    return {"bench", "scheduler", "wall_s", "p_down", "p_up"} | set(r)


def test_chaos_bench_serves_every_request_with_the_reference_keys():
    """One mid-trace crash per scheduler on the reduced fleet: every
    request terminal and completed, retries within the cap, no KV held,
    nothing quarantined; failure-aware never picks a DOWN station in the
    fault-enabled simulator.  The records carry exactly the reference's
    keys plus the port's ``PORT_KEYS``."""
    from repro_torch.bench.serving import PORT_KEYS, bench_chaos
    from repro_torch.faults import single_crash
    rows, records = bench_chaos(device="cpu")
    live = [r for r in records if r["bench"] == "chaos_live"]
    sim = [r for r in records if r["bench"] == "chaos_sim"]
    assert [r["scheduler"] for r in live] == ["failure-aware", "deadline",
                                              "jsq", "round-robin"]
    assert [r["scheduler"] for r in sim] == ["failure-aware", "jsq",
                                             "round-robin"]
    assert [row.split(",")[0] for row in rows] == \
        [f"chaos_live/{r['scheduler']}" for r in live] + \
        [f"chaos_sim/{r['scheduler']}" for r in sim]
    want_live = (CHAOS_KEYS | _reference_fault_stat_keys()
                 | _reference_summary_keys())
    victim = int(np.random.default_rng(0).integers(2))
    for r in live:
        assert set(r) - set(PORT_KEYS) == want_live, \
            set(r) ^ (want_live | set(PORT_KEYS))
        assert r["completion_rate"] == 1.0 and r["unfinished"] == 0
        assert r["completed"] + r["failed"] + r["abandoned"] == 16
        assert r["retries"] <= (3 - 1) * 16
        assert r["kv_leak"] == [0, 0] and r["quarantined"] == 0
        assert r["injected"] == 2
        m = r["makespan_calib_s"]
        assert r["fault_schedule"] == single_crash(
            victim, 0.3 * m, 0.35 * m, 2).describe()
        assert [e["kv_leak"] for e in r["engines"]] == [0, 0]
        assert not any(r["launches"].values())
    want_sim = _reference_chaos_sim_keys()
    for r in sim:
        assert set(r) == want_sim, set(r) ^ want_sim
    wrong = {r["scheduler"]: r["wrong_choice_rate"] for r in sim}
    assert wrong["failure-aware"] == 0.0 and wrong["round-robin"] > 0.0
    json.dumps(records)


def test_stress_bench_ramps_with_the_reference_keys():
    """Two rungs for JSQ and the overlap A/B on the reduced 4-engine
    fleet: every request terminal, none failed, no KV held, nothing
    quarantined; the knee is the goodput peak; the records carry the
    reference's keys (plus the port's ``STAGE_KEYS`` on stages and
    ``AB_KEYS`` on the A/B)."""
    from repro_torch.bench.stress import AB_KEYS as PORT_AB_KEYS
    from repro_torch.bench.stress import STAGE_KEYS as PORT_STAGE_KEYS
    from repro_torch.bench.stress import bench_stress, detect_saturation
    rows, records = bench_stress(rates=(8.0, 32.0), schedulers=("jsq",),
                                 device="cpu")
    stages = [r for r in records if r["bench"] == "stress_stage"]
    (summary,) = [r for r in records if r["bench"] == "stress_summary"]
    (ab,) = [r for r in records if r["bench"] == "stress_ab"]
    assert [r["num_requests"] for r in stages] == [3, 11]
    for st in stages:
        assert set(st) - set(PORT_STAGE_KEYS) == STAGE_KEYS, \
            set(st) ^ (STAGE_KEYS | set(PORT_STAGE_KEYS))
        assert st["fleet"] == [FLEET_ARCHS[i % 3] for i in range(4)]
    assert set(summary) == SUMMARY_KEYS
    assert set(ab) - set(PORT_AB_KEYS) == AB_KEYS
    assert [r["overlap"] for r in ab["runs"]] == [False, False, True, True]
    # every run, the A/B's included (3 requests each at 8 req/s)
    for st in stages + ab["runs"]:
        n = st.get("num_requests", 3)
        assert st["completed"] + st["abandoned"] == n
        assert st["failed"] == 0 and st["quarantined"] == 0
        assert [e["kv_leak"] for e in st["engines"]] == [0, 0, 0, 0]
        assert not any(st["launches"].values())
    assert summary["saturation_stage"] == detect_saturation(
        [s["goodput_rps"] for s in stages])
    assert ab["offered_rate"] == 8.0 and ab["overlap_speedup"] > 0
    assert [row.split(",")[0] for row in rows] == [
        "stress/jsq@8rps", "stress/jsq@32rps", "stress_summary/jsq",
        "stress_ab/jsq@8rps"]
    json.dumps(records)


def test_stress_mix_and_knee_match_the_reference():
    from benchmarks.stress import detect_saturation as jax_detect
    from benchmarks.stress import stress_qos_mix as jax_stress_qos_mix
    from repro_torch.bench.stress import detect_saturation, stress_qos_mix
    got = stress_qos_mix(6, 16)
    want = jax_stress_qos_mix(6, 16)
    assert [(dataclasses.asdict(c), w) for c, w in got] == \
        [(dataclasses.asdict(c), w) for c, w in want]
    for goodputs in ([1.0, 3.0, 2.0], [5.0, 5.0, 1.0], [0.0]):
        assert detect_saturation(goodputs) == jax_detect(goodputs)


@pytest.mark.parametrize("bench,module,fn", [
    ("chaos", "serving", "bench_chaos"), ("stress", "stress",
                                          "bench_stress")])
def test_runner_runs_chaos_and_stress(tmp_path, capsys, monkeypatch, bench,
                                      module, fn):
    """``python -m repro_torch.bench chaos|stress --out PATH`` calls the
    bench with the device and scale asked for and writes its records."""
    import importlib
    mod = importlib.import_module(f"repro_torch.bench.{module}")
    seen = {}

    def fake(device=None, full_scale=False):
        seen.update(device=device, full_scale=full_scale)
        return ([f"{bench}/jsq,1,x=1"], [{"bench": f"{bench}_x",
                                          "v": np.float32(0.5)}])

    monkeypatch.setattr(mod, fn, fake)
    out = tmp_path / f"{bench}.json"
    bench_main.main([bench, "--device", "cpu", "--out", str(out)])
    assert seen == {"device": "cpu", "full_scale": False}
    assert capsys.readouterr().out.splitlines()[1] == f"{bench}/jsq,1,x=1"
    assert json.loads(out.read_text()) == {
        "bench": bench, "full_scale": False,
        "records": [{"bench": f"{bench}_x", "v": 0.5}]}
