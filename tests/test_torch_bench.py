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
