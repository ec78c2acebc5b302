"""Port serving fast path against the JAX one: serial against overlapped
cluster stepping over a mixed paged + dense fleet, ``step`` as
``dispatch`` + ``collect``, and the shared step cache's hits, misses and
sizes over the same engine builds, and the reference's sharded cases:
big-model engines on the smoke mesh and on 2 gloo ranks give the
reference's unsharded engine's tokens.  Reduced configs, 2 layers, f32,
greedy decoding."""
import json

import jax
import numpy as np
import pytest
import torch

from _torch_dist import engine_rank, run_ranks
from _torch_parity import CPU, configs, params_pair, tokens_of
from repro.cluster import EdgeCluster as JEdgeCluster
from repro.cluster import make_scheduler as jax_make_scheduler
from repro.cluster import poisson_trace as jax_poisson_trace
from repro.serving import compiled as jax_compiled
from repro.serving.builders import build_fleet as jax_build_fleet
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.cluster import EdgeCluster, Request, make_scheduler
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.serving import compiled
from repro_torch.serving.builders import build_fleet, build_sharded_engine
from repro_torch.serving.engine import ServeEngine

FLEET = ["qwen2-1.5b", "xlstm-350m", "starcoder2-3b"]


def _engine_pair(arch="qwen2-1.5b", num_layers=2, kv_slots=2, max_len=40,
                 seed=0, **kw):
    """The reference's engine and the port's on the same weights."""
    jcfg, tcfg = configs(num_layers=num_layers, arch=arch)
    jparams, tparams = params_pair(jcfg, tcfg, seed=seed)
    return (JServeEngine(jcfg, jparams, max_len=max_len, kv_slots=kv_slots,
                         **kw),
            ServeEngine(tcfg, tparams, max_len=max_len, kv_slots=kv_slots,
                        device=CPU, **kw))


def _drain(cluster, n):
    done = []
    for _ in range(10_000):
        if len(done) >= n and not cluster.busy:
            break
        done += cluster.step()
    return done


def _burst(cluster, trace, port):
    """Submit an identical burst and drain; returns {rid: request}."""
    reqs = [Request(rid=r.rid, prompt=np.asarray(r.prompt),
                    max_new_tokens=r.max_new_tokens, arrival_s=r.arrival_s,
                    origin=r.origin) if port else r for r in trace]
    for r in reqs:
        cluster.submit(r)
    return {r.rid: r for r in _drain(cluster, len(reqs))}


# ---------------------------------------------------------------------------
# overlapped dispatch/collect against serial stepping
# ---------------------------------------------------------------------------


def test_overlap_and_serial_stepping_match_each_other_and_the_reference():
    """The same burst through overlap=False and overlap=True clusters over
    a mixed paged + dense fleet, and through the reference's overlapped
    cluster on the same weights: identical greedy tokens and statuses,
    ordered timestamps, no KV left held."""
    kw = dict(max_len=48, depths=[2, 2, 2], seed0=3, kv_slots=2,
              prefill_chunk=8, max_lanes=4)
    jeng = jax_build_fleet(FLEET, **kw)
    trace = jax_poisson_trace(8, rate=1e9, prompt_len=10, max_new_tokens=5,
                              vocab_size=min(e.cfg.vocab_size for e in jeng),
                              num_origins=3, seed=5)
    runs = {}
    for overlap in (False, True):
        teng = build_fleet(FLEET, device=CPU, **kw)
        for je, te in zip(jeng, teng):
            te.params = params_from_jax(
                jax.tree_util.tree_map(np.asarray, je.params), te.cfg, CPU)
        cluster = EdgeCluster(teng, make_scheduler("jsq", 3), seed=11,
                              overlap=overlap)
        assert cluster.overlap is overlap
        runs[overlap] = (teng, _burst(cluster, trace, port=True))
    want = _burst(JEdgeCluster(jeng, jax_make_scheduler("jsq", 3), seed=11),
                  trace, port=False)
    serial, overlap = runs[False][1], runs[True][1]
    assert serial.keys() == overlap.keys() == want.keys()
    assert len(want) == 8
    for rid, w in want.items():
        a, b = serial[rid], overlap[rid]
        assert a.status == b.status == w.status == "ok"
        assert a.engine_id == b.engine_id == w.engine_id
        np.testing.assert_array_equal(tokens_of(a), tokens_of(w))
        np.testing.assert_array_equal(tokens_of(b), tokens_of(w))
        assert b.t_enqueue <= b.t_prefill_start <= b.t_prefill_end \
            <= b.t_finish
    for e in runs[False][0] + runs[True][0]:
        assert e.kv_leak == 0 and not e.has_work


def _admit(e, rid=0, plen=6, n_new=3):
    req = Request(rid=rid, prompt=np.zeros((1, plen), np.int32),
                  max_new_tokens=n_new)
    e.admit(req)
    return req


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_engine_step_equals_dispatch_collect(paged):
    """``step`` is ``dispatch`` + ``collect``, and a second dispatch
    without a collect is refused."""
    _, e = _engine_pair(paged=paged)
    _admit(e, n_new=3)
    assert e.dispatch() and e.pending_collect
    with pytest.raises(RuntimeError, match="uncollected"):
        e.dispatch()
    done = e.collect()
    assert e.pending_collect is False
    done += e.run_to_completion()
    assert len(done) == 1 and done[0].status == "ok"


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_dispatch_returns_false_when_idle(paged):
    _, e = _engine_pair(paged=paged)
    assert e.dispatch() is False
    assert e.collect() == []


def test_ewma_updates_at_collect_not_dispatch():
    """The token-time EWMA spans dispatch to collect, so it moves only
    once a round's results have landed."""
    _, e = _engine_pair()
    _admit(e, n_new=4)
    assert e.dispatch()
    assert e._ewma_tok_s == 0.0      # decode round in flight, not timed yet
    e.collect()
    e.step()                         # a full decode round
    assert e._ewma_tok_s > 0.0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_fail_during_pending_drops_the_dispatched_round(paged):
    """A crash between dispatch and collect drops the round, orphans its
    request and leaves no KV held, as in the reference."""
    engines = _engine_pair(paged=paged)
    orphans = []
    for e in engines:
        _admit(e, n_new=4)
        assert e.dispatch()
        orphans.append([r.rid for r in e.fail("injected")])
        assert e._pending is None and e.kv_leak == 0
        assert e.collect() == []
    assert orphans[1] == orphans[0] == [0]
    # the dropped dispatch's passes were enqueued: they stay counted
    assert (engines[1].prefills, engines[1].decode_rounds) == (1, 1)


# ---------------------------------------------------------------------------
# shared step cache
# ---------------------------------------------------------------------------


def _info(mod):
    info = mod.cache_info()
    return info["size"], info["hits"], info["misses"]


BUILDS = {
    "same": [dict(arch="xlstm-350m", seed=0), dict(arch="xlstm-350m",
                                                   seed=1),
             dict(arch="qwen2-1.5b", seed=0), dict(arch="qwen2-1.5b",
                                                   seed=1)],
    "different": [dict(arch="xlstm-350m", num_layers=2),
                  dict(arch="xlstm-350m", num_layers=3),
                  dict(arch="qwen2-1.5b", kv_slots=2),
                  dict(arch="qwen2-1.5b", kv_slots=2, max_len=64)],
}


@pytest.mark.parametrize("case", list(BUILDS))
def test_step_cache_counts_match_reference(case):
    """Over the same sequence of engine builds the port's cache has the
    reference's size, hits and misses after every build; same-config
    engines share their step callables and different configs do not."""
    jax_compiled.clear_cache()
    compiled.clear_cache()
    assert _info(compiled) == (0, 0, 0)
    built = []
    for kw in BUILDS[case]:
        built.append(_engine_pair(**kw))
        assert _info(compiled) == _info(jax_compiled)
    (_, a), (_, b), (_, c), (_, d) = built
    same = case == "same"
    assert (a._prefill is b._prefill) == same
    assert (a._pool_decode is b._pool_decode) == same
    assert (c._paged_prefill is d._paged_prefill) == same
    assert (c._paged_decode is d._paged_decode) == same
    assert len(compiled.cache_info()["keys"]) == _info(compiled)[0]
    if same:
        assert compiled.cache_info()["hits"] > 0


def test_shared_steps_serve_identical_results():
    """Two engines behind one cached step give the tokens two separate
    engines would, and the reference's: the cache does not entangle
    their states."""
    compiled.clear_cache()
    je, a = _engine_pair(arch="xlstm-350m", seed=0)
    _, b = _engine_pair(arch="xlstm-350m", seed=0)
    assert a._pool_decode is b._pool_decode
    prompt = np.arange(8, dtype=np.int32)[None, :] % a.cfg.vocab_size
    ra, rb = a.generate(prompt, 4), b.generate(prompt, 4)
    want = je.generate(prompt, 4)
    assert np.array_equal(np.asarray(ra.tokens), np.asarray(rb.tokens))
    assert np.array_equal(np.asarray(ra.tokens), np.asarray(want.tokens))


# ---------------------------------------------------------------------------
# sharded big-model engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "dbrx-132b"])
def test_sharded_big_model_engine_serves(arch):
    """The big-model configs serve through the smoke mesh: the engine
    holds the rank's expert blocks and a request completes, no KV held."""
    eng = build_sharded_engine(arch, max_len=32, kv_slots=2,
                               prefill_chunk=8, device=CPU)
    assert eng.mesh == make_smoke_mesh(CPU)
    assert eng.paged == (arch == "dbrx-132b")    # mixtral is windowed
    ffn = eng.params["layers"][0]["ffn"]
    assert ffn["we_up"].shape == (1, eng.cfg.moe.num_experts,
                                  eng.cfg.d_model, eng.cfg.d_ff)
    req = Request(rid=0, prompt=np.arange(6, dtype=np.int32)[None],
                  max_new_tokens=3)
    eng.admit(req)
    eng.run_to_completion()
    assert req.status == "ok" and len(req.tokens) == 3
    assert eng.kv_leak == 0


def _sharded_case(arch, seed=0):
    jcfg, tcfg = configs(num_layers=2, arch=arch)
    jparams, tparams = params_pair(jcfg, tcfg, seed=seed)
    # 4 slots (8 paged lanes): a round's capacity can drop tokens
    kw = dict(max_len=40, kv_slots=4, prefill_chunk=8)
    prompts = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (4, 10), dtype=np.int32)
    want = JServeEngine(jcfg, jparams, **kw).generate(prompts, 5)
    return tcfg, tparams, kw, prompts, np.stack(
        [np.asarray(t) for t in want.tokens])


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x22b",
                                  "dbrx-132b"])
def test_smoke_mesh_engine_gives_the_reference_unsharded_tokens(arch):
    """Smoke-mesh sharding is invisible: the port's engine on the 1 x 1
    mesh (paged qwen2 and dbrx, dense mixtral; the MoE layers on their
    stationary path) and without a mesh give the greedy tokens of the
    reference's unsharded engine on the same weights."""
    tcfg, tparams, kw, prompts, want = _sharded_case(arch, seed=1)
    for mesh in (make_smoke_mesh(CPU), None):
        eng = ServeEngine(tcfg, tparams, device=CPU, mesh=mesh, **kw)
        assert eng.mesh is mesh
        got = eng.generate(prompts, 5)
        np.testing.assert_array_equal(
            np.stack([np.asarray(t) for t in got.tokens]), want)
        assert eng.kv_leak == 0


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "dbrx-132b"])
def test_two_rank_mesh_engine_gives_the_reference_tokens(arch, tmp_path):
    """Two gloo ranks on a (1, 2) mesh, each holding half of the experts:
    both serve the reference's unsharded greedy tokens."""
    tcfg, tparams, kw, prompts, want = _sharded_case(arch, seed=2)
    params_file = str(tmp_path / "params.pt")
    torch.save(tparams, params_file)
    run_ranks(engine_rank, 2, tmp_path, tcfg, params_file, (1, 2),
              prompts, 5, str(tmp_path), kw)
    for rank in range(2):
        with open(tmp_path / f"tokens.{rank}.json") as fh:
            got = json.load(fh)
        np.testing.assert_array_equal(np.asarray(got["tokens"]), want)
        assert got["kv_leak"] == 0
