"""Port serving layer against the JAX one: the page-pool books under the
same operation sequence, and the paged engine's tokens, statuses and KV
accounting on the same requests (chunked-prefill interleaving, prefix
hits and copy-on-write forks).  Reduced qwen2-1.5b, 2 layers, f32,
greedy decoding, an injected clock."""
import numpy as np
import pytest
import torch

from _torch_parity import CPU, FakeClock, configs, params_pair, tokens_of
from repro.cluster.request import Request as JRequest
from repro.serving import paged_kv as jkv
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.cluster.request import Request
from repro_torch.serving import compiled
from repro_torch.serving import paged_kv as tkv
from repro_torch.serving.engine import ServeEngine


# ---------------------------------------------------------------------------
# page-pool books
# ---------------------------------------------------------------------------


class _World:
    """One package's pool + prefix cache + live tables."""

    def __init__(self, kv):
        self.kv = kv
        self.pool = kv.PagePool(num_pages=24, page_size=4)
        self.cache = kv.PrefixCache(self.pool)
        self.tables = []

    def books(self):
        return (list(self.pool._free), dict(self.pool._refs),
                list(self.cache._entries), self.cache.evictions,
                self.pool.total_refs)


def _admit(w, prompt):
    """The engine's admission: match, acquire, make room, build a table
    over the shared pages, fork the COW page, release the fork source."""
    m = w.cache.match(prompt, max_tokens=prompt.shape[-1] - 1)
    w.cache.acquire(m)
    need = w.pool.pages_needed(prompt.shape[-1] + 3) - len(m.pages)
    if not (w.pool.num_free >= need or w.cache.ensure_free(need)):
        w.cache.release_match(m)
        return (m.tokens, None)
    t = w.kv.BlockTable(w.pool, prompt.shape[-1] + 3, shared=m.pages)
    if m.cow_page is not None:
        w.pool.release([m.cow_page])
    w.tables.append((prompt, t))
    return (m.tokens, list(t.pages))


def _apply(w, op, prompt, pick, n):
    if op == 0 or (op == 1 and not w.tables):
        return _admit(w, prompt)
    if op == 1:                                  # a lane finishes
        done, t = w.tables.pop(pick % len(w.tables))
        added = w.cache.insert(done, t.pages)
        t.release()
        return added
    if op == 2:
        return w.cache.ensure_free(n)
    m = w.cache.match(prompt)
    return (list(m.pages), m.cow_page, m.cow_tokens)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_pool_and_prefix_cache_books_match(seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 50, (1, 20), dtype=np.int32)
    prompts = [base.copy(), base[:, :13].copy()]
    for cut in (5, 9, 14):                       # mid-block divergences
        p = base.copy()
        p[0, cut] += 1
        prompts.append(p)
    prompts += [rng.integers(0, 50, (1, n), dtype=np.int32)
                for n in (8, 17, 12)]
    worlds = [_World(jkv), _World(tkv)]
    for _ in range(60):
        op, pick, n = (int(rng.integers(0, 4)),
                       int(rng.integers(0, len(prompts))),
                       int(rng.integers(0, 8)))
        outs = [_apply(w, op, prompts[pick], pick, n) for w in worlds]
        assert outs[0] == outs[1]
        assert worlds[0].books() == worlds[1].books()
    for w in worlds:
        for _, t in w.tables:
            t.release()
        w.cache.clear()
        assert w.pool.num_free == 23 and w.pool.total_refs == 0


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------


def _engines(**kw):
    jcfg, tcfg = configs(num_layers=2)
    jparams, tparams = params_pair(jcfg, tcfg, seed=0)
    kw = dict(max_len=64, kv_slots=2, page_size=8, prefill_chunk=8,
              max_lanes=4, **kw)
    je = JServeEngine(jcfg, jparams, paged=True, clock=FakeClock(), **kw)
    te = ServeEngine(tcfg, tparams, clock=FakeClock(), device=CPU, **kw)
    return je, te


def _serve_both(je, te, batches):
    """Admit each batch of (rid, prompt, max_new) to both engines and
    drain; returns the (JAX, port) request lists."""
    jreqs, treqs = [], []
    for batch in batches:
        for rid, prompt, n in batch:
            jreqs.append(JRequest(rid=rid, prompt=prompt, max_new_tokens=n))
            treqs.append(Request(rid=rid, prompt=prompt, max_new_tokens=n))
            je.admit(jreqs[-1])
            te.admit(treqs[-1])
        je.run_to_completion()
        te.run_to_completion()
    return jreqs, treqs


def _assert_same(jreqs, treqs):
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tokens_of(tr), tokens_of(jr))
        assert (tr.status, tr.prefix_tokens) == (jr.status, jr.prefix_tokens)


def test_engine_matches_reference_with_interleaved_prefill():
    """A long prompt prefills in chunks while a short request decodes
    between them; tokens and statuses match the reference."""
    je, te = _engines()
    rng = np.random.default_rng(4)
    vocab = je.cfg.vocab_size
    batch = [(0, rng.integers(0, vocab, (1, 48), dtype=np.int32), 4),
             (1, rng.integers(0, vocab, (1, 8), dtype=np.int32), 3),
             (2, rng.integers(0, vocab, (1, 19), dtype=np.int32), 6)]
    jreqs, treqs = _serve_both(je, te, [batch])
    _assert_same(jreqs, treqs)
    assert all(r.status == "ok" for r in treqs)
    assert te.peak_inflight == je.peak_inflight == 3
    assert te.kv_leak == je.kv_leak == 0


def test_engine_matches_reference_on_prefix_hits_and_cow_forks():
    """A repeated prompt reuses two full blocks plus a copy-on-write tail
    (capped at prompt_len - 1); a child diverging at position 20 forks
    the third block.  Same tokens, savings and forks as the reference."""
    je, te = _engines()
    vocab = je.cfg.vocab_size
    parent = np.random.default_rng(8).integers(0, vocab, (1, 24),
                                               dtype=np.int32)
    child = parent.copy()
    child[0, 20] = (child[0, 20] + 1) % vocab
    jreqs, treqs = _serve_both(je, te, [[(0, parent, 4)],
                                        [(1, parent, 4), (2, child, 3)]])
    _assert_same(jreqs, treqs)
    assert [r.prefix_tokens for r in treqs] == [0, 23, 20]
    assert te.cow_forks == je.cow_forks == 2
    assert te.prefill_tokens_saved == je.prefill_tokens_saved == 43
    assert te.prefix_cached_pages == je.prefix_cached_pages
    assert te.kv_leak == je.kv_leak == 0
    np.testing.assert_array_equal(tokens_of(treqs[1]), tokens_of(treqs[0]))


def test_engine_without_prefix_cache_matches_reference():
    je, te = _engines(prefix_cache=False)
    vocab = je.cfg.vocab_size
    p = np.random.default_rng(9).integers(0, vocab, (1, 24), dtype=np.int32)
    jreqs, treqs = _serve_both(je, te, [[(0, p, 3)], [(1, p, 3)]])
    _assert_same(jreqs, treqs)
    assert te._pool.num_free == te.num_pages - 1 and te.kv_leak == 0


def test_dispatch_defers_values_to_collect_and_reset_frees_pool():
    _, te = _engines()
    p = np.random.default_rng(10).integers(0, te.cfg.vocab_size, (1, 8),
                                           dtype=np.int32)
    r = Request(rid=0, prompt=p, max_new_tokens=3)
    te.admit(r)
    assert te.dispatch() and te.pending_collect
    assert torch.is_tensor(r.tokens[0])           # value still on device
    with pytest.raises(RuntimeError, match="collect"):
        te.dispatch()
    te.collect()
    assert isinstance(r.tokens[0], np.ndarray) and not te.pending_collect
    te.run_to_completion()
    assert r.status == "ok" and len(r.tokens) == 3
    assert te.decode_rounds == 2 and te.prefix_cached_pages == 1
    cap = te.capability
    assert cap.paged and cap.measured and cap.tok_s > 0
    te.reset()
    assert te._pool.num_free == te.num_pages - 1 and te.decode_rounds == 0
    assert te.prefix_cached_pages == 0 and te._ewma_tok_s == 0.0


def test_sampled_decoding_is_reproducible_per_seed():
    jcfg, tcfg = configs(num_layers=2)
    _, tparams = params_pair(jcfg, tcfg)
    p = np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, 8),
                                           dtype=np.int32)
    runs = [ServeEngine(tcfg, tparams, max_len=32, kv_slots=2, sample=True,
                        device=CPU, seed=s).generate(p, 5).tokens
            for s in (3, 3, 4)]
    assert all(np.array_equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not all(np.array_equal(a, b) for a, b in zip(runs[0], runs[2]))


def test_page_copy_step_copies_one_page_in_every_layer_in_place():
    _, tcfg = configs(num_layers=2)
    copy = compiled.page_copy_step(tcfg, 5, 4)
    assert compiled.page_copy_step(tcfg, 5, 4) is copy     # shared entry
    states = [{"k_pages": torch.randn(5, 2, 4, 8),
               "v_pages": torch.randn(5, 2, 4, 8)} for _ in range(2)]
    before = [{k: v.clone() for k, v in s.items()} for s in states]
    pools = [s["k_pages"] for s in states]
    out = copy(states, 3, 1)
    assert out[0]["k_pages"] is pools[0]
    for s, b in zip(out, before):
        for name in s:
            torch.testing.assert_close(s[name][1], b[name][3])
            torch.testing.assert_close(s[name][[0, 2, 3, 4]],
                                       b[name][[0, 2, 3, 4]])
