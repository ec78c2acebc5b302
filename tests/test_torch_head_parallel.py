"""Head-parallel attention on gloo meshes (1, 4), (2, 2) and (4, 1): each
"model" rank attends only its H / M query heads (no all-gather of q over
"model") against the K/V heads they read, for reduced qwen2-1.5b with
heads giving G = 1, 2 and 3 query heads a K/V head on a rank, both where
M divides KV (the rank's own column block of ``wk`` / ``wv``) and where
one K/V head serves several ranks; and a config whose ranks' heads would
straddle two K/V groups on 4 ranks (the gathered path).  The train step's
loss and gradients, the dense prefill's logits and a paged engine's
greedy tokens (prompt chunks through ``flash_attention``) equal the
single-device JAX reference within 1e-4 (f32); the placement report
names the layout each attention took."""
import json

import numpy as np
import pytest
import torch

from _torch_dist import (each, placement_serve_rank, ranks_running,
                         train_step_rank)
from _torch_train import OPT, one_thread, reference_step, train_case
from repro.models.transformer import forward as jax_forward
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.convert import params_from_jax
from repro_torch.core.optim import tree_leaves

MESHES = [(1, 4), (2, 2), (4, 1)]
TOL = 1e-4
HD = 32
# name: (H, KV); on 4 "model" ranks: query heads per rank over the K/V
# heads they read
CASES = {
    "g1_div": (4, 4),        # 1 over 1, M | KV
    "g2_div": (8, 4),        # 2 over 1
    "g3_div": (12, 4),       # 3 over 1
    "g1_shared": (4, 2),     # 1 over 1, one K/V head serves 2 ranks
    "g2_shared": (8, 2),     # 2 over 1, 2 ranks
    "g3_shared": (12, 2),    # 3 over 1, 2 ranks
    "straddle": (12, 6),     # 3 heads over groups of 2: gathered on 4
}
ENGINE = dict(max_len=32, kv_slots=2, max_lanes=2, page_size=8,
              prefill_chunk=8)
N_NEW = 4

# AdamW's eps at 1e-2, as for the data-parallel step of
# test_torch_train_mesh.py: the update of a gradient entry near eps is
# steep in it, and the ranks' sums round differently from one device's
_thread = pytest.fixture(autouse=True)(one_thread)
DP_OPT = dict(OPT, eps=1e-2)


def _own(H, KV, M):
    """(query heads a rank attends, its K/V heads), None if gathered."""
    nq, G = H // M, H // KV
    if nq % G == 0:
        return nq, nq // G
    if G % nq == 0:
        return nq, 1
    return None


def test_rank_local_head_counts_cover_the_cases():
    """On 4 "model" ranks the cases give G = 1, 2, 3 with M | KV and
    with M > KV, and one straddling config; on 2 the straddling one is
    head-parallel (6 heads over 3 K/V heads)."""
    got = {name: _own(H, KV, 4) for name, (H, KV) in CASES.items()}
    assert got == {"g1_div": (1, 1), "g2_div": (2, 1), "g3_div": (3, 1),
                   "g1_shared": (1, 1), "g2_shared": (2, 1),
                   "g3_shared": (3, 1), "straddle": None}
    assert _own(12, 6, 2) == (6, 3)


def _cfgs(name):
    H, KV = CASES[name]
    return dict(num_heads=H, num_kv_heads=KV, head_dim=HD)


def test_head_parallel_attention_equals_the_reference(tmp_path):
    """Every case on every mesh, every rank: the train step's loss,
    gradients and new params (gathered whole) within 1e-4 of the
    reference's; the prefill's last logits through the mesh and the
    paged engine's greedy tokens equal to the reference's; ``heads`` is
    ``model=tp`` where the rank's heads divide "model" and do not
    straddle, ``model=gathered`` on the straddling config at M = 4."""
    step_cases, serve_cases, want = [], [], {}
    rng = np.random.default_rng(11)
    for name in CASES:
        jcfg, tcfg, jp, tp, jb, tb = train_case("qwen2-1.5b", batch=4,
                                                **_cfgs(name))
        pf, bf = (str(tmp_path / f"{name}.{k}.pt") for k in ("p", "b"))
        torch.save(tp, pf)
        torch.save(tb, bf)
        prompts = rng.integers(0, tcfg.vocab_size, (3, 12), dtype=np.int32)
        for D, M in MESHES:
            key = f"{name}_{D}x{M}"
            step_cases.append((key, tcfg, pf, bf, (D, M), DP_OPT))
            serve_cases.append((f"serve_{key}", tcfg, pf, (D, M), prompts,
                                N_NEW, ENGINE))
        want[name] = (jcfg, tcfg, jp, jb, prompts)
    calls = [(train_step_rank, (step_cases, str(tmp_path))),
             (placement_serve_rank, (serve_cases, str(tmp_path)))]
    with ranks_running(each, 4, tmp_path, calls, timeout=400.0):
        ref = {}
        for name, (jcfg, tcfg, jp, jb, prompts) in want.items():
            total, grads, new, metrics = reference_step(jcfg, jp, jb, DP_OPT)
            toks = np.stack([np.asarray(t) for t in JServeEngine(
                jcfg, jp, **ENGINE).generate(prompts, N_NEW).tokens])
            logits = np.asarray(jax_forward(
                jp, jcfg, {"tokens": prompts[:1]}, mode="prefill",
                max_len=ENGINE["max_len"])["last_logits"])
            g = [t.numpy() for t in tree_leaves(params_from_jax(grads, tcfg,
                                                                "cpu"))]
            p = [t.numpy() for t in tree_leaves(params_from_jax(new, tcfg,
                                                                "cpu"))]
            ref[name] = (metrics["loss"], g, p, toks, logits)
    for name, (loss, g, p, toks, logits) in ref.items():
        H, KV = CASES[name]
        for D, M in MESHES:
            key = f"{name}_{D}x{M}"
            for r in range(4):
                got = np.load(tmp_path / f"{key}.{r}.npz")
                np.testing.assert_allclose(float(got["loss"]), loss,
                                           rtol=TOL, err_msg=key)
                for i, (a, b) in enumerate(zip(g, p)):
                    for blob, w in ((f"g{i}", a), (f"p{i}", b)):
                        err = float(np.abs(got[blob] - w).max())
                        assert err <= TOL * max(float(np.abs(w).max()),
                                                1e-6), f"{key} {r} {blob}"
                srv = np.load(tmp_path / f"serve_{key}.{r}.npz")
                np.testing.assert_array_equal(srv["tokens"], toks,
                                              err_msg=f"{key} rank {r}")
                err = float(np.abs(srv["logits"].reshape(logits.shape)
                                   - logits).max())
                assert err <= TOL * max(float(np.abs(logits).max()), 1.0)
                rep = json.loads(str(srv["report"]))
                heads = {v["heads"] for k, v in rep.items()
                         if k.startswith("layers.") and "heads" in v}
                tp = _own(H, KV, M) is not None
                assert heads == {"model=tp" if tp else "model=gathered"}, \
                    f"{key} rank {r}: {heads}"
