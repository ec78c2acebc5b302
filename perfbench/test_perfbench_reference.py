"""The references match the port at a reduced size: the dense kind's
logits (its plain decoder) equal the port's forward pass on the same
weights and params, both made through the kind, the LAD-TS chain the
port's ``ops.ladn_denoise``, and the check's walk over its own latent
store the port's scheduler placement by placement; and the
lower-precision controls do not."""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import harness, model
from perfbench.reference import decoder, ladn

CONFIGS = sorted((Path(__file__).resolve().parent / "configs").glob("*.json"))
# the shrink below is the dense decoder's; another kind tests its own
DENSE = [p for p in CONFIGS if model.load(p)["model"] == "dense"]
SHRINK = {"layers": 2, "d_model": 64, "heads": 4, "kv_heads": 2,
          "d_ff": 96, "vocab": 97, "dtype": "float32"}


@pytest.mark.parametrize("path", DENSE, ids=lambda p: p.stem)
def test_decoder_matches_the_port(path):
    from repro_torch.models.transformer import apply_head, forward
    conf = model.load(path)
    kind = harness.model_kind(conf["model"])
    s = kind.spec(conf, SHRINK)
    w = kind.make_weights(s, 2**31 + 7, torch.device("cpu"))
    cfg = kind.model_config(conf, s)
    params = kind.engine_params(s, w)
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, s["vocab"], n) for n in (9, 23)]
    firsts = [3, 0]
    ref = kind.logits_at(w, s, seqs, firsts, "fp32")
    for seq, first, r in zip(seqs, firsts, ref):
        toks = torch.as_tensor(seq[None], dtype=torch.int32)
        with torch.no_grad():
            hidden = forward(params, cfg, {"tokens": toks},
                             mode="train")["hidden"]
            port = apply_head(params, cfg, hidden)[0, first:].float()
        assert r.shape == port.shape
        assert torch.allclose(r, port, atol=2e-5, rtol=1e-4)
    low = kind.logits_at(w, s, seqs, firsts, precision="fp8")
    assert all((a - b).abs().max() > 1e-3 for a, b in zip(ref, low))


def test_served_gaps():
    ref = torch.tensor([[0.0, 2.0, 1.0], [3.0, 1.0, 0.5]])
    assert decoder.served_gaps(ref, torch.tensor([1, 2])).tolist() == \
        [0.0, 2.5]
    seq, first = decoder.split_tokens(np.arange(5), np.array([7, 8, 9]))
    assert seq.tolist() == [0, 1, 2, 3, 4, 7, 8] and first == 4


@pytest.mark.parametrize("I,A,S", [(3, 2, 4), (5, 4, 11)])
def test_chain_matches_the_port(I, A, S):  # noqa: E741
    from repro_torch.core import networks as nets
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(5)
    theta = nets.init_ladn(gen, S, A, (20, 20), 1)
    latent = torch.randn(A, generator=gen)
    eps0 = torch.randn(A, generator=gen)
    s = torch.randn(S, generator=gen) * 3
    chain = torch.randn(I, A, generator=gen)
    bar = ladn.schedule(I, 0.1, 10.0)[2][-1]
    sq, sq1 = bar.sqrt(), (1 - bar).sqrt()
    x_I = (sq * latent.double() + sq1 * eps0.double()).float()
    x0, _ = ops.ladn_denoise(theta, x_I[None, None], s[None, None],
                             chain[None, None], num_steps=I)
    th = [(layer["w"][0], layer["b"][0]) for layer in theta]
    ref = ladn.denoise(th, latent, eps0, s, chain, I, 0.1, 10.0)
    assert torch.allclose(x0[0, 0].double(), ref, atol=1e-5)
    low = ladn.denoise(th, latent, eps0, s, chain, I, 0.1, 10.0,
                       dtype=torch.bfloat16)
    assert (low.double() - ref).abs().max() > 1e-4
    g = torch.zeros(A)
    assert ladn.action(ref, g) == int(torch.argmax(ref))


def test_latent_store_walk_follows_the_port():
    """A run of the port's LAD-TS scheduler on the harness's actor: the
    check's chains, worked out from the harness's copy of the actor and
    a latent store of their own, give the port's x_0 at every placement,
    and the port's store ends where the walk's does."""
    from perfbench import check, harness
    from perfbench.probes import Probes
    sch = model.load(CONFIGS[0])["scheduler"]
    dev = torch.device("cpu")
    actor = model.make_actor(sch, dev)
    mine = {"theta": [(layer["w"].clone(), layer["b"].clone())
                      for layer in actor["theta"]], "X": actor["X"].clone()}
    scheduler = harness.policy(sch, actor, dev)
    probes = Probes(timing=False)
    probes.install_scheduler(scheduler)
    probes.recording = True
    carry, gen = scheduler.init_carry(), torch.Generator().manual_seed(3)
    origins = [0, 1, 1, 0, 0, 0, 1, 0, 1, 1, 1, 0, 0, 1, 0, 0, 1]
    for k, o in enumerate(origins):
        s = torch.randn(sch["state_dim"], generator=gen) * 5
        _, carry = scheduler.select_one(carry, s, o, k % sch["max_tasks"],
                                        gen)
    probes.restore()
    recs = check.placements_to_host(probes.placements)
    reqs = [SimpleNamespace(origin=o) for o in origins]
    got = check.denoise_err(recs, reqs, mine, sch)
    assert got["placements"] == len(origins)
    assert got["denoise_err"] < 1e-5 and got["place_disagree"] == 0
    walk = check.chains(recs, origins, mine, sch, torch.float64)
    for k, o in enumerate(origins):
        x0 = walk[k]
        want = (x0 - x0.mean()) / (x0.std(correction=0) + 1e-6)
        last = max(j for j, oj in enumerate(origins) if oj == o
                   and j % sch["max_tasks"] == k % sch["max_tasks"])
        if last == k:
            n = k % sch["max_tasks"]
            assert torch.allclose(carry.X[o, n].double(), want, atol=1e-5)
    # one placement short: the walk has nothing to pair it with
    assert check.denoise_err(recs[:-1], reqs, mine, sch)[
        "denoise_err"] is None
