"""The check is shown to fail.  A small edge pair on the CPU runs the
whole of a run but the look for a card: served as it is, it is correct;
with the timed path broken underneath, once for each fault a serving
cell can have, it is not; and the lower-precision controls read above
the limits.  (The exchange between chips has no fault here: every cell
takes one chip.)"""
import json
import time

import pytest
import torch

from perfbench import check, harness, traffic

CELL = "starcoder2-7b-edge2.code-unshared"


def _small_cell():
    real = harness.load_cell(CELL)
    conf = json.loads(json.dumps(real.conf))
    conf["serve"].update(lanes=8, max_len=160, prefill_chunk=64)
    mix = json.loads(json.dumps(real.mix))
    # its own arrivals, lengths and blocks: 16 requests the CPU serves
    mix.update(arrival={"kind": "poisson", "rate": 16.0}, drain_s=120.0,
               block=traffic.BLOCK,
               prompt={**mix["prompt"], "median": 60, "min": 20, "max": 120},
               output={**mix["output"], "median": 8, "min": 3, "max": 24})
    return harness.Cell(CELL, 1, conf, mix, real.limits, real.end_to_end,
                        real.per_layer)


# the real model's logit scale: RMS-normed hidden states of width d times
# embedding rows of std 0.018 at d 4608
SHRINK = {"layers": 2, "d_model": 64, "heads": 4, "kv_heads": 2,
          "d_ff": 96, "vocab": 97, "init_std": 0.018 * (4608 / 64) ** 0.5}


def _run(breakage=None):
    cell = _small_cell()
    opts = harness.Options(seed=2**31 + 99, seconds=1.0, device="cpu",
                           shrink=SHRINK, num_pages=200,
                           sample=6)
    served = harness.setup(cell, opts, breakage)
    reqs = harness.requests(cell, opts, served.spec["vocab"], 2)
    rec = harness.settle(served, reqs,
                         harness.serve(served, reqs, time.perf_counter()))
    return served, rec, harness.judge(served, rec)


def _decode_wrap(served, fn):
    """Wrap every engine's paged decode step: ``fn(step, args)``."""
    for e in served.engines:
        step = e._paged_decode
        e._paged_decode = (lambda step: lambda *a: fn(step, a))(step)


def _stale_state(served):
    """A decode round whose pools come back as they were."""
    def fn(step, args):
        params, batch, states, gen = args
        keep = [{k: v.clone() for k, v in layer.items()} for layer in states]
        logits, tok, new = step(params, batch, states, gen)
        for layer, old in zip(new, keep):
            for k, v in layer.items():
                v.copy_(old[k])
        return logits, tok, new
    _decode_wrap(served, fn)


def _half_batch(served):
    """Half of the round's busy lanes are left out: they give the token
    an idle lane gives."""
    def fn(step, args):
        logits, tok, new = step(*args)
        busy = torch.nonzero(args[1]["lengths"] > 0)[:, 0]
        tok = tok.clone()
        tok[busy[len(busy) // 2:]] = 0
        return logits, tok, new
    _decode_wrap(served, fn)


def _token_altered(served):
    """Every lane's decoded token is moved to the next id."""
    vocab = served.spec["vocab"]

    def fn(step, args):
        logits, tok, new = step(*args)
        return logits, (tok + 1) % vocab, new
    _decode_wrap(served, fn)


def _chain_wrap(served, fn):
    """Wrap the chain where the placement's x_0 is made (on the CPU the
    port's ``ops.ladn_denoise`` runs ``ref.ladn_denoise_ref``)."""
    from repro_torch.kernels import ref
    chain = ref.ladn_denoise_ref
    served.probes._patch(ref, "ladn_denoise_ref",
                         lambda *a, **k: fn(chain(*a, **k)))


def _answer_altered(served):
    """The placement's denoised action is shifted where it is made."""
    _chain_wrap(served, lambda out: out + 0.05)


def _answer_nan(served):
    """The placement's denoised action comes out not a number."""
    _chain_wrap(served, lambda out: out * float("nan"))


def _actor_drifts(served):
    """The acting weights move while the window runs: each placement
    adds to the program's copy of the LADN's last bias."""
    fns = served.scheduler._fns

    def act(state, *a, **k):
        state.theta_act[-1]["b"].add_(0.05)
        return fns.act(state, *a, **k)

    served.probes._patch(served.scheduler, "_fns", fns._replace(act=act))


@pytest.fixture(scope="module")
def sound():
    return _run()


def test_sound_run_is_correct(sound):
    _, rec, checked = sound
    assert checked["numbers"]["sampled"] == 6
    assert all(v["ok"] for v in checked["verdict"].values()), checked


def test_controls_fail_the_limits(sound):
    served, rec, checked = sound
    limits = served.cell.limits["numbers"]
    low = check.logit_gap(served.cell.kind, served.weights, served.spec,
                          harness.finished(rec), "fp8")
    assert low > limits["logit_gap"]["limit"], low
    ctrl = check.control_denoise_err(rec["placements"], rec["requests"],
                                     served.actor,
                                     served.cell.conf["scheduler"])
    assert ctrl > limits["denoise_err"]["limit"], ctrl


@pytest.mark.parametrize("fault", [_stale_state, _half_batch,
                                   _token_altered, _answer_altered,
                                   _answer_nan, _actor_drifts],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(fault):
    _, _, checked = _run(fault)
    assert not all(v["ok"] for v in checked["verdict"].values()), checked
