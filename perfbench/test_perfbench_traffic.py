"""The traffic generator: the same seed gives the same requests, every
seed the same work in another order, and the mixes hit their stated
medians, clips and rates."""
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import traffic

MIXES = Path(__file__).resolve().parent / "traffic"
MIX_NAMES = sorted(p.stem for p in MIXES.glob("*.json"))


def _mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIX_NAMES)
def test_same_seed_same_requests(name):
    a = traffic.generate(_mix(name), 20.0, 2**31 + 17, 1000, 2, n=200)
    b = traffic.generate(_mix(name), 20.0, 2**31 + 17, 1000, 2, n=200)
    for x, y in zip(a, b):
        assert x["arrival_s"] == y["arrival_s"]
        assert np.array_equal(x["prompt"], y["prompt"])
        assert x["max_new_tokens"] == y["max_new_tokens"]


@pytest.mark.parametrize("name", MIX_NAMES)
def test_every_seed_same_work_in_another_order(name):
    """Each block of requests holds the same lengths whatever the seed."""
    size = traffic.block(_mix(name))
    n = 2 * size
    a = traffic.generate(_mix(name), 20.0, 1, 1000, 2, n=n)
    b = traffic.generate(_mix(name), 20.0, 2**32 + 5, 1000, 2, n=n)
    for lo in (0, size):
        for key in ("max_new_tokens", "origin"):
            assert sorted(r[key] for r in a[lo:lo + size]) == \
                sorted(r[key] for r in b[lo:lo + size])
        assert sorted(len(r["prompt"]) for r in a[lo:lo + size]) \
            == sorted(len(r["prompt"]) for r in b[lo:lo + size])
    assert [len(r["prompt"]) for r in a] != [len(r["prompt"]) for r in b]


@pytest.mark.parametrize("size", [8, 16, traffic.BLOCK])
def test_the_mix_names_its_block(size):
    """A mix's ``block`` sets how many arrivals hold the same work: each
    run of that many, from its start, has the same lengths, gaps and
    edges as any other, on any seed; a mix that names none has blocks
    of ``BLOCK``."""
    mix = {k: v for k, v in _mix(MIX_NAMES[0]).items() if k != "block"}
    if size != traffic.BLOCK:
        mix["block"] = size
    assert traffic.block(mix) == size
    reqs = traffic.generate(mix, 20.0, 2**31 + 3, 1000, 2, n=4 * size)
    other = traffic.generate(mix, 20.0, 9, 1000, 2, n=4 * size)
    t = np.array([r["arrival_s"] for r in reqs] + [20.0])
    t2 = np.array([r["arrival_s"] for r in other] + [20.0])
    for lo in range(0, 4 * size, size):
        blk = slice(lo, lo + size)
        for key in ("max_new_tokens", "origin"):
            assert sorted(r[key] for r in reqs[blk]) == \
                sorted(r[key] for r in other[blk])
        assert sorted(len(r["prompt"]) for r in reqs[blk]) == \
            sorted(len(r["prompt"]) for r in other[blk])
        assert np.allclose(np.sort(np.diff(t)[blk]), np.sort(np.diff(t2)[blk]))
        assert [len(r["prompt"]) for r in reqs[blk]] != \
            [len(r["prompt"]) for r in other[blk]]


@pytest.mark.parametrize("name", MIX_NAMES)
def test_medians_and_clips(name):
    mix = _mix(name)
    reqs = traffic.generate(mix, 20.0, 3, 1000, 2, n=8 * traffic.BLOCK)
    plen = np.array([len(r["prompt"]) for r in reqs])
    out = np.array([r["max_new_tokens"] for r in reqs])
    for vals, dist in ((plen, mix["prompt"]), (out, mix["output"])):
        assert vals.min() >= dist["min"] and vals.max() <= dist["max"]
        assert abs(np.median(vals) - dist["median"]) <= 0.02 * dist["median"]


@pytest.mark.parametrize("name", MIX_NAMES)
def test_open_loop_rate_and_backlog(name):
    """An open loop's arrivals: rate x seconds of them over [0, seconds),
    in order; no other kind (a backlog among them) is taken."""
    mix = _mix(name)
    reqs = traffic.generate(mix, 30.0, 5, 1000, 2)
    assert len(reqs) == round(mix["arrival"]["rate"] * 30.0)
    t = np.array([r["arrival_s"] for r in reqs])
    assert t[0] == 0.0 and t[-1] < 30.0 and np.all(np.diff(t) >= 0)
    gaps = np.diff(t) / (30.0 / len(reqs))
    assert abs(gaps.mean() - 1.0) < 0.05
    with pytest.raises(ValueError):
        traffic.count({"arrival": {"kind": "backlog", "depth": 8}}, 30.0)
