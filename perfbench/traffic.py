"""The one traffic generator: a mix file's parameters to requests.

A mix is a JSON file under ``traffic/``: the arrival process
(``poisson`` at a rate), lognormal or fixed prompt and output lengths
(median, sigma, clips) and the drain after the window.  Every seed gets
the same work in another order: lengths, gaps between arrivals and home
edges are stratified in blocks of the mix's ``block`` requests
(``BLOCK`` where it names none; each block holds the same quantiles of
each distribution), and the seed shuffles each block and draws the
tokens.  A smaller block spreads the same work more evenly over time, so
the seed's order moves the queue less.
So any leading part of a run's requests, and so any window, carries
about the same work whatever the seed.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List, Optional

import numpy as np

BLOCK = 64


def load(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


def _quantiles(dist: Dict, n: int) -> np.ndarray:
    """``n`` stratified draws (the quantiles at (i + 0.5) / n) of a length
    distribution, rounded and clipped to [min, max]."""
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        v = dist["median"] * np.exp(dist["sigma"] * z)
    elif dist["dist"] == "fixed":
        v = np.full(n, float(dist["value"]))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(v), dist["min"], dist["max"]).astype(np.int64)


def block(mix: Dict) -> int:
    """Requests a block of the mix holds."""
    return int(mix.get("block", BLOCK))


def _block_plan(mix: Dict, edges: int) -> Dict[str, np.ndarray]:
    """One block's multiset of prompt and output lengths, arrival gaps
    (in units of the mean gap) and home edges."""
    n = block(mix)
    u = (np.arange(n) + 0.5) / n
    return {"prompt": _quantiles(mix["prompt"], n),
            "output": _quantiles(mix["output"], n),
            "origin": np.arange(n) % edges,
            "gap": -np.log1p(-u)}                 # Exp(1) quantiles


def count(mix: Dict, seconds: float) -> int:
    """Requests a run of ``seconds`` draws: rate x seconds."""
    arr = mix["arrival"]
    if arr["kind"] != "poisson":
        raise ValueError(f"unknown arrival kind {arr['kind']!r}")
    return max(1, int(round(arr["rate"] * seconds)))


def generate(mix: Dict, seconds: float, seed: int, vocab: int,
             edges: int, n: Optional[int] = None) -> List[Dict]:
    """The run's requests in arrival order: dicts of ``rid``,
    ``arrival_s`` (seconds after the first due arrival, spanning
    [0, seconds)), ``origin``, ``prompt`` (int32 ids) and
    ``max_new_tokens``."""
    n = count(mix, seconds) if n is None else n
    rng = np.random.default_rng(int(seed))
    plan = _block_plan(mix, edges)
    size = block(mix)
    cols = {k: np.concatenate([v[rng.permutation(size)]
                               for _ in range(math.ceil(n / size))])[:n]
            for k, v in plan.items()}
    gaps = cols["gap"]
    t = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    arrival = t * (seconds / gaps.sum())
    return [{"rid": i, "arrival_s": float(arrival[i]),
             "origin": int(cols["origin"][i]),
             "prompt": rng.integers(0, vocab, int(cols["prompt"][i]),
                                    dtype=np.int64).astype(np.int32),
             "max_new_tokens": int(cols["output"][i])}
            for i in range(n)]
