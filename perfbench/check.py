"""What decides ``correct``: the served tokens and the placements of the
timed path, held to the plain references after the window.

* ``logit_gap``: a sample of the finished requests, drawn from the seed,
  with the longest in it.  The reference, the configuration's kind's
  ``logits_at``, reads each prompt with its served tokens and gives the
  widest gap by which a served (greedy) token's logit lies below its
  best; infinite where a gap is not finite.
* ``denoise_err``: every LAD-TS placement of the window, its reverse
  chain recomputed in float64 from the harness's own actor (drawn from
  the configuration, never read back from the program), a latent store
  the reference keeps itself, and the placement's observation and draws;
  the largest distance of the kernel's x_0 from it, relative to the
  reference's largest magnitude where that passes 1.  A value that is
  not finite reads infinite.

A number above its limit in ``limits/<cell>.json``, a missing number or
a missing limit makes the run incorrect.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import decoder, ladn


def pick_sample(done: List, k: int, seed: int) -> List:
    """``k`` finished requests: the longest, the rest at random."""
    if not done:
        return []
    rng = np.random.default_rng([int(seed), 0x5EED])
    done = sorted(done, key=lambda r: r.rid)
    longest = max(done, key=lambda r: (r.prompt.shape[-1] + len(r.tokens),
                                       -r.rid))
    rest = [r for r in done if r is not longest]
    return [longest] + [rest[j] for j in rng.permutation(len(rest))[:k - 1]]


def served(req) -> np.ndarray:
    return np.concatenate([np.asarray(t).reshape(-1)
                           for t in req.tokens]).astype(np.int64)


def token_inputs(sample: List):
    """(sequences, first positions, served tokens) of the sample."""
    seqs, firsts, toks = [], [], []
    for r in sample:
        out = served(r)
        seq, first = decoder.split_tokens(
            np.asarray(r.prompt).reshape(-1), out)
        seqs.append(seq)
        firsts.append(first)
        toks.append(out)
    return seqs, firsts, toks


def logit_gap(kind, weights, spec: Dict, sample: List,
              precision: str = "fp32") -> Optional[float]:
    """The widest gap of the sample's served tokens (``precision`` fp32),
    or, for the control (``fp8``), of the token the control's logits put
    first at each of the same positions; the logits are the model kind's
    reference (``kind.logits_at``)."""
    if not sample:
        return None
    seqs, firsts, toks = token_inputs(sample)
    ref = kind.logits_at(weights, spec, seqs, firsts, "fp32")
    if precision != "fp32":
        low = kind.logits_at(weights, spec, seqs, firsts, precision)
        toks = [lo.argmax(-1) for lo in low]
        del low
    gaps = torch.cat([decoder.served_gaps(r, torch.as_tensor(
        t, device=r.device)) for r, t in zip(ref, toks)])
    if not torch.isfinite(gaps).all():
        return math.inf
    return float(gaps.max())


def placements_to_host(recs: List[Dict]) -> List[Dict]:
    """The placements' tensors on the host, one agent's row each."""
    return [{"s": p["s"][0].cpu(), "eps0": p["eps0"][0, 0].cpu(),
             "chain": p["chain"][0, 0].cpu(),
             "gumbel": p["gumbel"][0].cpu(), "x0": p["x0"][0, 0].cpu(),
             "a": int(p["a"][0])} for p in recs]


def chains(recs: List[Dict], origins: List[int], actor: Dict, sch: Dict,
           dtype) -> List[torch.Tensor]:
    """x_0 of every placement in order, worked out from the harness's
    actor alone: placement k is the k-th request's, made by its origin's
    agent for task slot k mod ``max_tasks``, from the latent that the
    reference's own store holds there; the store then keeps x_0
    standardized (population std), as the acting step does."""
    X = actor["X"].to(dtype).clone()
    out = []
    for k, (p, o) in enumerate(zip(recs, origins)):
        n = k % sch["max_tasks"]
        theta = [(w[o], b[o]) for w, b in actor["theta"]]
        x0 = ladn.denoise(theta, X[o, n], p["eps0"], p["s"], p["chain"],
                          sch["chain_steps"], sch["beta_min"],
                          sch["beta_max"], dtype)
        X[o, n] = (x0 - x0.mean()) / (x0.std(correction=0) + 1e-6)
        out.append(x0)
    return out


def _rel(x0: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest distance of x0 from the reference, over the reference's
    largest magnitude where that passes 1 (an observation far outside
    the simulator's range makes the chain's values large); infinite
    where either holds a value that is not finite."""
    x0, ref = x0.double(), ref.double()
    if not (torch.isfinite(x0).all() and torch.isfinite(ref).all()):
        return math.inf
    return float((x0 - ref).abs().max() / max(float(ref.abs().max()), 1.0))


def denoise_err(recs: List[Dict], requests: List, actor: Dict,
                sch: Dict) -> Dict:
    """``denoise_err`` over the placements, and the count whose action
    the reference draws otherwise (reported, not compared: a flip needs a
    near tie).  Every request submitted has to have been placed once."""
    if not recs or len(recs) != len(requests):
        return {"denoise_err": None, "place_disagree": 0,
                "placements": len(recs)}
    origins = [int(r.origin) for r in requests]
    ref = chains(recs, origins, actor, sch, torch.float64)
    err = max(_rel(p["x0"], x0) for p, x0 in zip(recs, ref))
    disagree = sum(ladn.action(x0, p["gumbel"]) != p["a"]
                   for p, x0 in zip(recs, ref))
    return {"denoise_err": err, "place_disagree": int(disagree),
            "placements": len(recs)}


def control_denoise_err(recs: List[Dict], requests: List, actor: Dict,
                        sch: Dict) -> Optional[float]:
    """The control's ``denoise_err``: the chain and its latent store in
    bfloat16 in the kernel's place, against the float64 reference."""
    if not recs:
        return None
    origins = [int(r.origin) for r in requests]
    ref = chains(recs, origins, actor, sch, torch.float64)
    low = chains(recs, origins, actor, sch, torch.bfloat16)
    return max(_rel(lo, x0) for lo, x0 in zip(low, ref))


def verdict(numbers: Dict[str, Optional[float]], limits: Dict) -> Dict:
    """{name: {"value", "limit", "ok"}} for every number the limits file
    compares; a number or a limit that is missing fails."""
    out = {}
    for name, lim in limits.get("numbers", {}).items():
        v = numbers.get(name)
        limit = lim.get("limit")
        ok = v is not None and limit is not None and v <= limit
        out[name] = {"value": v, "limit": limit, "ok": bool(ok)}
    return out
