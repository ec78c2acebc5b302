"""A configuration file, and the LAD-TS actor that places its requests.

What belongs to the model (its shape, the port's ``ModelConfig``, its
weights, its reference and FLOPs) is the configuration's kind's, in
``models/<kind>.py`` (``harness.model_kind``).  The actor is drawn here
(``make_actor``), from the configuration's fixed ``actor_seed``, and
handed to the scheduler and to the reference alike.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List

import torch

from perfbench.reference import ladn


def load(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


def make_actor(sch: Dict, device) -> Dict:
    """The LAD-TS actor of the configuration's ``scheduler`` block, one
    agent per origin station, from its ``actor_seed`` on ``device``:
    ``theta``, the LADN's layers [{"w" (G, in, out), "b" (G, out)}] drawn
    U(-1/sqrt(in), 1/sqrt(in)) (the port's and the paper's MLP rule), and
    ``X`` (G, max_tasks, A), the latent action store, N(0, 1).  The same
    for every run: the deployed policy stands in for a trained one as the
    model's random weights stand in for a checkpoint."""
    gen = torch.Generator(device=device).manual_seed(int(sch["actor_seed"]))
    G, A = sch["stations"], sch["engines"]
    dims = (A + ladn.TIME_EMBED_DIM + sch["state_dim"], *sch["hidden"], A)
    theta: List[Dict[str, torch.Tensor]] = []
    for nin, nout in zip(dims[:-1], dims[1:]):
        lim = 1.0 / math.sqrt(nin)
        layer = {}
        for key, shape in (("w", (G, nin, nout)), ("b", (G, nout))):
            t = torch.empty(shape, device=device)
            t.uniform_(-lim, lim, generator=gen)
            layer[key] = t
        theta.append(layer)
    X = torch.empty((G, sch["max_tasks"], A), device=device)
    X.normal_(0.0, 1.0, generator=gen)
    return {"theta": theta, "X": X}
