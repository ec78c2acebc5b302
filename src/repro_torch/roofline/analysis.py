"""Roofline analysis from the dry run's counting pass.

Port of ``repro/roofline/analysis.py``.  Three terms per (arch x shape x
mesh), in seconds, over the H100's peaks (``launch/mesh.py``):

    compute    = flops      / PEAK_FLOPS_BF16
    memory     = bytes      / HBM_BW
    collective = coll_bytes / NVLINK_BW

The reference reads its numbers from XLA: ``cost_analysis()`` of the
compiled step, and the collectives and while-loop trip counts of its
optimized HLO.  The port has no compiler to ask.  It runs the step once
instead, eagerly, on fake tensors (``FakeTensorMode``: shapes and dtypes,
no storage) under :class:`CountingMode`, a ``TorchDispatchMode`` that
sees every aten op the step dispatches and tallies per op:

* FLOPs, from ``torch.utils.flop_counter``'s formulas (what
  ``FlopCounterMode`` counts: matmuls, convolutions, attention);
* bytes written: every non-view op's outputs once (an in-place or
  ``out=`` op at most the bytes of its largest input, e.g. the values an
  ``index_put_`` scatters; allocations that write nothing count 0; a
  collective, a ``c10d`` op, its outputs on this rank: an all-gather
  the gathered tensor).

``bytes`` is then the written bytes plus the arguments read once: a
lower bound on the eager step's HBM traffic.  Python loops whose
iterations run the same ops (the RG-LRU and xLSTM prompt recurrences,
the train step's microbatches) run two iterations, the second weighted
by the rest of the trip count (``roofline/hooks.py::trips``), as the
reference scales its while bodies: the counts equal the full loop's,
except that a recurrence differentiated after its loop misses the
gradient sums autograd's engine adds between steps (no FLOPs; its bytes
stay a lower bound).  The attention kernels'
plain versions count their FLOPs, as the reference's dot walk does,
but write only the kernel's output (``hooks.kernel_call``): the card
runs the kernel, which keeps scores and probabilities on chip.

``MODEL_FLOPS`` = 6*N*D (train) or 2*N*D (inference), N = active params
— the "useful compute" yardstick, a copy of the reference's.
"""
from __future__ import annotations

import json
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.hooks import COUNT

# allocations, and ``_unsafe_view`` (a view its schema does not mark):
# their output is not written by the op
_NO_WRITE = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "lift_fresh", "_unsafe_view"}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def written_bytes(func, args, kwargs, out) -> int:
    """The bytes one call of aten op ``func`` writes (see the module
    docstring)."""
    if func.is_view or func.overloadpacket.__name__ in _NO_WRITE:
        return 0
    n = sum(nbytes(t) for t in _tensors(out))
    if func.namespace == "c10d":
        return n
    schema = func._schema
    mutated = {a.name for a in schema.arguments
               if a.alias_info is not None and a.alias_info.is_write}
    if not mutated:
        return n
    readers = []
    for i, a in enumerate(schema.arguments):
        if a.name in mutated:
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        readers += [nbytes(t) for t in _tensors(v)]
    return min(n, max(readers)) if readers else n


class CountingMode(TorchDispatchMode):
    """Tallies every aten op dispatched inside it: ``tallies[op] =
    [calls, flops, bytes written]``, each weighted by the loop-trip
    scale current when the op ran."""

    def __init__(self):
        super().__init__()
        self.tallies: Dict[str, List[int]] = {}
        # kernel name -> {its call's shapes (JSON) -> calls}
        self.calls: Dict[str, Dict[str, int]] = {}

    def call(self, name: str, desc: dict) -> None:
        key = json.dumps(desc, sort_keys=True)
        seen = self.calls.setdefault(name, {})
        seen[key] = seen.get(key, 0) + COUNT.scale

    def add(self, name: str, flops: int, written: int) -> None:
        w = COUNT.scale
        t = self.tallies.setdefault(name, [0, 0, 0])
        t[0] += w
        t[1] += flops * w
        t[2] += written * w

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":        # metadata queries, no kernel
            return out
        formula = flop_registry.get(func.overloadpacket)
        flops = int(formula(*args, **kwargs, out_val=out)) if formula else 0
        self.add(str(func), flops, 0 if COUNT.in_kernel else
                 written_bytes(func, args, kwargs, out))
        return out


def count_ops(fn, *args, shortcut: bool = True, calls=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under :class:`CountingMode` with the
    loop shortcut on (``shortcut``) or off; returns (its output, the
    tallies).  ``calls`` (a dict) receives the kernel calls' shapes:
    kernel name -> {shapes as JSON -> calls, trip-weighted}.  Fake-tensor
    inputs must be used inside their own mode: call this inside it."""
    if COUNT.add is not None:
        raise RuntimeError("a counting pass is already running")
    mode = CountingMode()
    COUNT.add, COUNT.call, COUNT.shortcut = mode.add, mode.call, shortcut
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        COUNT.add, COUNT.call = None, None
        COUNT.shortcut, COUNT.scale = False, 1
    if calls is not None:
        calls.update(mode.calls)
    return out, mode.tallies


def totals(tallies: Dict[str, List[int]]) -> Dict[str, int]:
    """Ops dispatched, FLOPs and bytes written over all tallies."""
    return {"n_ops": sum(t[0] for t in tallies.values()),
            "flops": sum(t[1] for t in tallies.values()),
            "written_bytes": sum(t[2] for t in tallies.values())}


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS
# ---------------------------------------------------------------------------


def model_flops(cfg, shape) -> float:
    """6*N_active*D for training, 2*N_active*D for inference."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def roofline_terms(flops: float, bytes_: float, coll_bytes: float,
                   chips: int, peak_flops: float, hbm_bw: float,
                   link_bw: float) -> Dict[str, object]:
    """Three roofline terms in seconds, from one rank's work (``chips``
    is kept for the reference's signature), and the largest."""
    compute = flops / peak_flops
    memory = bytes_ / hbm_bw
    collective = coll_bytes / link_bw
    dom = max([("compute", compute), ("memory", memory),
               ("collective", collective)], key=lambda kv: kv[1])
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "bottleneck": dom[0],
    }
