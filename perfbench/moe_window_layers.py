"""Readings of the dropless MoE and the windowed decode (the
``moe_window`` kind's cells), and the instruments they need.

The hooks are shared by their three readers (``readers/
expert_gemm_roofline.mellum2.py``, ``window_decode_roofline.mellum2.py``,
``expert_skew.mellum2.py``), so each runs once in a traced run:

* :func:`prepare` wraps ``ops.paged_flash_decode_window`` (through
  ``served.probes._patch``) to keep each call's shapes, lengths and
  window while the profile records;
* :func:`begin` wraps each engine's paged step callables: after every
  step call made in the window, a copy on the device of the engine's
  routed-rows counter (``ServeEngine.expert_rows``, (layers, experts)
  int64, added to by every call of the port's grouped MoE path) is kept,
  with whether the profile was recording; no host read;
* :func:`collect` brings the copies to the host in one read, turns them
  into each call's rows per layer and expert (``rec["expert_calls"]``)
  and adds the window calls (``rec["window_calls"]``).

A program without the counter or the windowed op records nothing, and
every reading is then None.  The FLOPs and bytes of the two new kernels
are counted here from each call's shapes and rows.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench import roofline

# device-operation names: torch._grouped_mm's CUTLASS grouped GEMM (and
# the kernel that lays out its problem sizes), and the windowed decode's
# split and merge kernels
GROUPED_GEMM = ("GroupProblemShape", "prepare_grouped_gemm_data")
WINDOW_DECODE = ("paged_window_split_kernel", "paged_window_merge_kernel")

_STATE: Dict[str, list] = {"window": [], "snaps": [], "first": []}


def prepare(served) -> None:
    """Record the windowed decode's calls while the profile runs."""
    for v in _STATE.values():
        v.clear()
    from repro_torch.kernels import ops
    op = getattr(ops, "paged_flash_decode_window", None)
    if op is None:
        return
    probes = served.probes

    def paged_flash_decode_window(q, k_pages, v_pages, block_tables,
                                  lengths, window):
        if probes.profiling:
            # ``lengths`` is a fresh tensor of every call: read after the
            # window
            _STATE["window"].append((
                q.shape[0], q.shape[1], k_pages.shape[1], q.shape[2],
                k_pages.shape[2], block_tables.shape[1], lengths,
                int(window), q.element_size()))
        return op(q, k_pages, v_pages, block_tables, lengths, window)

    probes._patch(ops, "paged_flash_decode_window",
                  paged_flash_decode_window)


def begin(served) -> None:
    """Copy each engine's routed-rows counter after every step call of
    the window."""
    probes = served.probes
    for j, e in enumerate(served.engines):
        counter = getattr(e, "expert_rows", None)
        if counter is None or not getattr(e, "paged", False):
            continue
        _STATE["first"].append((j, counter.clone()))
        for attr, kind in (("_paged_prefill", "prefill"),
                           ("_paged_decode", "decode")):
            probes._patch(e, attr, _counted(getattr(e, attr), j, kind,
                                            counter, probes))


def _counted(step, j: int, kind: str, counter: torch.Tensor, probes):
    def call(*args, **kw):
        out = step(*args, **kw)
        if probes.recording:
            _STATE["snaps"].append((j, kind, probes.profiling,
                                    counter.clone()))
        return out
    return call


def collect(served, rec: Dict) -> None:
    """The calls' rows and the window decode's calls into the record."""
    snaps, first = _STATE["snaps"], dict(_STATE["first"])
    calls = []
    if snaps:
        host = torch.stack([s[3] for s in snaps]).cpu().numpy()
        last = {j: t.cpu().numpy() for j, t in first.items()}
        for (j, kind, traced, _), now in zip(snaps, host):
            calls.append((kind, traced, now - last[j]))
            last[j] = now
    rec["expert_calls"] = calls
    rec["window_calls"] = [(*c[:6], [int(x) for x in c[6].tolist()],
                            *c[7:]) for c in _STATE["window"]]
    for v in _STATE.values():
        v.clear()


# ---------------------------------------------------------------------------
# the kernels' operations and bytes
# ---------------------------------------------------------------------------


def expert_gemm_cost(rows: np.ndarray, d: int, f: int,
                     elem: int) -> List[Tuple[int, int]]:
    """(bytes, FLOPs) of one layer's two grouped products over ``rows``
    (E,) routed rows per expert: [gate | up] (d -> 2f) then down (f ->
    d).  Bytes: the weights of every expert that has a row, once, and
    each product's rows in and out; FLOPs: 2 a multiply-add."""
    n = int(rows.sum())
    touched = int((rows > 0).sum())
    up = (elem * (touched * d * 2 * f + n * (d + 2 * f)), 2 * n * d * 2 * f)
    down = (elem * (touched * f * d + n * (f + d)), 2 * n * f * d)
    return [up, down]


def window_decode_cost(B: int, H: int, KV: int, hd: int, page_size: int,
                       W: int, lengths, window: int,
                       elem: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of one ``paged_flash_decode_window`` call: q read
    and the output written, the K and V of the positions inside each
    lane's window (min(n, window), capped at the table's W x page_size),
    the table entries of the pages they lie on and the lengths; 4 FLOPs
    a head dimension a key a query head."""
    cap = W * page_size
    ctx = [min(int(n), window, cap) for n in lengths]
    pages = sum(-(-c // page_size) + 1 for c in ctx if c)
    nbytes = (2 * B * H * hd * elem + 2 * sum(ctx) * KV * hd * elem
              + 4 * pages + 4 * B)
    return nbytes, 4 * sum(ctx) * H * hd


# ---------------------------------------------------------------------------
# readings
# ---------------------------------------------------------------------------


def _kernel_s(rec: Dict, names) -> float:
    tr = rec.get("trace") or {}
    return sum(s for k, s in tr.get("kernels", {}).items()
               if any(n in k for n in names))


def expert_gemm_roofline(rec: Dict) -> Optional[float]:
    """The grouped expert products' bound time over their kernels' time,
    both in the profiled sub-window: each traced step call's rows per
    layer and expert from the counter (%)."""
    calls = [c for c in rec.get("expert_calls", ()) if c[1]]
    t = _kernel_s(rec, GROUPED_GEMM)
    if not calls or t <= 0:
        return None
    s = rec["spec"]
    elem = torch.finfo(getattr(torch, s["dtype"])).bits // 8
    bound = sum(roofline.bound_s(*cost)[0]
                for _, _, counts in calls for rows in counts if rows.any()
                for cost in expert_gemm_cost(rows, s["d_model"],
                                             s["d_expert"], elem))
    return 100.0 * bound / t


def window_decode_roofline(rec: Dict) -> Optional[float]:
    """``paged_flash_decode_window``'s bound time over its split and
    merge kernels' time in the profiled sub-window (%)."""
    calls = rec.get("window_calls")
    t = _kernel_s(rec, WINDOW_DECODE)
    if not calls or t <= 0:
        return None
    bound = sum(roofline.bound_s(*window_decode_cost(*c))[0] for c in calls)
    return 100.0 * bound / t


def expert_skew(rec: Dict) -> Optional[float]:
    """The busiest expert's routed rows over the mean expert's, for each
    layer of each step call in the window, averaged with the call's rows
    as weights (1 is an even load; the grouped product waits for the
    busiest expert)."""
    num = den = 0.0
    for _, _, counts in rec.get("expert_calls", ()):
        for rows in counts:
            n = float(rows.sum())
            if n > 0:
                num += float(rows.max()) * len(rows)
                den += n
    return num / den if den else None
