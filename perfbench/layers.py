"""Readings shared by the per-layer metrics' readers (``readers/``):
each takes the run's record and gives a number, or None where the run
holds nothing to read."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from perfbench import roofline


def _mean(xs) -> Optional[float]:
    xs = list(xs)
    return float(np.mean(xs)) if xs else None


def delays_s(rec: Dict) -> np.ndarray:
    """Arrival-to-last-token seconds of every request due in the window:
    a request still unfinished when the drain ended counts the time up to
    then (a lower bound)."""
    close = rec["t0"] + rec["close"]
    return np.array([(r.t_finish if r.done else close) - r.t_arrival
                     for r in rec["requests"]], dtype=np.float64)


def host_ms(calls) -> Optional[float]:
    """Mean host milliseconds of the window's calls (``Probes`` keeps no
    warm-up call) made outside the profiled sub-window (the profiler
    slows the host inside it)."""
    return _mean(d * 1e3 for _, d, traced in calls if not traced)


def service_p95_ms(rec: Dict) -> Optional[float]:
    """The 95th percentile of the same delays, over every request."""
    d = delays_s(rec)
    return float(np.percentile(d, 95) * 1e3) if d.size else None


def place_ms(rec: Dict) -> Optional[float]:
    return _mean(d * 1e3 for d, traced in rec["place"] if not traced)


def engine_skew(rec: Dict) -> Optional[float]:
    placed = [r.engine_id for r in rec["requests"] if r.engine_id is not None]
    if not placed:
        return None
    return max(np.bincount(placed)) / len(placed)


def queue_ms(rec: Dict) -> Optional[float]:
    return _mean(r.queue_s * 1e3 for r in rec["requests"]
                 if r.t_prefill_start is not None)


def idle_share(rec: Dict) -> Optional[float]:
    tr = rec.get("trace")
    if not tr or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def _kernel_s(rec: Dict, *names: str) -> float:
    tr = rec.get("trace") or {}
    return sum(s for k, s in tr.get("kernels", {}).items()
               if any(n in k for n in names))


def flash_attention_roofline(rec: Dict) -> Optional[float]:
    """The calls' bound times over the ``flash_attention`` kernels' time,
    both in the profiled sub-window."""
    t = _kernel_s(rec, "flash_attention_mma", "flash_attention_tf32")
    if not rec["attn_calls"] or t <= 0:
        return None
    bound = sum(roofline.bound_s(*roofline.flash_attention_cost(*c))[0]
                for c in rec["attn_calls"])
    return 100.0 * bound / t


def paged_decode_roofline(rec: Dict) -> Optional[float]:
    """The same for ``paged_flash_decode``'s split and merge kernels; the
    bytes are the pages the lanes' lengths reference."""
    t = _kernel_s(rec, "paged_decode_split_kernel",
                  "paged_decode_merge_kernel")
    if not rec["paged_calls"] or t <= 0:
        return None
    bound = sum(roofline.bound_s(*roofline.paged_decode_cost(*c))[0]
                for c in rec["paged_calls"])
    return 100.0 * bound / t


def model_flops(rec: Dict) -> float:
    """Model FLOPs of the work the run did, as the model kind counts them
    (``rec["kind"].flops``): the prompt tokens prefilled (past any cached
    prefix) and the tokens decoded, positions ``prefix .. prompt +
    served - 2``.  A prompt counts once its last chunk ran (its first
    token was produced)."""
    spec, flops, total = rec["spec"], rec["kind"].flops, 0.0
    for r in rec["requests"]:
        n = len(r.tokens)
        if not n:
            continue
        total += flops(spec, r.prefix_tokens, r.prompt.shape[-1] + n - 1)
    return total


def mfu(rec: Dict) -> Optional[float]:
    """Model FLOPs over the seconds the cluster spent stepping, against
    the bf16 peak."""
    busy = sum(d for _, d, _ in rec["steps"])
    if busy <= 0:
        return None
    return 100.0 * model_flops(rec) / (busy * roofline.PEAK_FLOPS_BF16)
