"""Request lifecycle type shared by the simulator and the live engines.

The port's copy of ``repro/cluster/request.py``.  ``poisson_trace``
draws prompt tokens with numpy (see its docstring).

A :class:`Request` is the serving-side twin of one AIGC task (paper
Eqn 2): the prompt is the uploaded input d_n, ``max_new_tokens`` is the
quality demand z_n (denoising steps / tokens to generate), and the four
timestamps decompose the measured service delay exactly:

    queue_s   = t_prefill_start - t_enqueue        (T_wait, Eqn 3)
    prefill_s = t_prefill_end   - t_prefill_start  (to the first token)
    decode_s  = t_finish        - t_prefill_end    (generation compute)
    total_s   = queue_s + prefill_s + decode_s     (== t_finish - t_enqueue)

``prefill_s`` is more than the prompt's own compute.  It runs from the
dispatch of the prompt's prefill (on the paged path its first chunk) to
the first token on the host: ``t_prefill_end`` is stamped in
``ServeEngine.collect`` after the step's blocking copy.  On the paged
path that spans every step the prompt's chunks shared with other lanes'
chunks and decode rounds.

``arrival_s`` is the request's offset in a replayed trace; ``t_arrival``
is stamped by the closed-loop driver so ``service_s`` additionally counts
any scheduler-side wait before the engine ever saw the request.

QoS (``repro.workload``): ``qos`` carries the request's service class
(duck-typed — anything with ``name`` / ``priority`` / ``deadline_s``),
``deadline_s`` is the ABSOLUTE trace-relative deadline (``arrival_s`` +
the class budget, so deadlines are monotone with arrival inside a
class), and ``missed`` is stamped at finish time by
:meth:`Request.finish`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(eq=False)   # identity semantics: field-wise eq
class Request:                     # would compare prompt arrays
    rid: int
    prompt: Any                       # (1, S) tokens or (1, K, S) audio
    max_new_tokens: int
    arrival_s: float = 0.0            # trace-relative arrival offset
    origin: int = 0                   # home BS / edge index
    patches: Any = None               # (1, P, D) vision patches or None

    # QoS (repro.workload) -------------------------------------------------
    qos: Any = None                   # service class (QoSClass-like)
    deadline_s: Optional[float] = None  # absolute trace-relative deadline
    model_pref: Optional[str] = None  # preferred arch id
    missed: Optional[bool] = None     # stamped by finish()

    # fault tolerance (repro.faults) ---------------------------------------
    attempts: int = 0                 # placements so far (1 = first try)
    status: str = "pending"           # pending | ok | failed | abandoned
    t_orphaned: Optional[float] = None  # stamped when a crash orphans it
    fail_reason: Optional[str] = None   # last failure/abandon cause

    # lifecycle (engine clock, absolute seconds) ---------------------------
    t_arrival: Optional[float] = None       # stamped by the cluster driver
    t_enqueue: Optional[float] = None       # admitted to an engine queue
    t_prefill_start: Optional[float] = None
    t_prefill_end: Optional[float] = None
    t_finish: Optional[float] = None

    engine_id: Optional[int] = None
    tokens: List[np.ndarray] = dataclasses.field(default_factory=list)
    # prefix caching (repro.serving.paged_kv): prompt tokens whose KV was
    # reused from the engine's prefix cache on the SERVING attempt —
    # prefill compute the request never paid
    prefix_tokens: int = 0

    # ------------------------------------------------------------------
    @property
    def done(self) -> bool:
        return self.t_finish is not None

    @property
    def queue_s(self) -> float:
        return self.t_prefill_start - self.t_enqueue

    @property
    def prefill_s(self) -> float:
        return self.t_prefill_end - self.t_prefill_start

    @property
    def decode_s(self) -> float:
        return self.t_finish - self.t_prefill_end

    @property
    def total_s(self) -> float:
        """Engine-side service delay (== queue_s+prefill_s+decode_s)."""
        return self.t_finish - self.t_enqueue

    @property
    def service_s(self) -> float:
        """End-to-end delay from trace arrival (falls back to total_s)."""
        t0 = self.t_arrival if self.t_arrival is not None else self.t_enqueue
        return self.t_finish - t0

    # -- QoS helpers ---------------------------------------------------
    @property
    def priority(self) -> float:
        return float(getattr(self.qos, "priority", 1.0) or 1.0)

    @property
    def deadline_budget_s(self) -> Optional[float]:
        """Allowed service time (deadline relative to arrival)."""
        if self.deadline_s is None:
            return None
        return self.deadline_s - self.arrival_s

    @property
    def terminal(self) -> bool:
        """Request reached a final state (ok / failed / abandoned)."""
        return self.status in ("ok", "failed", "abandoned")

    def finish(self, t: float) -> None:
        """Stamp completion and resolve the deadline verdict."""
        self.t_finish = t
        self.status = "ok"
        budget = self.deadline_budget_s
        if budget is not None:
            self.missed = bool(self.service_s > budget)

    # -- fault-tolerance helpers ---------------------------------------
    def reset_for_retry(self) -> None:
        """Clear per-attempt state before a re-placement.

        Tokens and the engine-side timestamps belong to the failed
        attempt — a retried request must regenerate from scratch (no
        duplicated completions, no torn token streams).  ``t_arrival``
        survives so end-to-end delay and the watchdog keep counting from
        the ORIGINAL arrival across attempts.
        """
        self.tokens = []
        self.t_enqueue = None
        self.t_prefill_start = None
        self.t_prefill_end = None
        self.t_finish = None
        self.engine_id = None
        self.missed = None
        self.prefix_tokens = 0

    def give_up(self, status: str, reason: str) -> None:
        """Terminal failure: ``failed`` (retries exhausted) or
        ``abandoned`` (watchdog).  Leaves ``t_finish`` unset so the
        request never enters delay percentiles."""
        if status not in ("failed", "abandoned"):
            raise ValueError(f"not a terminal failure status: {status!r}")
        self.status = status
        self.fail_reason = reason


def poisson_trace(num_requests: int, rate: float, prompt_len: int,
                  max_new_tokens: int, vocab_size: int, *,
                  num_origins: int = 1, min_new_tokens: int = 1,
                  num_codebooks: int = 0, seed: int = 0,
                  qos_mix: Optional[Sequence[Tuple[Any, float]]] = None,
                  prefix_len: int = 0, prefix_frac: float = 0.0
                  ) -> List[Request]:
    """Poisson arrival trace with heterogeneous decode demand.

    Inter-arrival times are Exp(rate); the per-request generation length is
    U[min_new_tokens, max_new_tokens] — the z_n quality-demand analog that
    makes continuous batching matter (short requests should overtake long
    ones mid-flight).  Prompt length is fixed so one prefill compile serves
    the whole trace.

    With ``qos_mix`` (a sequence of ``(QoSClass, weight)`` pairs) each
    request additionally draws a service class: the generation length
    comes from the class ``z_range``, ``deadline_s`` becomes the absolute
    arrival-relative deadline (``arrival + class budget``; best-effort
    classes get none), ``model_pref`` passes through, and a per-class
    ``prompt_len`` overrides the trace-level prompt length.

    With ``prefix_len > 0`` and ``prefix_frac > 0``, a deterministic
    fraction of requests share one seeded "system prompt": their first
    ``min(prefix_len, plen)`` tokens are replaced by a common prefix
    drawn once per trace — the shared-prefix workload that prefix-cached
    engines can serve without re-prefilling.  With the defaults
    (``prefix_len=0``) the generator consumes the exact same random
    stream as before, so prefix-free traces are bit-identical to
    pre-prefix behavior.

    Arrivals, classes, generation lengths, deadlines, model preferences,
    prompt lengths, origins and the prefix draw come from
    ``np.random.default_rng(seed)`` in the reference's order, so they
    equal the reference's exactly.  Prompt tokens come from a per-request
    numpy generator seeded ``seed * 100_003 + r`` (the shared prefix from
    ``seed * 77_003 + 13``): the same seeds as the reference's
    ``jax.random`` keys, but NOT the same tokens.
    """
    rng = np.random.default_rng(seed)
    classes, probs = None, None
    if qos_mix:
        # imported here: repro_torch.workload imports this module
        from repro_torch.workload.qos import normalized_weights
        classes, probs = normalized_weights(qos_mix)
    shared = None
    if prefix_len > 0 and prefix_frac > 0:
        pshape = ((1, num_codebooks, prefix_len) if num_codebooks
                  else (1, prefix_len))
        shared = np.random.default_rng(seed * 77_003 + 13).integers(
            0, vocab_size, pshape, dtype=np.int32)
    t = 0.0
    reqs = []
    for r in range(num_requests):
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        qos = deadline = pref = None
        plen = prompt_len
        if classes is not None:
            qos = classes[int(rng.choice(len(classes), p=probs))]
            lo, hi = qos.z_range
            new_tokens = int(rng.integers(lo, hi + 1))
            budget = float(getattr(qos, "deadline_s", math.inf))
            if math.isfinite(budget):
                deadline = t + budget
            pref = getattr(qos, "model_pref", None)
            if getattr(qos, "prompt_len", None):
                plen = int(qos.prompt_len)
        else:
            new_tokens = int(rng.integers(min_new_tokens,
                                          max_new_tokens + 1))
        shape = ((1, num_codebooks, plen) if num_codebooks
                 else (1, plen))
        prompt = np.random.default_rng(seed * 100_003 + r).integers(
            0, vocab_size, shape, dtype=np.int32)
        if shared is not None and rng.random() < prefix_frac:
            L = min(prefix_len, plen)
            prompt = np.concatenate([shared[..., :L], prompt[..., L:]],
                                    axis=-1)
        reqs.append(Request(
            rid=r, prompt=prompt,
            max_new_tokens=new_tokens,
            arrival_s=t,
            origin=int(rng.integers(0, num_origins)),
            qos=qos, deadline_s=deadline, model_pref=pref))
    return reqs


def _delay_stats(delays: np.ndarray) -> Dict[str, float]:
    if delays.size == 0:
        return {"mean_s": 0.0, "p50_s": 0.0, "p95_s": 0.0, "p99_s": 0.0,
                "max_s": 0.0}
    return {"mean_s": float(delays.mean()),
            "p50_s": float(np.percentile(delays, 50)),
            "p95_s": float(np.percentile(delays, 95)),
            "p99_s": float(np.percentile(delays, 99)),
            "max_s": float(delays.max())}


def _is_missed(r: Request) -> bool:
    """Deadline verdict, robust to unfinished requests."""
    if r.deadline_s is None:
        return False
    if r.missed is not None:
        return bool(r.missed)
    if not r.done:
        return True          # still unfinished at summary time -> late
    budget = r.deadline_budget_s
    return bool(r.service_s > budget)


def _status_stats(reqs: Sequence[Request]) -> Dict[str, float]:
    """Terminal-status breakdown: goodput under faults, made visible.

    ``completion_rate`` is completed / non-abandoned — the chaos
    acceptance metric: watchdog-shed requests are deliberate load
    shedding, anything else must finish.  Abandoned and failed requests
    never carry a ``t_finish``, so they can never leak into the delay
    percentiles.
    """
    completed = sum(r.status == "ok" for r in reqs)
    failed = sum(r.status == "failed" for r in reqs)
    abandoned = sum(r.status == "abandoned" for r in reqs)
    non_abandoned = len(reqs) - abandoned
    return {"completed": completed, "failed": failed,
            "abandoned": abandoned,
            "retries": int(sum(max(r.attempts - 1, 0) for r in reqs)),
            "retried": sum(r.attempts > 1 for r in reqs),
            "completion_rate": (completed / non_abandoned
                                if non_abandoned else 1.0)}


def summarize(requests: Sequence[Request]) -> dict:
    """Delay percentiles + QoS + terminal-status accounting.

    Robust to an empty list and to requests that never started (or never
    finished) service: only requests with a full ``service_s`` enter the
    delay percentiles; the rest are counted in ``unfinished`` (and count
    as deadline misses when they carry one).  An ABANDONED request's
    delay is never counted into p50/p95/p99 — shedding is not serving.
    When any request has a QoS class, a per-class breakdown
    (p50/p95/p99, deadline-miss rate, priority-weighted goodput share,
    status counts) is attached under ``"classes"``.
    """
    def served(r: Request) -> bool:
        return (r.t_finish is not None
                and (r.t_arrival is not None or r.t_enqueue is not None))

    reqs = list(requests)
    done = [r for r in reqs if served(r)]
    delays = np.asarray([r.service_s for r in done], np.float64)

    out = {"count": int(delays.size),
           "unfinished": int(len(reqs) - len(done)),
           **_status_stats(reqs),
           **_delay_stats(delays)}

    # prefix-cache efficiency: prompt tokens whose prefill was skipped
    # (cache hit) and the fraction of served requests that hit at all —
    # schedulers are compared on cache efficiency, not just delay
    out["prefill_tokens_saved"] = int(
        sum(getattr(r, "prefix_tokens", 0) or 0 for r in reqs))
    out["prefix_hit_rate"] = (
        sum(1 for r in done if getattr(r, "prefix_tokens", 0)) / len(done)
        if done else 0.0)

    with_deadline = [r for r in reqs if r.deadline_s is not None]
    misses = [r for r in with_deadline if _is_missed(r)]
    out["deadline_miss_rate"] = (len(misses) / len(with_deadline)
                                 if with_deadline else 0.0)
    # priority-weighted goodput: what fraction of the offered priority
    # mass finished within its deadline (no deadline == always on time)
    w_all = sum(r.priority for r in reqs)
    w_good = sum(r.priority for r in done if not _is_missed(r))
    out["weighted_goodput"] = (w_good / w_all) if w_all > 0 else 0.0

    if any(r.qos is not None for r in reqs):
        classes: Dict[str, dict] = {}
        for name in sorted({getattr(r.qos, "name", "default")
                            for r in reqs if r.qos is not None}):
            sub = [r for r in reqs
                   if getattr(r.qos, "name", "default") == name]
            sub_done = [r for r in sub if served(r)]
            sub_delays = np.asarray([r.service_s for r in sub_done],
                                    np.float64)
            sub_dl = [r for r in sub if r.deadline_s is not None]
            sub_w = sum(r.priority for r in sub)
            sub_good = sum(r.priority for r in sub_done
                           if not _is_missed(r))
            classes[name] = {
                "count": len(sub),
                "unfinished": len(sub) - len(sub_done),
                "priority": float(sub[0].priority),
                **_status_stats(sub),
                **_delay_stats(sub_delays),
                "deadline_miss_rate": (
                    sum(_is_missed(r) for r in sub_dl) / len(sub_dl)
                    if sub_dl else 0.0),
                "weighted_goodput": (sub_good / sub_w) if sub_w else 0.0,
                "prefill_tokens_saved": int(
                    sum(getattr(r, "prefix_tokens", 0) or 0 for r in sub)),
                "prefix_hit_rate": (
                    sum(1 for r in sub_done
                        if getattr(r, "prefix_tokens", 0)) / len(sub_done)
                    if sub_done else 0.0),
            }
        out["classes"] = classes
    return out
