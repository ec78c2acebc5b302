"""Per-engine capability descriptors: the live f_b' / rho_n.

The port's copy of ``repro/workload/capability.py``.

The paper parameterises heterogeneity through per-ES capacity f_b'
(Gcycles/s) and per-task computing density rho_n (Gcycles/step).  On a
live heterogeneous fleet those quantities are real and measurable:

  * ``rho_gcycles`` — per-generated-token cost of THIS engine's model,
    from the config's analytic active-parameter count (2 FLOPs/param
    per token): the model-complexity term the paper calls rho_n.
  * ``tok_s``       — measured decode throughput (1 / EWMA round time)
    once the engine has served anything, else an analytic cold prior:
    the live f_b'.

``EngineCapability`` is a snapshot; ``ServeEngine.capability`` builds a
fresh one on demand so ``tok_s`` tracks the EWMA.  The cluster's
extended observation derives its model-affinity feature from
``est_token_seconds`` (= 1 / tok_s).
"""
from __future__ import annotations

import dataclasses


# Nominal device throughput for the cold-start prior (FLOPs/s).  Only the
# RELATIVE cost across engines matters to the scheduler: the prior makes a
# 3B model look ~10x slower per token than a 350M one before any
# measurement exists, and the EWMA replaces it after the first round.
COLD_FLOPS = 25e9


@dataclasses.dataclass(frozen=True)
class EngineCapability:
    """Snapshot of one engine's serving capability."""

    arch: str                 # registry arch id (e.g. "qwen2-1.5b")
    model_name: str           # cfg.name (e.g. "qwen2-1.5b-smoke")
    num_layers: int
    d_model: int
    active_params: int        # params touched per generated token
    rho_gcycles: float        # per-token cost (Gcycles): live rho_n
    tok_s: float              # decode throughput (tokens/s): live f_b'
    measured: bool            # tok_s from EWMA (True) or cold prior
    paged: bool               # serves from the shared KV page pool
    # prefix caching (repro.serving.paged_kv): what fraction of this
    # engine's admissions reused cached prompt KV, and how many prompt
    # tokens it currently holds resident — the expected-prefix-hit
    # signal the prefix-affinity scheduler routes on (0 for dense /
    # cache-off engines)
    prefix_hit_rate: float = 0.0
    prefix_cached_tokens: int = 0

    @property
    def token_seconds(self) -> float:
        return 1.0 / max(self.tok_s, 1e-9)


def cold_token_seconds(cfg) -> float:
    """Analytic per-token decode time prior for an unmeasured engine."""
    return max(2.0 * cfg.active_param_count() / COLD_FLOPS, 1e-9)
