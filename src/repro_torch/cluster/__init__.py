"""Edge-cluster layer: requests and traces, baseline schedulers, and the
live closed loop over serving engines (port of ``repro.cluster``)."""
from repro_torch.cluster.live import EdgeCluster, LiveObsConfig
from repro_torch.cluster.request import Request, poisson_trace, summarize
from repro_torch.cluster.schedulers import (BASELINES, Scheduler,
                                            make_scheduler)

__all__ = ["BASELINES", "EdgeCluster", "LiveObsConfig", "Request",
           "Scheduler", "make_scheduler", "poisson_trace", "summarize"]
