"""Edge-cluster layer: requests and traces, baseline and learned
schedulers, the simulator's evaluation loop, and the live closed loop over
serving engines (port of ``repro.cluster``)."""
from repro_torch.cluster.live import EdgeCluster, LiveObsConfig
from repro_torch.cluster.request import Request, poisson_trace, summarize
from repro_torch.cluster.schedulers import (BASELINES, PolicyScheduler,
                                            Scheduler, make_scheduler)

__all__ = ["BASELINES", "EdgeCluster", "LiveObsConfig", "PolicyScheduler",
           "Request", "Scheduler", "make_scheduler", "poisson_trace",
           "summarize"]
