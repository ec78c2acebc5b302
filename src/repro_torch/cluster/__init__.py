"""Edge-cluster layer: requests and traces, baseline and learned
schedulers, the simulator's evaluation loop, and the live closed loop over
serving engines (port of ``repro.cluster``)."""
from repro_torch.cluster.live import EdgeCluster, LiveObsConfig
from repro_torch.cluster.request import Request, poisson_trace, summarize
from repro_torch.cluster.schedulers import (BASELINES,
                                            DeadlineAwareScheduler,
                                            FailureAwareScheduler,
                                            JoinShortestQueueScheduler,
                                            LocalOnlyScheduler,
                                            PolicyScheduler,
                                            PrefixAffinityScheduler,
                                            RandomScheduler,
                                            RoundRobinScheduler,
                                            Scheduler, make_scheduler)
from repro_torch.cluster.simulate import (build_sim_episode,
                                          evaluate_scheduler)

__all__ = [
    "BASELINES", "DeadlineAwareScheduler", "EdgeCluster",
    "FailureAwareScheduler", "JoinShortestQueueScheduler", "LiveObsConfig",
    "LocalOnlyScheduler", "PolicyScheduler", "PrefixAffinityScheduler",
    "RandomScheduler", "Request", "RoundRobinScheduler", "Scheduler",
    "build_sim_episode", "evaluate_scheduler", "make_scheduler",
    "poisson_trace", "summarize",
]
