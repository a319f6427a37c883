"""Pluggable scheduling: policies + online runtime predictors.

The architectural seam between "what to run next" and the three dispatch
layers that need an answer — the live `Executor`, the UM-Bridge
`LoadBalancer` facade, and the discrete-event `simulate_policy` loop.
Pick by name (`policy="pack", predictor="gp"`) or pass configured
instances; register new ones with `@register_policy` / `@register_predictor`.
"""
from repro_torch.sched.costq import SortedCostQueue
from repro_torch.sched.offload import SurrogateOffload, SurrogateOffloadPolicy
from repro_torch.sched.policy import (EDFPolicy, FairSharePolicy, FCFSPolicy,
                                LPTPolicy, PackingPolicy, SchedulingPolicy,
                                SJFPolicy, WorkStealingPolicy, WorkerView)
from repro_torch.sched.predictor import (GPRuntimePredictor, QuantileEstimator,
                                   RuntimePredictor, flatten_parameters,
                                   request_features)
from repro_torch.sched.registry import (POLICIES, PREDICTORS, make_policy,
                                  make_predictor, register_policy,
                                  register_predictor)
