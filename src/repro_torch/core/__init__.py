"""The paper's primary contribution: dynamic load balancing / task
scheduling for UQ workflows — backend specs, a calibrated discrete-event
cluster simulator (quantitative reproduction of the paper's Figs. 3-6),
and a live persistent-worker executor scheduling real device work with
fault tolerance, straggler mitigation and elastic scaling."""
from repro_torch.core import backends, metrics
from repro_torch.core.balancer import LoadBalancer
from repro_torch.core.executor import Executor
from repro_torch.core.metrics import (AllocationRecord, TaskRecord,
                                allocation_utilization, makespan,
                                node_seconds, slr, summarize)
from repro_torch.core.simulator import (Workload, simulate, simulate_policy,
                                  eval_records)
from repro_torch.core.task import EvalRequest, EvalResult, LambdaModel, Model
