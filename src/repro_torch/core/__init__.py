"""Persistent-worker executor, task types and scheduling metrics (the
framework-free half of `repro.core`, carried over as is)."""
from repro_torch.core import metrics
from repro_torch.core.executor import Executor
from repro_torch.core.metrics import (AllocationRecord, TaskRecord,
                                      allocation_utilization, makespan,
                                      node_seconds, slr, summarize)
from repro_torch.core.task import EvalRequest, EvalResult, LambdaModel, Model
