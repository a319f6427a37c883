"""Allocation lifecycle, auto-allocation and multi-node brokered dispatch
(the parts of `repro.cluster` the live `Executor` drives)."""
from repro_torch.cluster.allocation import (DRAINING, EXPIRED, PENDING,
                                            QUEUED, RUNNING, Allocation)
from repro_torch.cluster.autoalloc import AutoAllocConfig, AutoAllocator
from repro_torch.cluster.broker import Broker
from repro_torch.cluster.stepper import LifecycleStepper
