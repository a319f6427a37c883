"""`repro_torch.service`: the multi-tenant broker service.

`ServiceBroker` wraps the cluster `Executor` in an always-on,
crash-safe, fair-share front-end: per-tenant quotas with bounded-queue
backpressure (`Backpressure`), weighted deficit-round-robin dispatch
(`repro_torch.sched.FairSharePolicy` per allocation), tenant-labelled SLO
accounting, and an atomically-published state journal
(`repro_torch.checkpoint.Journal`) that restarts lose zero tasks from.
"""
from repro_torch.service.broker import Backpressure, ServiceBroker

__all__ = ["Backpressure", "ServiceBroker"]
