"""`repro_torch.obs`: tracing, metrics, attribution, calibration, replay.

One observability layer for both execution paths: because the spans and
counters are instrumented at the shared `LifecycleStepper` / `Broker`
choke points and timestamped by the injected clock, a seeded parity run
produces identical span sequences from `simulate_cluster` and the live
`Executor` (see `tests/test_parity.py`).  Everything is opt-in:
``tracer=None`` / ``registry=None`` defaults keep the hot paths free of
even the tuple-append cost.

On top of the recording layer sit the consumers that close the
sim-to-reality gap: `repro_torch.obs.calib` fits per-phase overhead
distributions from a trace into a drop-in `CalibratedBackendSpec` and
watches for drift online (`CalibrationMonitor`), and `repro_torch.obs.replay`
re-runs a recorded workload — bitwise-exactly for sim-recorded traces —
through `simulate_cluster` (`TraceReplay` / `replay_cluster`).
"""
from repro_torch.obs.attribution import (OverheadBreakdown, attribute_overhead,
                                   capacity_intervals, format_breakdown)
from repro_torch.obs.calib import (SACCT_DEFAULT_FIELDS, CalibratedBackendSpec,
                             CalibrationMonitor, PhaseFit, calibrate,
                             extract_phase_samples, fit_lognormal,
                             fit_phase, hlo_runtime_prior, ks_lognormal,
                             parse_slurm_duration, parse_slurm_time,
                             prior_fit, read_sacct, sacct_to_jsonl)
from repro_torch.obs.registry import DEFAULT_EDGES, Histogram, MetricsRegistry
from repro_torch.obs.replay import (ReplayBackendSpec, TraceReplay,
                              replay_cluster)
from repro_torch.obs.trace import (RingBuffer, TraceEvent, Tracer, read_jsonl,
                             span_sequence, validate_chrome_trace,
                             validate_jsonl_row)

__all__ = [
    "DEFAULT_EDGES",
    "CalibratedBackendSpec",
    "CalibrationMonitor",
    "Histogram",
    "MetricsRegistry",
    "OverheadBreakdown",
    "PhaseFit",
    "ReplayBackendSpec",
    "RingBuffer",
    "TraceEvent",
    "TraceReplay",
    "Tracer",
    "attribute_overhead",
    "calibrate",
    "capacity_intervals",
    "extract_phase_samples",
    "fit_lognormal",
    "fit_phase",
    "format_breakdown",
    "hlo_runtime_prior",
    "ks_lognormal",
    "parse_slurm_duration",
    "parse_slurm_time",
    "prior_fit",
    "read_jsonl",
    "read_sacct",
    "replay_cluster",
    "sacct_to_jsonl",
    "SACCT_DEFAULT_FIELDS",
    "span_sequence",
    "validate_chrome_trace",
    "validate_jsonl_row",
]
