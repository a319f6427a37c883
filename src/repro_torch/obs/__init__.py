"""Span tracing and overhead attribution (the parts of `repro.obs` the
live `Executor` uses)."""
from repro_torch.obs.attribution import (OverheadBreakdown,
                                         attribute_overhead,
                                         capacity_intervals,
                                         format_breakdown)
from repro_torch.obs.trace import (RingBuffer, TraceEvent, Tracer,
                                   read_jsonl, span_sequence,
                                   validate_chrome_trace, validate_jsonl_row)
