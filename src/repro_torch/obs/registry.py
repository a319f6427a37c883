"""Named counters / gauges / histograms sampled each stepper tick.

The registry is the numeric side of `repro_torch.obs`: where the tracer
records *events*, the registry records *state over time* — queue depth,
backlog cost, busy workers, open/pending allocations, offload rate, and
predictor absolute-residual calibration — one row per
`LifecycleStepper.step`, into a bounded sample buffer.  `timeseries()`
pivots the rows into parallel arrays benchmarks can dump next to their
`BENCH_*.json` (see `benchmarks/overhead_attribution.py`).

Contract for third-party policies / drivers:

  * `inc(name)` for monotone counters, `set_gauge(name, v)` for
    point-in-time values, `observe(name, v)` for distributions (fixed
    bucket edges; also maintains a running ``<name>_mean`` gauge);
  * every write accepts ``labels={"tenant": ...}`` — the series is then
    keyed ``name{k=v,...}`` (keys sorted, Prometheus-style).  Label
    cardinality is BOUNDED per base name (`max_label_sets`, default 64):
    writes that would mint a series beyond the cap are dropped and
    counted in ``labels_dropped``, so an adversarial stream of unique
    tenant names cannot grow the registry without limit;
  * `sample(now)` snapshots every counter and gauge with timestamp
    ``now`` — the stepper calls it once per tick when a registry is
    attached, so drivers never need to;
  * `timeseries()` returns ``{"t": [...], "<metric>": [...]}`` with one
    aligned entry per sample (NaN before a metric first appeared).

Everything is plain python (no numpy): `sample_cluster` runs under the
executor's dispatch lock.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.trace import RingBuffer

# seconds-scale default bucket edges (residuals, waits); the last bucket
# is an effective overflow catch-all
DEFAULT_EDGES = (0.0, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0,
                 1e9)


class Histogram:
    """Fixed-bucket histogram: O(log buckets) observe, no rebinning."""

    __slots__ = ("edges", "counts", "n", "total")

    def __init__(self, edges: Sequence[float] = DEFAULT_EDGES):
        self.edges = [float(e) for e in edges]
        if len(self.edges) < 2:
            raise ValueError("need at least two bucket edges")
        self.counts = [0] * (len(self.edges) - 1)
        self.n = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect_right(self.edges, v) - 1
        self.counts[min(max(i, 0), len(self.counts) - 1)] += 1
        self.n += 1
        self.total += v

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {"edges": list(self.edges), "counts": list(self.counts),
                "n": self.n, "mean": self.mean}


class MetricsRegistry:
    """Counters + gauges + histograms with a bounded sample history."""

    def __init__(self, max_samples: int = 4096,
                 max_label_sets: int = 64):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, Histogram] = {}
        self.max_label_sets = max_label_sets
        self._label_sets: Dict[str, set] = {}  # base name -> series keys
        self._rows = RingBuffer(max_samples)

    def _series(self, name: str,
                labels: Optional[Dict[str, str]]) -> Optional[str]:
        """Resolve (name, labels) to a series key, or None when the
        write must be dropped: a base name may mint at most
        `max_label_sets` labelled series, and overflow increments the
        unlabelled ``labels_dropped`` counter instead of allocating —
        cardinality abuse costs the abuser a counter bump, not memory."""
        if not labels:
            return name
        key = "{}{{{}}}".format(
            name, ",".join(f"{k}={labels[k]}" for k in sorted(labels)))
        seen = self._label_sets.setdefault(name, set())
        if key not in seen:
            if len(seen) >= self.max_label_sets:
                self.counters["labels_dropped"] = \
                    self.counters.get("labels_dropped", 0.0) + 1.0
                return None
            seen.add(key)
        return key

    # -- writes ----------------------------------------------------------
    def inc(self, name: str, v: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        series = self._series(name, labels)
        if series is None:
            return
        self.counters[series] = self.counters.get(series, 0.0) + v

    def set_gauge(self, name: str, v: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        series = self._series(name, labels)
        if series is None:
            return
        self.gauges[series] = float(v)

    def observe(self, name: str, v: float,
                edges: Optional[Sequence[float]] = None,
                labels: Optional[Dict[str, str]] = None) -> None:
        series = self._series(name, labels)
        if series is None:
            return
        h = self.hists.get(series)
        if h is None:
            h = self.hists[series] = Histogram(edges or DEFAULT_EDGES)
        h.observe(v)
        self.gauges[series + "_mean"] = h.mean

    # -- sampling --------------------------------------------------------
    def sample(self, now: float) -> None:
        row: Dict[str, float] = {"t": float(now)}
        row.update(self.gauges)
        row.update(self.counters)
        self._rows.append(row)

    def sample_cluster(self, now: float, broker, busy_workers: int) -> None:
        """The per-tick cluster snapshot the `LifecycleStepper` records:
        everything the autoallocator and offload router see, as gauges."""
        g = self.set_gauge
        g("queue_depth", float(len(broker)))
        # pass the broker's CURRENT default so the probe cannot perturb
        # the backlog-cost ledger another caller configured
        cost = getattr(broker, "backlog_cost", None)
        if callable(cost):
            g("backlog_cost_s",
              cost(getattr(broker, "default_cost", 1.0)))
        g("busy_workers", float(busy_workers))
        allocs = getattr(broker, "allocations", lambda: [])()
        g("allocations_open", float(len(
            [a for a in allocs if a.open and not a.virtual])))
        g("allocations_pending", float(len(
            [a for a in allocs if a.state == "queued" and not a.virtual])))
        sur = getattr(broker, "surrogate", None)
        if sur is not None:
            considered = getattr(sur, "n_considered", 0)
            g("offload_rate",
              getattr(sur, "n_offloaded", 0) / considered
              if considered else 0.0)
        tb = getattr(broker, "tenant_backlogs", None)
        if callable(tb):
            # per-tenant depth gauges exist only when a tenant-aware
            # policy (fairshare) is queuing — single-tenant rows keep
            # their exact pre-multi-tenant schema
            for tenant, n in sorted(tb().items()):
                g("queue_depth", float(n), labels={"tenant": tenant})
        self.sample(now)

    # -- reads -----------------------------------------------------------
    @property
    def n_samples(self) -> int:
        return len(self._rows)

    def timeseries(self) -> Dict[str, List[float]]:
        rows = list(self._rows)
        keys = sorted({k for r in rows for k in r} - {"t"})
        out: Dict[str, List[float]] = {"t": [r["t"] for r in rows]}
        nan = float("nan")
        for k in keys:
            out[k] = [r.get(k, nan) for r in rows]
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Current values of everything (one JSON-able dict)."""
        return {"counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: h.as_dict()
                               for k, h in self.hists.items()},
                "n_samples": len(self._rows)}
