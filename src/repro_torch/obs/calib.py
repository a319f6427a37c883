"""Trace-driven calibration of the `BackendSpec` overhead model.

The parity harness (`repro_torch.cluster.parity`) proves sim == live *given*
the `BackendSpec` lognormal overhead model; nothing there checks the
model against observed behaviour.  This module closes that gap, after
"An Approach for Realistically Simulating the Performance of Scientific
Applications on HPC Systems" (PAPERS.md): ingest a recorded trace
(`repro_torch.obs.trace` JSONL from a live `Executor`, a traced sim run, or
any real-cluster log serialised to the same schema) into per-phase
empirical distributions and fit them with the *same parametric form the
spec draws from* — `lognormal(rng, median, sigma)` — so the fitted
parameters drop straight into `simulate_cluster` / `Executor`.

Pipeline:

  * `extract_phase_samples` pulls per-phase samples out of trace events,
    keyed the way the spec's draws are keyed: queue waits by
    (allocation walltime request, group size) from ``alloc.queued``
    spans (the DRAWN value recorded in args, not the span length — a
    cancelled allocation's span is shorter than its draw), cold-start
    init and runtime by model from ``task.init`` / ``task.run``,
    dispatch pooled (a backend property, not a model property);
  * `fit_phase` runs lognormal MLE (mu/sigma on logs; median = e^mu)
    and a Kolmogorov–Smirnov goodness-of-fit test; when KS rejects
    lognormal at `alpha`, the `PhaseFit` keeps the empirical CDF and
    `draw` falls back to inverse-ECDF sampling with linear
    interpolation — heavy tails and bimodal phases calibrate too;
  * `calibrate` assembles a `CalibratedBackendSpec`: a frozen
    `BackendSpec` subclass whose `queue_wait_median` / `draw_queue_wait`
    / `server_init_for` answer from the fits (nearest-request-key
    matching for queue waits) and fall back to the base spec wherever
    the trace has no coverage.  It is a drop-in spec: every consumer
    (`simulate_cluster`, `AutoAllocator`, `Executor`) works unchanged.

For device tasks with no recorded runtimes, `hlo_runtime_prior` turns a
cost analysis (`launch.hlo_cost`: not yet ported, ROADMAP item 16)
into a roofline runtime estimate
(max(flops/peak, bytes/bandwidth)) that `calibrate(priors=...)` installs
as an analytical prior `PhaseFit` — the simulator can cost a model it
has never observed.

`CalibrationMonitor` is the online half: the drivers stream observed
per-attempt overheads (`observe_attempt`) and granted queue waits
(`observe_queue_wait`, from the shared `LifecycleStepper`) into it; the
monitor tracks rolling log-ratio residuals between model-predicted and
observed values per phase, writes ``calib_*`` metrics into a
`MetricsRegistry`, and emits ``calib.drift`` instants into the Tracer
when a phase's rolling mean leaves the band — with hysteresis, so one
excursion is one alarm.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.backends import (QUEUE_WAIT_SATURATION_S, BackendSpec,
                                 lognormal)
from repro_torch.obs.trace import TraceEvent, read_jsonl

# below this, a log() would blow up; observed zeros (live ms-dispatch)
# are floored here for fitting and the KS test does the rejecting
_EPS = 1e-9

# phases a PhaseFit can describe; "runtime" is per-model compute, the
# other three are the spec's overhead components
PHASES = ("queue_wait", "init", "dispatch", "runtime")


# ---------------------------------------------------------------------------
# lognormal MLE + Kolmogorov–Smirnov goodness of fit (no scipy)
# ---------------------------------------------------------------------------
def fit_lognormal(samples: Sequence[float]) -> Tuple[float, float]:
    """MLE for the `lognormal(rng, median, sigma)` parameterisation:
    ``median = exp(mean(log x))``, ``sigma = std(log x)`` (population).
    Non-positive samples are floored at a tiny epsilon — if they carry
    real mass the KS test will reject and the ECDF fallback takes over."""
    if not len(samples):
        raise ValueError("fit_lognormal needs at least one sample")
    logs = np.log(np.maximum(np.asarray(samples, dtype=float), _EPS))
    return float(math.exp(logs.mean())), float(logs.std())


def _phi(z: float) -> float:
    """Standard normal CDF."""
    return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))


def _kolmogorov_pvalue(d: float, n: int) -> float:
    """Asymptotic Kolmogorov p-value with the Stephens small-sample
    correction ``lambda = (sqrt(n) + 0.12 + 0.11/sqrt(n)) * D``.  The
    parameters were estimated from the same sample, which makes this
    p-value conservative towards *accepting* lognormal (the Lilliefors
    critical values are tighter) — acceptable here because the cost of a
    false accept is a lognormal approximation, not a wrong answer: the
    fitted median still matches the sample's log-mean."""
    lam = (math.sqrt(n) + 0.12 + 0.11 / math.sqrt(n)) * d
    if lam < 1e-3:
        return 1.0
    s = 0.0
    for k in range(1, 101):
        term = 2.0 * (-1.0) ** (k - 1) * math.exp(-2.0 * k * k * lam * lam)
        s += term
        if abs(term) < 1e-10:
            break
    return float(min(max(s, 0.0), 1.0))


def ks_lognormal(samples: Sequence[float], median: float,
                 sigma: float) -> Tuple[float, float]:
    """KS statistic and p-value of `samples` against
    LogNormal(median, sigma).  Degenerate fits (sigma ~ 0) are judged by
    whether the sample itself is (nearly) constant."""
    xs = np.sort(np.maximum(np.asarray(samples, dtype=float), _EPS))
    n = len(xs)
    if n == 0:
        return 0.0, 1.0
    if sigma <= _EPS or median <= 0:
        # the model is a point mass at `median`: perfect iff the sample
        # is that constant
        spread = float(xs[-1] - xs[0])
        rel = spread / max(abs(median), _EPS)
        return (0.0, 1.0) if rel < 1e-9 else (1.0, 0.0)
    mu = math.log(median)
    cdf = np.array([_phi((math.log(x) - mu) / sigma) for x in xs])
    i = np.arange(n, dtype=float)
    d_plus = float(np.max((i + 1.0) / n - cdf))
    d_minus = float(np.max(cdf - i / n))
    d = max(d_plus, d_minus, 0.0)
    return d, _kolmogorov_pvalue(d, n)


# ---------------------------------------------------------------------------
# one fitted phase distribution
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PhaseFit:
    """One phase's fitted distribution: lognormal when KS accepts it
    (`lognormal_ok`), empirical CDF otherwise.  `samples` is the sorted
    sample tuple (empty for analytical priors), so the ECDF fallback and
    any later re-fit carry their own evidence."""
    phase: str                       # one of PHASES
    key: Any                         # model name, (walltime, n) — or None
    n: int
    median: float
    sigma: float
    mean: float
    ks_stat: float
    ks_pvalue: float
    lognormal_ok: bool
    samples: Tuple[float, ...] = ()
    source: str = "trace"            # "trace" | "prior"

    def draw(self, rng) -> float:
        """One seeded draw from the fitted distribution (the same rng
        contract as `BackendSpec.draw_queue_wait`)."""
        if self.lognormal_ok or len(self.samples) < 2:
            return lognormal(rng, self.median, self.sigma)
        return self.quantile(float(rng.uniform()))

    def quantile(self, u: float) -> float:
        """Inverse empirical CDF with linear interpolation."""
        s = self.samples
        if not s:
            return self.median
        u = min(max(u, 0.0), 1.0)
        pos = u * (len(s) - 1)
        i = int(pos)
        if i >= len(s) - 1:
            return float(s[-1])
        frac = pos - i
        return float(s[i] + (s[i + 1] - s[i]) * frac)

    def describe(self) -> str:
        form = "lognormal" if self.lognormal_ok else "ecdf"
        key = "*" if self.key is None else self.key
        return (f"{self.phase:>10s} {key!s:>20s} n={self.n:<5d} "
                f"median={self.median:.4g}s sigma={self.sigma:.3f} "
                f"[{form}, ks p={self.ks_pvalue:.3f}, {self.source}]")


def fit_phase(phase: str, key: Any, samples: Sequence[float], *,
              alpha: float = 0.05) -> PhaseFit:
    """Fit one phase sample set: lognormal MLE, KS gate at `alpha`."""
    arr = np.maximum(np.asarray(samples, dtype=float), 0.0)
    median, sigma = fit_lognormal(arr)
    if float(arr.max(initial=0.0)) <= _EPS:
        # all-zero phase (live ms dispatch measures as 0): the honest
        # fit is a point mass at zero, which lognormal represents as
        # median 0 (lognormal() returns 0.0 for median <= 0)
        median, sigma = 0.0, 0.0
    stat, pvalue = ks_lognormal(arr, median, sigma)
    return PhaseFit(
        phase=phase, key=key, n=int(len(arr)), median=median, sigma=sigma,
        mean=float(arr.mean()) if len(arr) else 0.0,
        ks_stat=stat, ks_pvalue=pvalue,
        lognormal_ok=bool(pvalue >= alpha),
        samples=tuple(float(x) for x in np.sort(arr)))


def prior_fit(phase: str, key: Any, median: float,
              sigma: float = 0.3) -> PhaseFit:
    """An analytical prior posing as a fit (``n=0``, no samples): used
    for models the trace never observed — e.g. an `hlo_runtime_prior`
    roofline estimate for a device task."""
    return PhaseFit(phase=phase, key=key, n=0, median=float(median),
                    sigma=float(sigma), mean=float(median), ks_stat=0.0,
                    ks_pvalue=1.0, lognormal_ok=True, samples=(),
                    source="prior")


def hlo_runtime_prior(cost: Any, *, peak_flops: float = 1.0e12,
                      mem_bw: float = 1.0e11,
                      coll_bw: float = 2.5e10,
                      latency_floor_s: float = 1e-4) -> float:
    """Roofline runtime estimate (seconds) from a `launch.hlo_cost`
    analysis (not yet ported, ROADMAP item 16): the kernel is bound by
    whichever of compute, HBM traffic or collective traffic takes
    longest, plus a launch-latency floor.
    `cost` is an `OpCost` (or anything with ``flops`` / ``bytes`` /
    ``coll_bytes`` attributes, or a dict with those keys)."""
    def _get(name: str) -> float:
        if isinstance(cost, dict):
            return float(cost.get(name, 0.0))
        return float(getattr(cost, name, 0.0))

    t = max(_get("flops") / max(peak_flops, 1.0),
            _get("bytes") / max(mem_bw, 1.0),
            _get("coll_bytes") / max(coll_bw, 1.0))
    return t + latency_floor_s


# ---------------------------------------------------------------------------
# trace ingestion
# ---------------------------------------------------------------------------
def extract_phase_samples(
        events: Sequence[TraceEvent]
) -> Dict[Tuple[str, Any], List[float]]:
    """Group a trace's per-phase samples under the keys the spec's draws
    use.  Exact-args values (``init`` / ``compute`` / ``queue_wait``)
    are preferred over span durations; older traces without them fall
    back to the span length.

      * ``("queue_wait", (walltime_s | None, n_workers | None))`` — one
        sample per real allocation submission;
      * ``("init", model)`` and ``("init", None)`` (pooled) — cold-start
        server init per attempt that paid one;
      * ``("dispatch", None)`` — pooled per-attempt dispatch latency;
      * ``("runtime", model)`` — compute seconds of ok/timeout runs.
    """
    out: Dict[Tuple[str, Any], List[float]] = {}
    open_queued: Dict[int, Tuple[float, dict]] = {}   # pid -> (ts, args)

    def add(phase: str, key: Any, value: float) -> None:
        out.setdefault((phase, key), []).append(float(value))

    for ts, ph, name, pid, tid, dur, args in events:
        a = args or {}
        if ph == "X":
            if name == "task.init":
                v = a.get("init", dur)
                model = a.get("model")
                add("init", None, v)             # pooled
                if model is not None:
                    add("init", model, v)
            elif name == "task.dispatch":
                add("dispatch", None, a.get("latency", dur))
            elif name == "task.run":
                if a.get("status", "ok") in ("ok", "timeout"):
                    add("runtime", a.get("model"), a.get("compute", dur))
        elif name == "alloc.queued" and not a.get("virtual"):
            if ph == "B":
                if "queue_wait" in a:
                    add("queue_wait",
                        (a.get("walltime_s"), a.get("n_workers")),
                        a["queue_wait"])
                else:
                    open_queued[pid] = (ts, a)
            elif ph == "E" and pid in open_queued:
                b_ts, b_args = open_queued.pop(pid)
                add("queue_wait",
                    (b_args.get("walltime_s"), b_args.get("n_workers")),
                    max(ts - b_ts, 0.0))
    return out


def _wall_key(alloc_request_s: Optional[float]) -> float:
    """Queue-wait matching distance coordinate: unbounded requests sit
    at the saturation walltime, exactly as `queue_wait_median` treats
    them (``min(walltime, saturation)``)."""
    if alloc_request_s is None or not math.isfinite(alloc_request_s):
        return QUEUE_WAIT_SATURATION_S
    return min(float(alloc_request_s), QUEUE_WAIT_SATURATION_S)


# ---------------------------------------------------------------------------
# the calibrated spec
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CalibratedBackendSpec(BackendSpec):
    """A `BackendSpec` whose overhead answers come from trace fits.

    Drop-in: `queue_wait_median` / `draw_queue_wait` consult the fitted
    queue-wait distribution whose recorded request signature is nearest
    (log-walltime distance, saturation applied) and fall back to the
    base parametric model when the trace recorded no allocations;
    `server_init` / `dispatch_latency` scalar fields already hold the
    pooled fitted medians (see `calibrate`), and `server_init_for`
    refines init per model.  `runtime_fit` exposes per-model runtime
    distributions for predictors/replay; it is not consulted by the
    simulator's dispatch (runtimes come from the trace being run).
    """
    fits: Mapping[Tuple[str, Any], PhaseFit] = \
        dataclasses.field(default_factory=dict, compare=False, repr=False)
    calibrated_from: str = ""

    # -- fit lookup ------------------------------------------------------
    def fit_for(self, phase: str, key: Any = None) -> Optional[PhaseFit]:
        f = self.fits.get((phase, key))
        if f is None and key is not None:
            f = self.fits.get((phase, None))     # pooled fallback
        return f

    def _queue_fit(self, alloc_request_s: float) -> Optional[PhaseFit]:
        want = _wall_key(alloc_request_s)
        best: Optional[PhaseFit] = None
        best_d = math.inf
        for (phase, key), f in self.fits.items():
            if phase != "queue_wait":
                continue
            wall = key[0] if isinstance(key, tuple) else key
            d = abs(math.log((_wall_key(wall) + 1.0) / (want + 1.0)))
            if d < best_d or (d == best_d and best is not None
                              and f.n > best.n):
                best, best_d = f, d
        return best

    # -- BackendSpec surface ---------------------------------------------
    def queue_wait_median(self, alloc_request_s: float,
                          n_cpus: int = 1) -> float:
        f = self._queue_fit(alloc_request_s)
        if f is None:
            return super().queue_wait_median(alloc_request_s, n_cpus)
        return f.median

    def draw_queue_wait(self, rng, alloc_request_s: float,
                        n_cpus: int = 1) -> float:
        f = self._queue_fit(alloc_request_s)
        if f is None:
            return super().draw_queue_wait(rng, alloc_request_s, n_cpus)
        return f.draw(rng)

    def server_init_for(self, model: str) -> float:
        f = self.fit_for("init", model)
        return f.median if f is not None else self.server_init

    def runtime_fit(self, model: str) -> Optional[PhaseFit]:
        return self.fit_for("runtime", model)

    def describe_fits(self) -> str:
        lines = [f"{self.name}: calibrated from "
                 f"{self.calibrated_from or 'trace'} "
                 f"({len(self.fits)} phase fits)"]
        for (_phase, _key), f in sorted(
                self.fits.items(),
                key=lambda kv: (kv[0][0], repr(kv[0][1]))):
            lines.append("  " + f.describe())
        return "\n".join(lines)


def calibrate(source: Any, base: BackendSpec, *,
              alpha: float = 0.05, min_samples: int = 3,
              priors: Optional[Mapping[str, float]] = None,
              label: str = "") -> CalibratedBackendSpec:
    """Fit a `CalibratedBackendSpec` from a trace.

    `source` is a JSONL path (loaded via `read_jsonl`) or an iterable of
    `TraceEvent` tuples.  Phases with fewer than `min_samples` samples
    keep the base model (queue waits are exempt — one real allocation is
    one whole sample of the distribution that matters most, and a
    single-sample fit is an honest point estimate).  ``priors`` maps
    model name -> analytical runtime median (e.g. `hlo_runtime_prior`)
    installed for models the trace never ran."""
    if isinstance(source, str):
        events: Sequence[TraceEvent] = read_jsonl(source)
        label = label or source
    else:
        events = list(source)
        label = label or f"{len(events)} events"
    groups = extract_phase_samples(events)
    fits: Dict[Tuple[str, Any], PhaseFit] = {}
    for (phase, key), samples in groups.items():
        need = 1 if phase == "queue_wait" else min_samples
        if len(samples) < need:
            continue
        fits[(phase, key)] = fit_phase(phase, key, samples, alpha=alpha)
    if priors:
        for model, median in priors.items():
            if ("runtime", model) not in fits:
                fits[("runtime", model)] = prior_fit("runtime", model,
                                                     median)

    fields = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(BackendSpec)}
    init_pool = fits.get(("init", None))
    if init_pool is not None:
        fields["server_init"] = init_pool.median
    disp = fits.get(("dispatch", None))
    if disp is not None:
        fields["dispatch_latency"] = disp.median
    fields["name"] = f"{base.name}+calib"
    return CalibratedBackendSpec(fits=fits, calibrated_from=label,
                                 **fields)


# ---------------------------------------------------------------------------
# SLURM sacct ingestion
# ---------------------------------------------------------------------------
# the canonical accounting columns the adapter consumes — the default
# `sacct --parsable2 --format=` selection for calibration-grade logs
SACCT_DEFAULT_FIELDS = ("JobID", "JobName", "State", "Submit", "Start",
                        "End", "Elapsed", "Timelimit", "NNodes")

# sacct State (first word; "CANCELLED by 123" and "OUT_OF_MEMORY" included)
# -> the trace schema's task status vocabulary
_SACCT_STATUS = {"COMPLETED": "ok", "TIMEOUT": "timeout",
                 "FAILED": "failed", "CANCELLED": "failed",
                 "NODE_FAIL": "failed", "OUT_OF_MEMORY": "failed",
                 "OUT_OF_ME+": "failed", "PREEMPTED": "failed"}


def parse_slurm_duration(s: Optional[str]) -> Optional[float]:
    """``[DD-]HH:MM:SS[.fff]`` (also ``MM:SS``) -> seconds; None for
    empty/UNLIMITED/Partition_Limit/INVALID — "no bound" and "no value"
    both mean the field contributes nothing."""
    if not s:
        return None
    s = s.strip()
    if not s or s.upper() in ("UNLIMITED", "PARTITION_LIMIT", "INVALID",
                              "NONE", "UNKNOWN"):
        return None
    days = 0.0
    if "-" in s:
        d, s = s.split("-", 1)
        days = float(d)
    parts = s.split(":")
    try:
        nums = [float(p) for p in parts]
    except ValueError:
        return None
    if len(nums) == 3:
        h, m, sec = nums
    elif len(nums) == 2:
        h, (m, sec) = 0.0, nums
    elif len(nums) == 1:
        h, m, sec = 0.0, 0.0, nums[0]
    else:
        return None
    return days * 86400.0 + h * 3600.0 + m * 60.0 + sec


def parse_slurm_time(s: Optional[str]) -> Optional[float]:
    """sacct timestamp (ISO ``YYYY-MM-DDTHH:MM:SS``, or epoch seconds)
    -> epoch seconds; naive timestamps are read as UTC so queue waits
    are environment-independent.  None for Unknown/None/empty."""
    if not s:
        return None
    s = s.strip()
    if not s or s.upper() in ("UNKNOWN", "NONE", "N/A"):
        return None
    try:
        return float(s)                        # epoch-seconds export
    except ValueError:
        pass
    import calendar
    import datetime
    try:
        dt = datetime.datetime.fromisoformat(s)
    except ValueError:
        return None
    if dt.tzinfo is not None:
        return dt.timestamp()
    return float(calendar.timegm(dt.timetuple())) + dt.microsecond / 1e6


def read_sacct(source: Any, *,
               field_map: Optional[Mapping[str, str]] = None,
               delimiter: str = "|",
               strict: bool = True) -> List[TraceEvent]:
    """Ingest real SLURM accounting output as `TraceEvent` tuples — the
    field-mapping adapter that lets `sacct` logs feed `calibrate`
    directly (the `read_jsonl` schema's real-cluster on-ramp).

    `source` is a path to ``sacct --parsable2`` output (or an iterable
    of its lines).  The first row may be the sacct header; without one,
    columns are assumed to be `SACCT_DEFAULT_FIELDS` in order.
    `field_map` renames: canonical field -> the column name the site's
    export uses (e.g. ``{"JobName": "Account"}`` keys runtimes by
    account instead), on top of the header/default layout.

    Per completed job two trace structures come out, keyed exactly the
    way `extract_phase_samples` groups them:

      * an ``alloc.queued`` B/E pair at (Submit, Start) whose B args
        carry ``queue_wait`` = Start − Submit, ``walltime_s`` from
        Timelimit and ``n_workers`` from NNodes — one queue-wait sample
        under the (walltime, size) request signature;
      * a ``task.run`` X span at Start of length Elapsed with
        ``model`` = JobName and ``status`` mapped from State
        (COMPLETED -> ok, TIMEOUT -> timeout, failure states -> failed —
        excluded from runtime fits by the extractor, like any failed
        attempt).

    Job *steps* (``JobID`` containing '.', e.g. ``4242.batch``) are
    accounting detail of their parent job and are skipped.  Jobs still
    pending/running are skipped (no complete sample yet).  Timestamps
    are rebased so the earliest Submit is t=0 — calibration consumes
    differences only.  With ``strict=True`` a malformed row raises
    `ValueError` naming the line; otherwise bad rows are skipped.
    """
    if isinstance(source, str):
        with open(source) as fh:
            lines = fh.read().splitlines()
        label = source
    else:
        lines = [str(ln).rstrip("\n") for ln in source]
        label = "<lines>"
    lines = [ln for ln in lines if ln.strip()]
    if not lines:
        return []

    header = lines[0].split(delimiter)
    if "JobID" in header or (field_map and
                             any(v in header for v in field_map.values())):
        rows = lines[1:]
        columns = header
    else:
        rows = lines
        columns = list(SACCT_DEFAULT_FIELDS)
    fmap = dict(field_map or {})
    index: Dict[str, int] = {}
    for canon in SACCT_DEFAULT_FIELDS:
        name = fmap.get(canon, canon)
        if name in columns:
            index[canon] = columns.index(name)
    missing = [c for c in ("JobID", "State") if c not in index]
    if missing:
        raise ValueError(f"{label}: sacct columns {missing} not found in "
                         f"{columns} (field_map={fmap or None})")

    def field(parts: List[str], canon: str) -> Optional[str]:
        i = index.get(canon)
        if i is None or i >= len(parts):
            return None
        return parts[i]

    jobs: List[Tuple[str, str, str, Optional[float], Optional[float],
                     Optional[float], Optional[float], int]] = []
    for lineno, ln in enumerate(rows, 2 if rows is not lines else 1):
        parts = ln.split(delimiter)
        job_id = field(parts, "JobID") or ""
        if "." in job_id:
            continue                           # a job STEP, not a job
        state = (field(parts, "State") or "").split()[0:1]
        state = state[0].upper() if state else ""
        status = _SACCT_STATUS.get(state)
        if status is None:
            if state in ("", "PENDING", "RUNNING", "REQUEUED",
                         "SUSPENDED"):
                continue                       # not a complete sample yet
            if strict:
                raise ValueError(f"{label}:{lineno}: unknown sacct state "
                                 f"{state!r} for job {job_id}")
            continue
        submit = parse_slurm_time(field(parts, "Submit"))
        start = parse_slurm_time(field(parts, "Start"))
        elapsed = parse_slurm_duration(field(parts, "Elapsed"))
        limit = parse_slurm_duration(field(parts, "Timelimit"))
        try:
            nnodes = int(field(parts, "NNodes") or 1)
        except ValueError:
            nnodes = 1
        name = field(parts, "JobName") or job_id
        jobs.append((job_id, name, status, submit, start, elapsed,
                     limit, nnodes))

    t0 = min((j[3] for j in jobs if j[3] is not None), default=0.0)
    events: List[TraceEvent] = []
    for pid, (job_id, name, status, submit, start, elapsed, limit,
              nnodes) in enumerate(jobs, 1):
        if submit is not None and start is not None and start >= submit:
            args = {"queue_wait": start - submit, "walltime_s": limit,
                    "n_workers": nnodes, "alloc": job_id}
            events.append((submit - t0, "B", "alloc.queued", pid, 0,
                           0.0, args))
            events.append((start - t0, "E", "alloc.queued", pid, 0,
                           0.0, None))
        if start is not None and elapsed is not None:
            events.append((start - t0, "X", "task.run", pid, 0, elapsed,
                           {"model": name, "compute": elapsed,
                            "status": status, "task": job_id}))
    events.sort(key=lambda e: (e[0], e[1] != "B"))
    return events


def sacct_to_jsonl(source: Any, dst: str, **read_kw) -> int:
    """Convert sacct accounting output to the `read_jsonl` trace schema
    on disk (every row `validate_jsonl_row`-clean), so real-cluster logs
    flow through the same files as recorded traces.  Returns the number
    of rows written."""
    import json
    from repro_torch.obs.trace import validate_jsonl_row
    events = read_sacct(source, **read_kw)
    with open(dst, "w") as fh:
        for ts, ph, name, pid, tid, dur, args in events:
            row: Dict[str, Any] = {"ts": ts, "ph": ph, "name": name,
                                   "pid": pid, "tid": tid}
            if ph == "X":
                row["dur"] = dur
            if args is not None:
                row["args"] = args
            problem = validate_jsonl_row(row)
            if problem is not None:            # schema drift = a bug here
                raise AssertionError(f"sacct row fails trace schema: "
                                     f"{problem}")
            fh.write(json.dumps(row) + "\n")
    return len(events)


# ---------------------------------------------------------------------------
# online drift detection
# ---------------------------------------------------------------------------
class CalibrationMonitor:
    """Rolling per-phase residual tracker: model-predicted vs observed.

    The drivers feed it observations at the shared choke points
    (`Executor._complete` / `simulate_cluster` completions via
    `observe_attempt`; `LifecycleStepper._grant` via
    `observe_queue_wait`).  Per phase it keeps a rolling window of
    ``log(observed / predicted)`` ratios; when the window mean's
    magnitude exceeds `drift_logratio` (default ln 2: off by 2x) with at
    least `min_n` observations, one ``calib.drift`` instant is emitted
    into the tracer and ``calib_drift_alarms`` increments — then the
    phase re-arms only after the mean recovers below half the threshold
    (hysteresis), so a sustained excursion is one alarm, not one per
    observation.

    `spec` is the model under test — a plain `BackendSpec` or a
    `CalibratedBackendSpec` (whose per-model init and runtime fits are
    used for prediction when available).
    """

    def __init__(self, spec: BackendSpec, *, registry: Any = None,
                 tracer: Any = None, window: int = 64,
                 drift_logratio: float = math.log(2.0),
                 min_n: int = 8, eps: float = 1e-6,
                 on_alarm: Any = None):
        self.spec = spec
        self.registry = registry
        self.tracer = tracer
        self.window = int(window)
        self.drift_logratio = float(drift_logratio)
        self.min_n = int(min_n)
        self.eps = float(eps)
        # callback fired (best-effort) on every drift alarm with
        # (alarm_dict, now) — e.g. SurrogateOffload.note_drift_alarm, so
        # a drifting cost model auto-disables offload for a cool-down
        self.on_alarm = on_alarm
        self._ratios: Dict[str, deque] = {}
        self._armed: Dict[str, bool] = {}
        self.alarms: List[Dict[str, Any]] = []
        self.n_observed = 0

    # -- feeding ---------------------------------------------------------
    def observe_attempt(self, model: str, *, dispatch_s: float,
                        init_s: float, compute_s: Optional[float] = None,
                        now: float = 0.0) -> None:
        """One completed attempt's observed overheads (and optionally
        compute) against the spec's predictions."""
        self.observe("dispatch", self.spec.dispatch_latency, dispatch_s,
                     now, key=model)
        if init_s > 0:
            pred = (self.spec.server_init_for(model)
                    if hasattr(self.spec, "server_init_for")
                    else self.spec.server_init)
            self.observe("init", pred, init_s, now, key=model)
        if compute_s is not None and hasattr(self.spec, "runtime_fit"):
            fit = self.spec.runtime_fit(model)
            if fit is not None:
                self.observe("runtime", fit.median, compute_s, now,
                             key=model)

    def observe_queue_wait(self, alloc: Any, now: float) -> None:
        """A granted allocation's observed queue wait vs the model."""
        pred = self.spec.queue_wait_median(
            getattr(alloc, "walltime_s", math.inf))
        self.observe("queue_wait", pred, float(alloc.queue_wait), now,
                     key=getattr(alloc, "alloc_id", None))

    def observe(self, phase: str, predicted: float, observed: float,
                now: float, key: Any = None) -> None:
        self.n_observed += 1
        ratio = math.log((max(observed, 0.0) + self.eps)
                         / (max(predicted, 0.0) + self.eps))
        if self.registry is not None:
            self.registry.observe(f"calib_{phase}_abs_residual",
                                  abs(observed - predicted))
        win = self._ratios.get(phase)
        if win is None:
            win = self._ratios[phase] = deque(maxlen=self.window)
            self._armed[phase] = True
        win.append(ratio)
        if len(win) < self.min_n:
            return
        mean = sum(win) / len(win)
        if self.registry is not None:
            self.registry.set_gauge(f"calib_{phase}_mean_logratio", mean)
        if abs(mean) >= self.drift_logratio:
            if self._armed[phase]:
                self._armed[phase] = False
                self._alarm(phase, mean, predicted, observed, now, key)
        elif abs(mean) <= self.drift_logratio / 2.0:
            self._armed[phase] = True          # recovered: re-arm

    def consume(self, events: Sequence[TraceEvent]) -> int:
        """Offline feeding: replay a recorded trace's observations into
        the monitor (attempts and queue waits, in trace order).  Returns
        the number of observations fed — the after-the-fact drift check
        for logs recorded without a live monitor."""
        fed = 0
        pending_init: Dict[Tuple[Any, int], float] = {}
        pending_disp: Dict[Tuple[Any, int], float] = {}
        for ts, ph, name, pid, tid, dur, args in events:
            a = args or {}
            if ph == "X" and name == "task.init":
                pending_init[(a.get("task"), a.get("attempt", 1))] = \
                    a.get("init", dur)
            elif ph == "X" and name == "task.dispatch":
                pending_disp[(a.get("task"), a.get("attempt", 1))] = dur
            elif ph == "X" and name == "task.run":
                key = (a.get("task"), a.get("attempt", 1))
                self.observe_attempt(
                    a.get("model", ""),
                    dispatch_s=pending_disp.pop(key, 0.0),
                    init_s=pending_init.pop(key, 0.0),
                    compute_s=a.get("compute", dur),
                    now=ts + dur)
                fed += 1
            elif name == "alloc.queued" and not a.get("virtual"):
                if ph == "B" and "queue_wait" in a:
                    wall = a.get("walltime_s")
                    pred = self.spec.queue_wait_median(
                        wall if wall is not None else math.inf)
                    self.observe("queue_wait", pred, a["queue_wait"], ts,
                                 key=a.get("alloc"))
                    fed += 1
        return fed

    # -- alarm plumbing --------------------------------------------------
    def _alarm(self, phase: str, mean: float, predicted: float,
               observed: float, now: float, key: Any) -> None:
        alarm = {"phase": phase, "t": float(now),
                 "mean_logratio": float(mean),
                 "predicted": float(predicted),
                 "observed": float(observed), "key": key}
        self.alarms.append(alarm)
        if self.registry is not None:
            self.registry.inc("calib_drift_alarms")
            self.registry.inc(f"calib_drift_alarms_{phase}")
        if self.tracer is not None:
            self.tracer.instant(
                "calib.drift", ts=now,
                args={"phase": phase,
                      "mean_logratio": float(mean),
                      "predicted": float(predicted),
                      "observed": float(observed)})
        if self.on_alarm is not None:
            try:
                self.on_alarm(alarm, now)
            except Exception:  # noqa: BLE001 — alarms must never kill a run
                pass

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"n_observed": self.n_observed,
                               "n_alarms": len(self.alarms),
                               "phases": {}}
        for phase, win in self._ratios.items():
            if win:
                out["phases"][phase] = {
                    "n": len(win),
                    "mean_logratio": sum(win) / len(win),
                }
        return out
