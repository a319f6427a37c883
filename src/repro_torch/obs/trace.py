"""Structured span tracing for sim and live dispatch (`repro_torch.obs`).

One tracer covers both drivers because it is instrumented at the shared
choke points — `Broker.push`, the `LifecycleStepper` phases, and the
completion paths of `simulate_cluster` / `Executor._complete` — and is
timestamped by the *injected clock* (the sim binds its virtual event
time, the executor binds `self._clock`).  A seeded parity run therefore
produces the same span sequence from both drivers: same span names,
task/alloc ids, and virtual-clock timestamps (asserted in
`tests/test_parity.py`).

Event model (Chrome trace-event phases):

  * per-task spans on the scheduler process (pid 0, tid = task index):
    ``task.queued`` (X: queue entry -> dispatch decision),
    ``task.dispatch`` (X: decision -> occupancy), terminal instants
    ``task.ok`` / ``task.failed`` / ``task.timeout`` / ``task.lost``;
  * per-attempt execution spans on the owning allocation's process
    (pid = alloc_id + 1, tid = worker id): ``task.init``, ``task.run``;
  * per-allocation lifecycle spans (pid = alloc_id + 1, tid 0):
    ``alloc.queued`` / ``alloc.running`` / ``alloc.draining`` as B/E
    pairs, terminal ``alloc.expired`` instant — timestamped from the
    `Allocation`'s own fields (submit/grant/end), so they are
    parity-exact and monotone per track;
  * instants for scheduling decisions: ``offload.decide``,
    ``task.steal``, ``task.migrate``, ``task.requeue``, ``task.killed``,
    ``task.quarantined``, ``task.speculate``, ``task.hedge_cancel``,
    ``alloc.spawn`` / ``alloc.kill`` / ``alloc.drain-dry`` /
    ``alloc.cancel``, ``autoalloc.submit`` / ``autoalloc.drain``, and
    ``gp.predict_batch`` compile-shape launches.

Everything lands in a bounded ring buffer (oldest events drop first;
`n_dropped` says how many), exportable as JSONL (`write_jsonl`, loadable
back with schema validation via `read_jsonl`, or streamed incrementally
while the run is live via `stream_to`) and Chrome trace-event JSON
(`to_chrome` / `write_chrome`, loadable in Perfetto).  Tracing is opt-in
everywhere (`tracer=None` default) and the hot-path cost of one event is
a tuple append into a deque (plus one buffered line write when a stream
sink is attached).

Spans carry the exact model inputs calibration needs (`repro_torch.obs.calib`
/ `repro_torch.obs.replay` consume them): ``task.queued`` instants record the
request's model / time_request / n_cpus / parameters on first submit,
``task.init`` / ``task.run`` record the exact init and compute seconds
passed by the driver (a span's ``dur`` is a float *difference* of
endpoints, which is not bit-exact), and ``alloc.queued`` records the
drawn queue wait plus the allocation's shape — so a sim-recorded trace
replays to the original records exactly.
"""
from __future__ import annotations

import json
import math
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

# (ts, ph, name, pid, tid, dur, args): ph in {"B","E","X","i"}; dur is
# meaningful for "X" only; args is a small dict or None
TraceEvent = Tuple[float, str, str, int, int, float, Optional[dict]]

_ALLOC_RANK = {None: -1, "pending": -1, "queued": 0, "running": 1,
               "draining": 2, "expired": 3}


class RingBuffer:
    """Bounded append-only event store: O(1) append, oldest-first drop.

    Also serves as the `LifecycleStepper.events` audit trail bound (the
    unbounded-growth fix), so it supports the list-ish surface the
    drivers use: iteration, `len`, and `list(buf)`.
    """

    __slots__ = ("_buf", "n_seen")

    def __init__(self, capacity: int = 65536):
        self._buf: deque = deque(maxlen=int(capacity))
        self.n_seen = 0

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    @property
    def n_dropped(self) -> int:
        return self.n_seen - len(self._buf)

    def append(self, item) -> None:
        self.n_seen += 1
        self._buf.append(item)

    def clear(self) -> None:
        self._buf.clear()
        self.n_seen = 0

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self):
        return iter(self._buf)

    def __getitem__(self, i):
        return list(self._buf)[i]

    def __repr__(self) -> str:
        return (f"RingBuffer(len={len(self._buf)}, "
                f"capacity={self.capacity}, dropped={self.n_dropped})")


class Tracer:
    """Low-overhead span/instant recorder shared by sim and live.

    `clock` supplies default timestamps for instants; drivers bind their
    injected clock (`bind_clock`) so both paths stamp the same virtual
    seconds.  All helpers are plain tuple appends — safe under the
    executor's dispatch lock.
    """

    def __init__(self, capacity: int = 65536,
                 clock: Optional[Callable[[], float]] = None):
        self.buf = RingBuffer(capacity)
        self._clock: Callable[[], float] = clock or (lambda: 0.0)
        self._task_tids: Dict[str, int] = {}
        self._queued: Dict[Tuple[str, int], float] = {}
        self._alloc_state: Dict[int, Optional[str]] = {}
        self._alloc_open: Dict[int, str] = {}
        self._pid_labels: Dict[int, str] = {0: "scheduler"}
        self._sink = None                      # incremental JSONL stream

    def bind_clock(self, clock: Callable[[], float]) -> "Tracer":
        self._clock = clock
        return self

    # -- low-level emission ---------------------------------------------
    def emit(self, ph: str, name: str, ts: float, *, pid: int = 0,
             tid: int = 0, dur: float = 0.0,
             args: Optional[dict] = None) -> None:
        ev = (float(ts), ph, name, pid, tid, float(dur), args)
        self.buf.append(ev)
        if self._sink is not None:
            self._sink.write(_jsonl_line(ev))

    def instant(self, name: str, ts: Optional[float] = None, *,
                pid: int = 0, tid: int = 0,
                args: Optional[dict] = None) -> None:
        if ts is None:
            ts = self._clock()
        self.emit("i", name, ts, pid=pid, tid=tid, args=args)

    def span(self, name: str, start: float, end: float, *, pid: int = 0,
             tid: int = 0, args: Optional[dict] = None) -> None:
        self.emit("X", name, start, pid=pid, tid=tid,
                  dur=max(float(end) - float(start), 0.0), args=args)

    # -- task protocol ---------------------------------------------------
    def _tid(self, task_id: str) -> int:
        tid = self._task_tids.get(task_id)
        if tid is None:
            tid = len(self._task_tids)
            self._task_tids[task_id] = tid
        return tid

    def task_queued(self, task_id: str, attempt: int,
                    ts: Optional[float] = None, req: Any = None) -> None:
        """A (task, attempt) entered a scheduler queue (submit, requeue).

        Passing the `EvalRequest` as ``req`` records the request's shape
        (model / time_request / n_cpus / parameters) on the first-attempt
        instant — the metadata `repro_torch.obs.replay` needs to reconstruct
        the workload from the trace alone.  Requeues (attempt > 1) stay
        minimal: the task's identity was already recorded."""
        if ts is None:
            ts = self._clock()
        self._queued[(task_id, attempt)] = float(ts)
        args: dict = {"task": task_id, "attempt": attempt}
        if req is not None and attempt == 1:
            args["model"] = req.model_name
            if getattr(req, "time_request", None) is not None:
                args["time_request"] = float(req.time_request)
            if getattr(req, "n_cpus", 1) != 1:
                args["n_cpus"] = int(req.n_cpus)
            tenant = getattr(req, "tenant", "default")
            if tenant and tenant != "default":
                # default omitted: single-tenant traces stay byte-stable
                args["tenant"] = tenant
            if getattr(req, "deadline", None) is not None:
                args["deadline"] = float(req.deadline)
            params = getattr(req, "parameters", None)
            if _jsonable_matrix(params):
                args["parameters"] = params
        self.instant("task.queued", ts=ts, pid=0, tid=self._tid(task_id),
                     args=args)

    def task_attempt(self, task_id: str, alloc_id: int, wid: int,
                     mark_t: float, start_t: float, init_t: float,
                     end_t: float, attempt: int, status: str,
                     model: Optional[str] = None,
                     compute: Optional[float] = None) -> None:
        """One completed attempt: closes the queued span, records the
        dispatch/init/run spans on the worker track, and stamps the
        terminal instant (``task.<status>``).

        ``model`` and ``compute`` (the driver's exact compute seconds)
        land in the init/run span args so calibration can key samples by
        model and replay can reproduce runtimes bit-exactly (a span's
        ``dur`` is an endpoint difference, which loses the last ulp)."""
        tid = self._tid(task_id)
        q_ts = self._queued.pop((task_id, attempt), mark_t)
        a = {"task": task_id, "attempt": attempt}
        self.span("task.queued", q_ts, mark_t, pid=0, tid=tid, args=a)
        self.span("task.dispatch", mark_t, start_t, pid=0, tid=tid,
                  args={"task": task_id, "attempt": attempt,
                        "alloc": alloc_id})
        pid = alloc_id + 1
        if init_t > 0:
            ia = dict(a)
            ia["init"] = float(init_t)
            if model is not None:
                ia["model"] = model
            self.span("task.init", start_t, start_t + init_t, pid=pid,
                      tid=wid, args=ia)
        ra: dict = {"task": task_id, "attempt": attempt, "status": status}
        if model is not None:
            ra["model"] = model
        if compute is not None:
            ra["compute"] = float(compute)
        self.span("task.run", start_t + init_t, end_t, pid=pid, tid=wid,
                  args=ra)
        self.instant(f"task.{status}", ts=end_t, pid=0, tid=tid, args=a)

    def task_requeue(self, task_id: str, attempt: int, now: float,
                     since: float,
                     release: Optional[float] = None) -> None:
        """An in-flight attempt died with its allocation and was requeued
        at attempt+1.  ``since`` is the killed attempt's dispatch mark:
        the burned ``[since, now]`` interval is retry overhead.  With a
        `RetryPolicy` backoff the requeue is *released* later than the
        kill; ``release`` extends the retry interval to ``[since,
        release]`` (omitted when the requeue is immediate, which keeps
        legacy traces byte-identical)."""
        self._close_queued(task_id, attempt, since)
        args: dict = {"task": task_id, "attempt": attempt,
                      "since": float(since)}
        if release is not None and release > now:
            args["release"] = float(release)
        self.instant("task.requeue", ts=now, pid=0,
                     tid=self._tid(task_id), args=args)

    def task_killed(self, task_id: str, attempt: int, now: float,
                    since: float) -> None:
        """Killed with every attempt spent (terminal walltime kill)."""
        self._close_queued(task_id, attempt, since)
        self.instant("task.killed", ts=now, pid=0,
                     tid=self._tid(task_id),
                     args={"task": task_id, "attempt": attempt,
                           "since": float(since)})

    def task_quarantined(self, task_id: str, attempt: int, now: float,
                         since: float) -> None:
        """Poison task quarantined: it killed `quarantine_after` workers
        and is terminal instead of requeued (repro_torch.chaos hardening).
        Same shape as `task_killed` — burned ``[since, now]`` billed to
        the allocation — under a distinct terminal name."""
        self._close_queued(task_id, attempt, since)
        self.instant("task.quarantined", ts=now, pid=0,
                     tid=self._tid(task_id),
                     args={"task": task_id, "attempt": attempt,
                           "since": float(since)})

    def task_hedge_cancel(self, task_id: str, attempt: int, now: float,
                          since: float) -> None:
        """The losing copy of a speculatively re-executed task was
        cancelled at the winner's completion.  The loser's pending queued
        entry is dropped WITHOUT emitting a span — the loser lineage is
        accounted as a single `speculation` overhead component
        (`obs.attribution`), not as queue/dispatch time — and the burned
        ``[since, now]`` interval (zero when the loser never dispatched)
        feeds billing conservation."""
        self._queued.pop((task_id, attempt), None)
        self.instant("task.hedge_cancel", ts=now, pid=0,
                     tid=self._tid(task_id),
                     args={"task": task_id, "attempt": attempt,
                           "since": float(since)})

    def task_speculate(self, task_id: str, attempt: int, now: float,
                       since: float) -> None:
        """A p95-straggler hedge copy was pushed at ``attempt``.
        ``since`` is the original attempt's dispatch mark (what made it a
        straggler)."""
        self.instant("task.speculate", ts=now, pid=0,
                     tid=self._tid(task_id),
                     args={"task": task_id, "attempt": attempt,
                           "since": float(since)})

    def task_failed(self, task_id: str, attempt: int,
                    ts: Optional[float] = None) -> None:
        """Terminal failure outside the walltime-kill path (exceptions)."""
        if ts is None:
            ts = self._clock()
        self.instant("task.failed", ts=ts, pid=0, tid=self._tid(task_id),
                     args={"task": task_id, "attempt": attempt})

    def task_lost(self, task_id: str, now: float) -> None:
        """The run ended with this task still queued (never served)."""
        tid = self._tid(task_id)
        for key in sorted(k for k in self._queued if k[0] == task_id):
            q_ts = self._queued.pop(key)
            self.span("task.queued", q_ts, now, pid=0, tid=tid,
                      args={"task": task_id, "attempt": key[1]})
        self.instant("task.lost", ts=now, pid=0, tid=tid,
                     args={"task": task_id})

    def _close_queued(self, task_id: str, attempt: int,
                      until: float) -> None:
        q_ts = self._queued.pop((task_id, attempt), None)
        if q_ts is not None:
            self.span("task.queued", q_ts, until, pid=0,
                      tid=self._tid(task_id),
                      args={"task": task_id, "attempt": attempt})

    # -- allocation protocol ---------------------------------------------
    def alloc_state(self, alloc, ts: Optional[float] = None) -> None:
        """Record an allocation's lifecycle state, emitting every
        transition since the last recorded one (so a tracer attached to
        a broker with live allocations backfills their history).  The
        timestamps come from the `Allocation`'s own fields — identical
        between sim and live by the parity contract — except DRAINING,
        which is a decision with no field (the caller passes ``ts``)."""
        state = alloc.state
        aid = alloc.alloc_id
        if self._alloc_state.get(aid) == state:
            return
        pid = aid + 1
        self._pid_labels.setdefault(
            pid, f"alloc{aid}" + (" (virtual)" if alloc.virtual else ""))
        # draining is a decision, not a fact with a timestamp field: it
        # only exists as a state if drain() was actually called (in which
        # case alloc_state ran then) — never synthesise it in passing on
        # a direct RUNNING -> EXPIRED kill
        t_of = {"queued": alloc.submit_t, "running": alloc.ready_t,
                "draining": ts if state == "draining" else None,
                "expired": alloc.end_t}
        prev_rank = _ALLOC_RANK.get(self._alloc_state.get(aid), -1)
        target_rank = _ALLOC_RANK.get(state, -1)
        for st in ("queued", "running", "draining", "expired"):
            rank = _ALLOC_RANK[st]
            if rank <= prev_rank or rank > target_rank:
                continue
            t = t_of.get(st)
            if t is None:
                if st != state:
                    continue               # state skipped (e.g. cancel)
                t = ts if ts is not None else self._clock()
            self._alloc_transition(aid, pid, st, float(t),
                                   virtual=alloc.virtual, alloc=alloc)
        self._alloc_state[aid] = state

    def _alloc_transition(self, aid: int, pid: int, state: str, t: float,
                          *, virtual: bool = False,
                          alloc: Any = None) -> None:
        open_name = self._alloc_open.pop(aid, None)
        if open_name is not None:
            self.emit("E", open_name, t, pid=pid, tid=0)
        if state == "expired":
            self.instant("alloc.expired", ts=t, pid=pid, tid=0,
                         args={"alloc": aid})
        else:
            args: dict = {"alloc": aid, "virtual": virtual}
            if state == "queued" and alloc is not None:
                # the request shape + the DRAWN queue wait: a cancelled
                # allocation's B/E span is shorter than its draw, so the
                # drawn value must be recorded, not recovered from ts —
                # this is what keeps replay's queue-wait FIFO aligned
                qw = getattr(alloc, "queue_wait", None)
                if qw is not None:
                    args["queue_wait"] = float(qw)
                nw = getattr(alloc, "n_workers", None)
                if nw is not None:
                    args["n_workers"] = int(nw)
                wt = getattr(alloc, "walltime_s", None)
                if wt is not None and math.isfinite(wt):
                    args["walltime_s"] = float(wt)
            self.emit("B", f"alloc.{state}", t, pid=pid, tid=0, args=args)
            self._alloc_open[aid] = f"alloc.{state}"

    # -- export ----------------------------------------------------------
    def events(self) -> List[TraceEvent]:
        return list(self.buf)

    @property
    def n_dropped(self) -> int:
        return self.buf.n_dropped

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (Perfetto-loadable): ts/dur in
        microseconds, pid = allocation (+1; 0 is the scheduler), tid =
        worker (or task index on the scheduler process).  Events are
        globally sorted by timestamp, so per-track timestamps are
        monotone — `validate_chrome_trace` checks exactly that."""
        out: List[Dict[str, Any]] = []
        for pid in sorted(self._pid_labels):
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0,
                        "args": {"name": self._pid_labels[pid]}})
        # stable sort by timestamp only: same-ts events keep emission
        # order, which is the correct B/E nesting order per track (a
        # phase-priority tiebreak would split zero-length B/E pairs)
        for ts, ph, name, pid, tid, dur, args in sorted(
                self.buf, key=lambda e: e[0]):
            ev: Dict[str, Any] = {"name": name, "ph": ph,
                                  "ts": ts * 1e6, "pid": pid, "tid": tid}
            if ph == "X":
                ev["dur"] = dur * 1e6
            if ph == "i":
                ev["s"] = "t"
            if args:
                ev["args"] = args
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"n_dropped": self.buf.n_dropped}}

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_chrome(), fh)

    def write_jsonl(self, path: str) -> None:
        """One JSON object per event, in emission order (seconds),
        written one line at a time (never materialises the event list)."""
        with open(path, "w") as fh:
            for ev in self.buf:
                fh.write(_jsonl_line(ev))

    # -- incremental streaming -------------------------------------------
    def stream_to(self, path: str) -> "Tracer":
        """Open an incremental JSONL sink: events already buffered are
        written now, and every subsequent `emit` appends one line — so a
        crash mid-run still leaves a usable trace, and a run longer than
        the ring buffer is recorded in full (the buffer may drop, the
        stream does not).  Call `close_stream` (or rely on interpreter
        exit) when done."""
        self.close_stream()
        self._sink = open(path, "w")
        for ev in self.buf:
            self._sink.write(_jsonl_line(ev))
        return self

    def close_stream(self) -> None:
        if self._sink is not None:
            try:
                self._sink.close()
            finally:
                self._sink = None


def _jsonl_line(ev: TraceEvent) -> str:
    """The one JSONL encoding shared by `write_jsonl` and `stream_to`."""
    ts, ph, name, pid, tid, dur, args = ev
    row: Dict[str, Any] = {"ts": ts, "ph": ph, "name": name, "pid": pid,
                           "tid": tid}
    if ph == "X":
        row["dur"] = dur
    if args:
        row["args"] = args
    return json.dumps(row) + "\n"


def _jsonable_matrix(params: Any) -> bool:
    """True for a plain [[float, ...], ...] payload that survives a JSON
    round trip exactly (np.float32 etc. are excluded — they are not JSON
    serialisable and their repr is not the double the driver computed
    with)."""
    if not isinstance(params, list) or not params:
        return False
    for row in params:
        if not isinstance(row, list):
            return False
        for v in row:
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                return False
    return True


_PHASES = ("B", "E", "X", "i")


def validate_jsonl_row(row: Any) -> Optional[str]:
    """Schema check for one decoded JSONL trace row; None means valid."""
    if not isinstance(row, dict):
        return f"not an object: {row!r}"
    ph = row.get("ph")
    if ph not in _PHASES:
        return f"unknown phase {ph!r}"
    if not isinstance(row.get("name"), str) or not row["name"]:
        return f"missing name: {row!r}"
    ts = row.get("ts")
    if not isinstance(ts, (int, float)) or isinstance(ts, bool) \
            or not math.isfinite(ts):
        return f"bad ts {ts!r}"
    for key in ("pid", "tid"):
        v = row.get(key, 0)
        if not isinstance(v, int) or isinstance(v, bool):
            return f"bad {key} {v!r}"
    if ph == "X":
        dur = row.get("dur", 0.0)
        if not isinstance(dur, (int, float)) or isinstance(dur, bool) \
                or not math.isfinite(dur) or dur < 0:
            return f"bad X dur {dur!r}"
    if "args" in row and not isinstance(row["args"], dict):
        return f"bad args {row['args']!r}"
    return None


def read_jsonl(path: str, *, strict: bool = True) -> List[TraceEvent]:
    """Load a `write_jsonl` / `stream_to` trace back into `TraceEvent`
    tuples (the inverse of the export, in file order).

    Every row is schema-validated (`validate_jsonl_row`); with
    ``strict=True`` (default) a malformed line raises `ValueError` naming
    the line, otherwise bad lines are skipped.  This is the entry point
    real-cluster logs take into `repro_torch.obs.calib` / `repro_torch.obs.replay`:
    anything that serialises to this schema calibrates the simulator."""
    out: List[TraceEvent] = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError as e:
                if strict:
                    raise ValueError(
                        f"{path}:{lineno}: not JSON ({e})") from e
                continue
            problem = validate_jsonl_row(row)
            if problem is not None:
                if strict:
                    raise ValueError(f"{path}:{lineno}: {problem}")
                continue
            out.append((float(row["ts"]), row["ph"], row["name"],
                        int(row.get("pid", 0)), int(row.get("tid", 0)),
                        float(row.get("dur", 0.0)), row.get("args")))
    return out


def span_sequence(tracer: Tracer) -> List[Tuple]:
    """Canonical comparable form of a trace: events sorted by
    (timestamp, phase, name, pid, tid, dur, frozen-args).  Two parity
    drivers emit the same events at the same virtual times but not
    always in the same buffer order (the live executor grants its
    initial allocation inside ``__init__``), so sequence comparison is
    on this sorted normal form."""
    out = []
    for ts, ph, name, pid, tid, dur, args in tracer.buf:
        frozen = tuple(sorted(args.items())) if args else ()
        out.append((ts, ph, name, pid, tid, dur, frozen))
    out.sort(key=lambda e: (e[:6], repr(e[6])))
    return out


def validate_chrome_trace(obj: Any) -> List[str]:
    """Validate a Chrome trace-event JSON object (the CI smoke gate).

    Checks: known phases only (B/E/X/i/M), finite numeric timestamps,
    non-negative X durations, per-(pid, tid) monotone non-decreasing
    timestamps in list order, and well-nested B/E pairs per track
    (an E must close the most recent open B of the same name; unclosed
    B at end-of-trace is allowed — a ring buffer may have dropped the
    tail).  Returns a list of problems; empty means valid."""
    problems: List[str] = []
    events = obj.get("traceEvents") if isinstance(obj, dict) else obj
    if not isinstance(events, list):
        return ["no traceEvents list"]
    last_ts: Dict[Tuple[int, int], float] = {}
    stacks: Dict[Tuple[int, int], List[str]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("B", "E", "X", "i", "M"):
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            problems.append(f"event {i}: missing name")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or not math.isfinite(ts):
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        track = (ev.get("pid", 0), ev.get("tid", 0))
        prev = last_ts.get(track)
        if prev is not None and ts < prev - 1e-6:
            problems.append(f"event {i}: ts {ts} < {prev} on track "
                            f"{track} (non-monotone)")
        last_ts[track] = max(ts, prev if prev is not None else ts)
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or not \
                    math.isfinite(dur) or dur < 0:
                problems.append(f"event {i}: bad X dur {dur!r}")
        elif ph == "B":
            stacks.setdefault(track, []).append(ev.get("name", ""))
        elif ph == "E":
            stack = stacks.get(track)
            if not stack:
                problems.append(f"event {i}: E without open B on track "
                                f"{track}")
            elif stack[-1] != ev.get("name", ""):
                problems.append(
                    f"event {i}: E {ev.get('name')!r} does not close "
                    f"open B {stack[-1]!r} on track {track}")
            else:
                stack.pop()
    return problems
