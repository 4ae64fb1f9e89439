"""Tail-latency forensics: per-request lifecycle timelines, critical-
path attribution, and SLO-violation exemplars.

Ports ``paddle_tpu/observability/requestlog.py`` by copy (pure Python,
with the reference's metric names, span names, JSON fields and
routes).

The aggregate surfaces (burn rates, p99 tables, phase-attributed
profiles) say *that* the tail is bad; this module answers the
operator's first question — **why was request X slow?**

  * :class:`RequestTimeline` — a bounded per-request event list stamped
    on the ENGINE clock at the seams the engine already instruments
    (submit / admit / prefill / chunk / preempt / resume / host-sync /
    recovery replay / finalize), folded into a **critical-path
    attribution**: exact second buckets :data:`BUCKETS` whose sum
    equals the measured E2E (``finished_at - arrival_time``) by
    construction — every ``note`` charges the interval since a single
    advancing cursor, so the bucket sums telescope to the request's
    wall clock.  Conservation is checked like the usage meter's
    page-second law: ``round(sum(buckets) - e2e, 6) == 0``.
  * :class:`ExemplarStore` — a bounded worst-K reservoir per SLO
    dimension (ttft/tpot/e2e) and per ``finish_reason="error"``, keyed
    by tenant/adapter/priority, snapshotting the full timeline +
    attribution whenever the SLOTracker records a violation (wired to
    ``SLOTracker.exemplar_hook``).  Each record carries the violating
    request's trace id, so ``/debug/trace`` and ``/debug/exemplars``
    cross-reference by one id.
  * :class:`RequestLog` — the engine-attached container: a bounded
    id -> timeline map behind ``GET /debug/requests/<id>`` (waterfall
    JSON + chrome-trace export), the exemplar store behind
    ``GET /debug/exemplars``, and the
    ``serving_latency_attribution_seconds_total{cause}`` counter.

Zero-overhead-off: the engine holds ``requestlog=None`` by default and
every hot-path site is a single ``is not None`` test (the faults /
usage / slo guard pattern); armed-mode cost is pinned by the
``tail_forensics`` perf-gate scenario.
"""
from __future__ import annotations

from collections import OrderedDict

from ..sanitizer import make_lock
from .registry import default_registry

__all__ = ["BUCKETS", "ExemplarStore", "RequestLog", "RequestTimeline",
           "merge_exemplars", "active_requestlog",
           "set_active_requestlog"]

# the nine critical-path causes a request's E2E decomposes into; their
# per-request sum equals finished_at - arrival_time exactly (network is
# the router-side bucket — 0.0 for in-process requests)
BUCKETS = ("queue", "prefill_compute", "prefill_cached", "chunk_gap",
           "preempted", "host_sync", "decode", "recovery", "network")

_M_ATTR = default_registry().counter(
    "serving_latency_attribution_seconds_total",
    "request wall seconds by critical-path cause: per-request E2E "
    "decomposed into queue wait, prefill compute vs prefix-cache "
    "credit, chunked-prefill gaps, preemption (spill + re-queue + "
    "restore), blocking host syncs, decode, recovery replays, and "
    "router hops — buckets sum to serving_e2e_seconds' mass",
    ("cause",))


class RequestTimeline:
    """One request's lifecycle on the engine clock.

    ``note(bucket, t)`` charges the interval since the cursor (which
    starts at ``arrival_time``) to ``bucket`` and advances the cursor
    to ``t`` — attribution conservation holds by construction because
    the cursor only moves forward and every second between arrival and
    finish is charged exactly once.  The event list is bounded
    (``max_events``); overflow drops *events* (counted), never bucket
    seconds.
    """

    __slots__ = ("req_id", "trace_id", "tenant", "adapter", "priority",
                 "arrival_time", "buckets", "events", "events_dropped",
                 "max_events", "_cursor", "_residual", "finished",
                 "finish_reason", "e2e_s")

    def __init__(self, req, *, max_events: int = 256):
        self.req_id = req.id
        self.trace_id = (req.root_span.trace_id
                         if req.root_span is not None else None)
        self.tenant = getattr(req, "tenant", "anon")
        self.adapter = getattr(req, "adapter", None)
        self.priority = getattr(req, "priority", 0)
        self.arrival_time = req.arrival_time
        self.buckets = {b: 0.0 for b in BUCKETS}
        self.events: list[dict] = []
        self.events_dropped = 0
        self.max_events = int(max_events)
        self._cursor = req.arrival_time
        self._residual = "queue"        # bucket an eviction charges now
        self.finished = False
        self.finish_reason = None
        self.e2e_s = None
        self._event("submit", req.arrival_time, 0.0, None,
                    prompt_len=int(req.prompt.size))

    # ------------------------------------------------------------ recording
    def _event(self, kind: str, t: float, dur: float,
               bucket: str | None, **attrs):
        if len(self.events) >= self.max_events:
            self.events_dropped += 1
            return
        ev = {"event": kind, "t": round(t - self.arrival_time, 6),
              "dur": round(dur, 6)}
        if bucket is not None:
            ev["bucket"] = bucket
        if attrs:
            ev.update(attrs)
        self.events.append(ev)

    def note(self, bucket: str, t: float, *, event: str | None = None,
             then: str | None = None, **attrs) -> float:
        """Charge ``[cursor, t]`` to ``bucket``; optionally record an
        event.  ``then`` names the bucket a finalize would charge the
        *next* interval to (the request's state after this seam)."""
        dt = max(t - self._cursor, 0.0)
        self.buckets[bucket] += dt
        self._cursor = max(self._cursor, t)
        if then is not None:
            self._residual = then
        if event is not None:
            self._event(event, self._cursor, dt, bucket, **attrs)
        return dt

    def note_prefill(self, t: float, *, cached: int, computed: int,
                     event: str = "prefill", **attrs):
        """Charge the prefill interval split between compute and the
        prefix-cache credit by token share — cached tokens cost no
        device work, so their share of the wall is the cache's win."""
        total = max(cached + computed, 1)
        frac = cached / total
        dt = max(t - self._cursor, 0.0)
        self.buckets["prefill_cached"] += dt * frac
        self.buckets["prefill_compute"] += dt * (1.0 - frac)
        self._cursor = max(self._cursor, t)
        self._residual = "decode"
        self._event(event, self._cursor, dt, "prefill_compute",
                    cached_tokens=int(cached),
                    computed_tokens=int(computed), **attrs)

    def note_sync(self, t: float, sync_s: float):
        """One host sync observed while decoding: split the interval
        since the cursor at ``t - sync_s`` — the earlier part was
        decode dispatch, the blocking ring fetch was the sync."""
        dt = max(t - self._cursor, 0.0)
        sync_part = min(max(sync_s, 0.0), dt)
        self.buckets["decode"] += dt - sync_part
        self.buckets["host_sync"] += sync_part
        self._cursor = max(self._cursor, t)
        self._residual = "decode"
        self._event("host_sync", self._cursor, dt, "host_sync",
                    sync_s=round(sync_part, 6))

    def mark(self, kind: str, t: float, **attrs):
        """Zero-duration marker (first token, eviction reason, ...) —
        no bucket charge, the cursor does not move."""
        self._event(kind, t, 0.0, None, **attrs)

    def finish(self, reason: str, now: float):
        """Charge the residual interval to the bucket of the state the
        request died in, stamp the outcome, and freeze the timeline."""
        self.note(self._residual, now, event="finish", reason=reason)
        self.finished = True
        self.finish_reason = reason
        self.e2e_s = now - self.arrival_time

    # ------------------------------------------------------------ reporting
    def attribution(self) -> dict:
        return dict(self.buckets)

    def conservation_delta(self) -> float:
        """``sum(buckets) - measured E2E`` — 0.0 (to 6 decimals) for
        every finished request, the page-second-law analog."""
        if self.e2e_s is None:
            return 0.0
        return round(sum(self.buckets.values()) - self.e2e_s, 6)

    def to_dict(self) -> dict:
        """The waterfall JSON behind ``GET /debug/requests/<id>``."""
        return {
            "request": self.req_id,
            "trace_id": self.trace_id,
            "tenant": self.tenant,
            "adapter": self.adapter,
            "priority": self.priority,
            "arrival_time": self.arrival_time,
            "finished": self.finished,
            "finish_reason": self.finish_reason,
            "e2e_s": (None if self.e2e_s is None
                      else round(self.e2e_s, 6)),
            "attribution": {b: round(v, 6)
                            for b, v in self.buckets.items()},
            "conservation_delta": self.conservation_delta(),
            "events": list(self.events),
            "events_dropped": self.events_dropped,
        }

    def chrome_trace(self) -> dict:
        """chrome://tracing-loadable export: one complete ("X") event
        per charged timeline event, offset from arrival in µs."""
        trace = []
        for ev in self.events:
            dur_us = ev["dur"] * 1e6
            trace.append({
                "name": ev["event"], "ph": "X", "cat": "request",
                "ts": (ev["t"] * 1e6) - dur_us, "dur": dur_us,
                "pid": 1, "tid": self.req_id,
                "args": {k: v for k, v in ev.items()
                         if k not in ("event", "t", "dur")}})
        return {"traceEvents": trace, "request": self.req_id,
                "trace_id": self.trace_id}


class ExemplarStore:
    """Bounded worst-K reservoir of violating requests per SLO
    dimension (ttft/tpot/e2e) plus ``finish_reason="error"`` — each
    record snapshots the full timeline + attribution at capture time
    and carries the request's trace id for the ``/debug/trace`` join."""

    DIMENSIONS = ("ttft", "tpot", "e2e", "error")

    def __init__(self, k: int = 8):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = int(k)
        self._lock = make_lock("ExemplarStore._lock")
        self._worst: dict[str, list[dict]] = {
            d: [] for d in self.DIMENSIONS}
        self.offered = 0
        self.kept = 0

    def offer(self, dim: str, score_s: float, timeline: RequestTimeline):
        """Consider one violating request for the ``dim`` reservoir;
        kept while it ranks among the worst K by ``score_s``."""
        record = {
            "dimension": dim,
            "score_s": round(float(score_s), 6),
            "request": timeline.req_id,
            "trace_id": timeline.trace_id,
            "tenant": timeline.tenant,
            "adapter": timeline.adapter,
            "priority": timeline.priority,
            "captured_at": timeline.arrival_time
            + (timeline.e2e_s or 0.0),
            "timeline": timeline.to_dict(),
        }
        with self._lock:
            self.offered += 1
            worst = self._worst[dim]
            worst.append(record)
            worst.sort(key=lambda r: (-r["score_s"], r["request"]))
            if len(worst) > self.k:
                worst.pop()
            if record in worst:
                self.kept += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "k": self.k,
                "offered": self.offered,
                "kept": self.kept,
                "by_dimension": {d: [dict(r) for r in lst]
                                 for d, lst in self._worst.items()},
            }


def merge_exemplars(snapshots, *, k: int | None = None) -> dict:
    """Raw-merge per-replica exemplar snapshots for the router view:
    per-dimension lists concatenate and re-rank worst-first (never
    averaging), counters sum.  ``None`` entries (dead replicas,
    forensics off) are skipped — the /debug/fleet stale-nulling
    discipline."""
    by_dim: dict[str, list[dict]] = {d: [] for d in
                                     ExemplarStore.DIMENSIONS}
    offered = kept = 0
    cap = 0
    live = 0
    for snap in snapshots:
        if not isinstance(snap, dict) or "by_dimension" not in snap:
            continue
        live += 1
        cap = max(cap, int(snap.get("k") or 0))
        offered += int(snap.get("offered") or 0)
        kept += int(snap.get("kept") or 0)
        for d, lst in snap["by_dimension"].items():
            by_dim.setdefault(d, []).extend(lst)
    cap = k if k is not None else max(cap, 1)
    for d, lst in by_dim.items():
        lst.sort(key=lambda r: (-r.get("score_s", 0.0),
                                r.get("request", 0)))
        del lst[cap:]
    return {"k": cap, "offered": offered, "kept": kept,
            "replicas_merged": live, "by_dimension": by_dim}


class RequestLog:
    """The engine-attached forensics container (``requestlog=`` /
    ``FLAGS_serving_request_log``): a bounded id -> timeline map plus
    the exemplar reservoir.  One instance per engine; the last engine
    built wins the process-active slot (``obs.set_active_requestlog``)
    so ``obs.dump()`` writes ``exemplars.json`` from it."""

    def __init__(self, *, max_requests: int = 512,
                 max_events: int = 256, k: int = 8):
        if max_requests < 1:
            raise ValueError(
                f"max_requests must be >= 1, got {max_requests}")
        self.max_requests = int(max_requests)
        self.max_events = int(max_events)
        self._lock = make_lock("RequestLog._lock")
        self._timelines: OrderedDict[int, RequestTimeline] = \
            OrderedDict()
        self.exemplars = ExemplarStore(k=k)
        self.events_total = 0           # perf-gate witness
        self.finished = 0
        self.evicted_timelines = 0
        self.recovery_sweeps = 0        # supervisor recover() passes
        # worst conservation miss ever observed (must stay 0.0)
        self.conservation_max_delta = 0.0
        # running per-cause totals across finished requests (python
        # mirror of serving_latency_attribution_seconds_total)
        self.bucket_totals = {b: 0.0 for b in BUCKETS}

    # ------------------------------------------------------- engine seams
    def attach(self, req) -> RequestTimeline:
        """Create and register ``req``'s timeline (engine.submit)."""
        tl = RequestTimeline(req, max_events=self.max_events)
        with self._lock:
            self._timelines[req.id] = tl
            while len(self._timelines) > self.max_requests:
                self._timelines.popitem(last=False)
                self.evicted_timelines += 1
        req.timeline = tl
        return tl

    def discard(self, req_id: int):
        """Drop a timeline registered by a submit that then failed."""
        with self._lock:
            self._timelines.pop(req_id, None)

    def on_finish(self, req, reason: str, now: float):
        """Engine._finalize seam: close the timeline, fold its buckets
        into the attribution counter, track conservation, and capture
        an error exemplar when the request was quarantined."""
        tl = req.timeline
        if tl is None or tl.finished:
            return
        tl.finish(reason, now)
        with self._lock:
            self.finished += 1
            self.events_total += len(tl.events) + tl.events_dropped
            delta = abs(tl.conservation_delta())
            if delta > self.conservation_max_delta:
                self.conservation_max_delta = delta
            for bucket, seconds in tl.buckets.items():
                self.bucket_totals[bucket] += seconds
        for bucket, seconds in tl.buckets.items():
            if seconds > 0.0:
                _M_ATTR.labels(bucket).inc(seconds)
        if reason == "error":
            self.exemplars.offer("error", tl.e2e_s or 0.0, tl)

    def slo_verdict(self, req, dim: str, ok: bool,
                    value: float | None = None):
        """``SLOTracker.exemplar_hook`` adapter: snapshot the violating
        request's timeline into the ``dim`` reservoir.  ``value`` is
        the measured latency the tracker already computed (None when a
        request never produced a first token)."""
        if ok:
            return
        tl = getattr(req, "timeline", None)
        if tl is None:
            return
        self.exemplars.offer(dim, value if value is not None
                             else (tl.e2e_s or 0.0), tl)

    def note_recovery(self, result: dict | None = None):
        """Supervisor seam: count one recovery sweep (the per-request
        replay seconds land in each timeline's ``recovery`` bucket)."""
        with self._lock:
            self.recovery_sweeps += 1

    # ---------------------------------------------------------- reporting
    def get(self, req_id: int) -> RequestTimeline | None:
        with self._lock:
            return self._timelines.get(req_id)

    def timelines(self) -> list[RequestTimeline]:
        with self._lock:
            return list(self._timelines.values())

    def snapshot(self) -> dict:
        """``GET /debug/exemplars`` / ``exemplars.json`` payload."""
        with self._lock:
            tracked = len(self._timelines)
            finished = self.finished
            events_total = self.events_total
            evicted = self.evicted_timelines
            sweeps = self.recovery_sweeps
            delta = round(self.conservation_max_delta, 6)
            totals = {b: round(v, 6)
                      for b, v in self.bucket_totals.items()}
        return {
            "requests_tracked": tracked,
            "finished": finished,
            "events_total": events_total,
            "evicted_timelines": evicted,
            "recovery_sweeps": sweeps,
            "conservation_max_delta": delta,
            "attribution_totals_s": totals,
            "exemplars": self.exemplars.snapshot(),
        }

    def tail_summary(self, now: float | None = None) -> dict | None:
        """The fleet-summary ``tail`` block: the dominant cause across
        finished requests plus the single worst exemplar (``age_s`` on
        the engine clock when ``now`` is given).  None until a request
        finishes — the dashboard prints nothing for idle replicas."""
        with self._lock:
            if not self.finished:
                return None
            totals = dict(self.bucket_totals)
            delta = round(self.conservation_max_delta, 6)
            finished = self.finished
        top = max(totals, key=lambda b: totals[b])
        worst = None
        for lst in self.exemplars.snapshot()["by_dimension"].values():
            for rec in lst:
                if worst is None or rec["score_s"] > worst["score_s"]:
                    worst = rec
        if worst is not None:
            worst = {k: worst[k] for k in
                     ("dimension", "score_s", "request", "trace_id",
                      "tenant", "adapter", "captured_at")}
            if now is not None:
                worst["age_s"] = round(
                    max(now - worst["captured_at"], 0.0), 6)
        return {"finished": finished,
                "top_cause": top,
                "top_cause_s": round(totals[top], 6),
                "attribution_totals_s": {b: round(v, 6)
                                         for b, v in totals.items()},
                "conservation_max_delta": delta,
                "worst_exemplar": worst}


# the process-active request log: obs.dump() writes exemplars.json
# from it (last engine built wins — the profiler/usage holder contract)
_active_requestlog: RequestLog | None = None


def set_active_requestlog(log: RequestLog | None):
    global _active_requestlog
    _active_requestlog = log


def active_requestlog() -> RequestLog | None:
    return _active_requestlog
