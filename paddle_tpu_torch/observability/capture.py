"""Alert-triggered diagnostic capture: the flight-data recorder.

Ports ``paddle_tpu/observability/capture.py`` by copy (pure Python,
with the reference's metric names, span names, JSON fields and
routes).

The time-series alert rules *detect* anomalies (tok/s collapse, fragmentation
climb) but until now a fire only bumped a counter — the evidence that
explains the anomaly exists exactly at fire time and was thrown away.
:class:`DiagnosticCapture` hooks :class:`TimeSeriesStore` fire events
(``store.on_fire``) and snapshots a bounded bundle the moment a rule
transitions clear -> firing:

  * the profiler window (``SamplingProfiler.snapshot()``) when one is
    running — the phase-attributed hot stacks *during* the anomaly;
  * the flight-recorder ring — the engine/scheduler events leading up
    to it;
  * ``ResourceTracker.snapshot()`` — memory / goodput / pool state;
  * ``lock_wait_graph()`` — who holds and waits on every sanitized
    lock (empty with the sanitizer off);
  * the recent time-series windows — the sparkline history that fired.

Each bundle lands as ``capture_<n>.json`` in ``FLAGS_obs_capture_dir``
(default: ``FLAGS_metrics_dir``) and in a bounded in-memory ring that
``GET /debug/captures`` serves even with no directory configured.
Noisy rules are rate-limited (``min_interval_s`` per rule) and
retention is bounded (``max_captures`` — the oldest file is deleted),
so a flapping alert cannot fill a disk.  Everything read here follows
the watchdog-dump contract: own-lock or lock-free reads only, each
wrapped so a broken source degrades that field to None instead of
killing the alert evaluation that invoked us.

Tests drive ``on_alert`` directly with a fake clock; production wiring
is one line: ``DiagnosticCapture(...).attach(store)``.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque

from ..sanitizer import make_lock
from .registry import default_registry
from .tracing import flight_recorder

__all__ = ["DiagnosticCapture", "active_capture", "set_active_capture"]

_M_CAPTURES = default_registry().counter(
    "obs_captures_total",
    "diagnostic bundles captured on alert fire transitions, by rule",
    ("rule",))
_M_RATE_LIMITED = default_registry().counter(
    "obs_captures_rate_limited_total",
    "alert fires skipped by the per-rule capture rate limit", ("rule",))


class DiagnosticCapture:
    """Bounded alert-evidence recorder over one process.

    ``profiler`` / ``store`` are optional: without a profiler the
    bundle's ``profile`` field is None; without a store there are no
    series windows (and nothing calls ``on_alert`` unless wired by
    hand).  ``clock`` feeds the rate limiter — monotonic in
    production, fake in tests.
    """

    def __init__(self, *, dir_=None, min_interval_s: float | None = None,
                 max_captures: int | None = None, profiler=None,
                 store=None, clock=time.monotonic):
        from ..flags import FLAGS
        if dir_ is None:
            dir_ = (FLAGS.get("FLAGS_obs_capture_dir")
                    or FLAGS.get("FLAGS_metrics_dir") or None)
        if min_interval_s is None:
            min_interval_s = float(
                FLAGS.get("FLAGS_obs_capture_min_interval_s") or 60.0)
        if max_captures is None:
            max_captures = int(FLAGS.get("FLAGS_obs_capture_max") or 8)
        self.dir = dir_ or None
        self.min_interval_s = float(min_interval_s)
        self.max_captures = max(int(max_captures), 1)
        self.profiler = profiler
        self.store = store
        self._clock = clock
        self._lock = make_lock("DiagnosticCapture._lock")
        self._last_fire: dict[str, float] = {}      # rule -> last t
        self._bundles: deque = deque(maxlen=self.max_captures)
        self._paths: deque = deque()                # retained files
        self.captures = 0                           # python mirror
        self.rate_limited = 0
        self.by_rule: dict[str, int] = {}

    # ------------------------------------------------------------ wiring
    def attach(self, store) -> "DiagnosticCapture":
        """Hook a TimeSeriesStore's fire events; returns self."""
        self.store = store
        store.on_fire = self.on_alert
        return self

    # ----------------------------------------------------------- capture
    def on_alert(self, rule: str, info: dict | None = None,
                 now: float | None = None) -> dict | None:
        """One fire transition.  Returns the bundle written, or None
        when the per-rule rate limit suppressed it.  Never raises:
        invoked from inside alert evaluation."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            last = self._last_fire.get(rule)
            if last is not None and now - last < self.min_interval_s:
                self.rate_limited += 1
                limited = True
            else:
                self._last_fire[rule] = now
                self.captures += 1
                self.by_rule[rule] = self.by_rule.get(rule, 0) + 1
                n = self.captures
                limited = False
        if limited:
            _M_RATE_LIMITED.labels(rule).inc()
            return None
        bundle = self._bundle(rule, info, now, n)
        path = self._write(bundle, n)
        bundle["path"] = path
        with self._lock:
            self._bundles.append(bundle)
        _M_CAPTURES.labels(rule).inc()
        flight_recorder().record("capture", "write", rule=rule,
                                 capture=n, path=path)
        return bundle

    def _bundle(self, rule, info, now, n) -> dict:
        """Assemble the evidence.  Watchdog-dump contract: every source
        is individually fused — a broken one degrades to None."""
        try:
            profile = (self.profiler.snapshot()
                       if self.profiler is not None else None)
        except Exception:
            profile = None
        try:
            fr = flight_recorder()
            flight = {"capacity": fr.capacity, "events": fr.snapshot()}
        except Exception:
            flight = None
        try:
            from . import resource_tracker
            resources = resource_tracker().snapshot()
        except Exception:
            resources = None
        try:
            from ..sanitizer import lock_wait_graph
            lock_graph = lock_wait_graph()
        except Exception:
            lock_graph = None
        try:
            series = (self.store.windows()
                      if self.store is not None else None)
        except Exception:
            series = None
        return {"capture": n, "rule": rule, "alert": info,
                "captured_at": round(now, 6), "profile": profile,
                "flight": flight, "resources": resources,
                "lock_wait_graph": lock_graph, "series": series}

    def _write(self, bundle, n) -> str | None:
        if not self.dir:
            return None
        try:
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir, f"capture_{n}.json")
            with open(path, "w") as f:
                json.dump(bundle, f, indent=2)
        except (OSError, TypeError, ValueError):
            return None
        with self._lock:
            self._paths.append(path)
            evict = (self._paths.popleft()
                     if len(self._paths) > self.max_captures else None)
        if evict is not None:
            try:
                os.remove(evict)
            except OSError:
                pass
        return path

    # ----------------------------------------------------------- queries
    def index(self) -> dict:
        """The ``GET /debug/captures`` payload: counts + the retained
        bundle headlines (full bundles stay on disk / in recent())."""
        with self._lock:
            retained = [{"capture": b["capture"], "rule": b["rule"],
                         "captured_at": b["captured_at"],
                         "path": b.get("path")}
                        for b in self._bundles]
            return {"captures": self.captures,
                    "rate_limited": self.rate_limited,
                    "by_rule": dict(self.by_rule),
                    "min_interval_s": self.min_interval_s,
                    "max_captures": self.max_captures,
                    "dir": self.dir, "retained": retained}

    def recent(self, n: int | None = None) -> list[dict]:
        with self._lock:
            out = list(self._bundles)
        return out if n is None else out[-int(n):]


# process-wide capture recorder (installed by the serving server so
# observability.dump() can write captures.json next to the other
# artifacts)
_ACTIVE: DiagnosticCapture | None = None


def active_capture() -> DiagnosticCapture | None:
    return _ACTIVE


def set_active_capture(capture: DiagnosticCapture | None):
    global _ACTIVE
    _ACTIVE = capture
    return capture
