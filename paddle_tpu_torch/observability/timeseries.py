"""Fleet observability: bounded-ring time series + anomaly alert rules.

Ports ``paddle_tpu/observability/timeseries.py`` by copy (pure Python,
with the reference's metric names, span names, JSON fields and
routes).

Every signal the runtime exports today is an *instantaneous* snapshot
— the registry value right now, the burn rate right now.  This module
adds history and judgement on top of the same registry:

  * :class:`Series` — a bounded ring of ``(t, value)`` points with
    window / ``delta()`` / ``rate()`` queries (monotonic clock, fixed
    memory; the time-series analog of the flight recorder's ring).
  * :class:`TimeSeriesStore` — samples registered *sources* (callables,
    typically registry read-backs via :func:`metric_value`) on an
    explicit ``tick(now)``.  Production drives ticks from a sampler
    thread (``start_sampling``); tests drive them from a fake clock —
    the same split the serving watchdog uses, so nothing here ever
    sleeps in a unit test.
  * :class:`AlertRule` — threshold (``kind="value"``) and derivative
    (``kind="rate"``) rules over any series, with an optional ``when``
    gate (e.g. "tok/s collapsed *while slots were active*").  Each
    fire/clear transition bumps ``obs_alerts_total{rule}``, flips
    ``obs_alert_firing{rule}``, and stamps an ``alert`` event into the
    flight recorder; a clear -> firing edge additionally invokes the
    store's optional ``on_fire`` hook (capture.DiagnosticCapture
    snapshots its evidence bundle there); firing rules surface on
    ``/healthz`` and in the ``/debug/fleet`` replica summary.

Sampling reads values *back from the metrics registry* (the same
watchdog-safe pattern as resources._pool_from_registry) — never from
engine internals — so a tick takes no engine lock, triggers no device
work, and adds zero host syncs (gated by the reference's perf-gate
``telemetry`` scenario).  With ``FLAGS_obs_timeseries_interval_s``
unset no store is ever constructed: the serving path's only cost is an
attribute test, the same zero-overhead contract as fault injection and
the sanitizer.

In-process multi-replica tests share one registry, so registry-backed
sources (and therefore alerts) reflect the *process*, not one replica;
production replicas are separate processes where the two coincide.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from ..sanitizer import make_lock
from .registry import default_registry
from .tracing import flight_recorder

__all__ = ["AlertRule", "Series", "TimeSeriesStore", "default_rules",
           "metric_value", "serving_sources"]

_M_SAMPLES = default_registry().counter(
    "obs_timeseries_samples_total",
    "points appended to time-series rings by sampler ticks")
_M_ALERTS = default_registry().counter(
    "obs_alerts_total",
    "alert-rule fire transitions (clear -> firing), by rule", ("rule",))
_M_FIRING = default_registry().gauge(
    "obs_alert_firing",
    "1 while the named alert rule is firing, 0 otherwise", ("rule",))


def metric_value(name, labels=None, registry=None):
    """Read one registry family back as a scalar: the sum of its series
    values, optionally filtered to series whose labels contain the
    ``labels`` subset.  None when the family is not registered (the
    store skips the sample) or is a histogram."""
    reg = registry or default_registry()
    m = reg.get(name)
    if m is None or m.kind == "histogram":
        return None
    want = tuple(sorted((labels or {}).items()))
    total = 0.0
    for labelvalues, child in m._series():
        if want:
            have = dict(zip(m.labelnames, labelvalues))
            if any(have.get(k) != str(v) for k, v in want):
                continue
        total += child.value
    return total


class Series:
    """Bounded ring of ``(t, value)`` samples, newest last."""

    __slots__ = ("name", "_points")

    def __init__(self, name: str, capacity: int = 512):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.name = name
        # deque appends are atomic and points() snapshots via list(),
        # so readers never see a torn ring (same contract as the
        # flight recorder)
        self._points: deque = deque(maxlen=int(capacity))

    def add(self, t: float, value: float):
        self._points.append((float(t), float(value)))

    def __len__(self):
        return len(self._points)

    def last(self):
        """Newest ``(t, value)`` or None when empty."""
        try:
            return self._points[-1]
        except IndexError:
            return None

    def points(self, window_s: float | None = None,
               now: float | None = None) -> list:
        """Samples newest-last; ``window_s`` keeps only points within
        the trailing window ending at ``now`` (default: newest t)."""
        pts = list(self._points)
        if window_s is None or not pts:
            return pts
        end = pts[-1][0] if now is None else float(now)
        return [p for p in pts if p[0] >= end - float(window_s)]

    def delta(self, window_s: float | None = None,
              now: float | None = None):
        """last - first value over the window; None with < 2 points."""
        pts = self.points(window_s, now)
        if len(pts) < 2:
            return None
        return pts[-1][1] - pts[0][1]

    def rate(self, window_s: float | None = None,
             now: float | None = None):
        """(last - first) / elapsed over the window, per second; None
        with < 2 points or zero elapsed time."""
        pts = self.points(window_s, now)
        if len(pts) < 2:
            return None
        dt = pts[-1][0] - pts[0][0]
        if dt <= 0:
            return None
        return (pts[-1][1] - pts[0][1]) / dt

    def rate_points(self, window_s: float | None = None,
                    now: float | None = None) -> list:
        """Per-interval rates between consecutive samples — the
        sparkline view of a counter series."""
        pts = self.points(window_s, now)
        out = []
        for (t0, v0), (t1, v1) in zip(pts, pts[1:]):
            if t1 > t0:
                out.append((t1, (v1 - v0) / (t1 - t0)))
        return out


_OPS = {">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
        "<": lambda a, b: a < b, "<=": lambda a, b: a <= b}


class AlertRule:
    """One anomaly rule over one series.

    ``kind="value"`` compares the newest sample against the threshold;
    ``kind="rate"`` compares the per-second rate over the trailing
    ``window_s``.  Exactly one of ``above`` / ``below`` sets the
    threshold.  ``when`` optionally gates evaluation on another
    series' newest sample, e.g. ``("active_slots", ">", 0)`` so a
    tok/s collapse only fires while work was actually resident.
    ``min_samples`` suppresses firing until the series has history.
    """

    def __init__(self, name: str, series: str, *, above=None,
                 below=None, kind: str = "value",
                 window_s: float = 30.0, min_samples: int = 2,
                 when: tuple | None = None, help_: str = ""):
        if (above is None) == (below is None):
            raise ValueError(
                f"rule {name!r}: pass exactly one of above= / below=")
        if kind not in ("value", "rate"):
            raise ValueError(
                f"rule {name!r}: kind must be 'value' or 'rate', "
                f"got {kind!r}")
        if when is not None and (len(when) != 3 or when[1] not in _OPS):
            raise ValueError(
                f"rule {name!r}: when= must be (series, op, value) "
                f"with op in {sorted(_OPS)}")
        self.name = name
        self.series = series
        self.kind = kind
        self.op = "<" if above is None else ">"
        self.threshold = float(below if above is None else above)
        self.window_s = float(window_s)
        self.min_samples = max(int(min_samples), 2 if kind == "rate"
                               else 1)
        self.when = when
        self.help = help_

    def measure(self, store: "TimeSeriesStore", now: float):
        """Current comparison value, or None when the rule cannot be
        evaluated yet (missing series, too few samples, gate closed)."""
        s = store.series.get(self.series)
        if s is None or len(s) < self.min_samples:
            return None
        if self.when is not None:
            gate = store.series.get(self.when[0])
            last = gate.last() if gate is not None else None
            if last is None or not _OPS[self.when[1]](
                    last[1], float(self.when[2])):
                return None
        if self.kind == "rate":
            return s.rate(self.window_s, now)
        last = s.last()
        return None if last is None else last[1]

    def check(self, store: "TimeSeriesStore", now: float) -> bool:
        v = self.measure(store, now)
        return v is not None and _OPS[self.op](v, self.threshold)

    def describe(self) -> dict:
        return {"name": self.name, "series": self.series,
                "kind": self.kind,
                "condition": f"{self.kind}({self.series})"
                             f" {self.op} {self.threshold:g}",
                "window_s": self.window_s, "help": self.help}


class TimeSeriesStore:
    """Sources + rings + alert rules, advanced by explicit ticks.

    ``clock`` defaults to ``time.monotonic``; tests pass a fake.  The
    lock covers registration and tick bookkeeping — sources run
    *outside* any engine lock by design (registry read-backs only).
    """

    def __init__(self, capacity: int | None = None,
                 clock=time.monotonic):
        if capacity is None:
            from ..flags import FLAGS
            capacity = int(
                FLAGS.get("FLAGS_obs_timeseries_capacity") or 512)
        self.capacity = int(capacity)
        self._clock = clock
        self._lock = make_lock("TimeSeriesStore._lock")
        self._sources: dict[str, object] = {}       # name -> callable
        self._rates: list[tuple[str, str]] = []     # (series, of)
        self.series: dict[str, Series] = {}
        self.rules: list[AlertRule] = []
        self._firing: dict[str, dict] = {}
        self.ticks = 0
        self.samples = 0
        self.alerts_fired = 0
        self._sampler: threading.Thread | None = None
        self._sampler_stop = threading.Event()
        # optional fire-transition hook (DiagnosticCapture.attach):
        # called as on_fire(rule_name, info_dict) once per clear ->
        # firing edge, exception-fused.  None (the default) costs one
        # attribute test — the usual zero-overhead-off contract.
        self.on_fire = None

    # ------------------------------------------------------ registration
    def add_source(self, name: str, fn) -> Series:
        """Register a sampled callable; returning None skips a tick."""
        with self._lock:
            if name in self.series:
                raise ValueError(f"series {name!r} already registered")
            self._sources[name] = fn
            s = self.series[name] = Series(name, self.capacity)
        return s

    def add_metric(self, metric_name: str, series: str | None = None,
                   labels: dict | None = None) -> Series:
        """Sample a registry family (sum of its series, optionally
        label-filtered) under ``series`` (default: the metric name)."""
        return self.add_source(
            series or metric_name,
            lambda: metric_value(metric_name, labels))

    def add_rate(self, series: str, of: str) -> Series:
        """Derived series: per-second rate of ``of`` between its two
        newest samples — counters become sparkline-able throughputs
        (tok/s from serving_tokens_total)."""
        with self._lock:
            if series in self.series:
                raise ValueError(f"series {series!r} already registered")
            if of not in self.series:
                raise ValueError(f"base series {of!r} not registered")
            self._rates.append((series, of))
            s = self.series[series] = Series(series, self.capacity)
        return s

    def add_rule(self, rule: AlertRule) -> AlertRule:
        with self._lock:
            if any(r.name == rule.name for r in self.rules):
                raise ValueError(f"rule {rule.name!r} already registered")
            self.rules.append(rule)
        return rule

    # ------------------------------------------------------------- ticks
    def tick(self, now: float | None = None) -> int:
        """Sample every source, derive rate series, evaluate rules.
        Returns the number of points appended."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            sources = list(self._sources.items())
            rates = list(self._rates)
        appended = 0
        for name, fn in sources:
            try:
                v = fn()
            except Exception:
                v = None        # a broken source must not kill the tick
            if v is None:
                continue
            self.series[name].add(now, v)
            appended += 1
        for name, of in rates:
            base = self.series[of].points()
            if len(base) < 2:
                continue
            (t0, v0), (t1, v1) = base[-2], base[-1]
            if t1 > t0:
                self.series[name].add(now, (v1 - v0) / (t1 - t0))
                appended += 1
        with self._lock:
            self.ticks += 1
            self.samples += appended
        if appended:
            _M_SAMPLES.inc(appended)
        self._evaluate(now)
        return appended

    def _evaluate(self, now: float):
        for rule in self.rules:
            firing = rule.check(self, now)
            was = rule.name in self._firing
            if firing and not was:
                value = rule.measure(self, now)
                info = {"rule": rule.name, "series": rule.series,
                        "since": now, "value": value,
                        "condition": rule.describe()["condition"],
                        "help": rule.help}
                with self._lock:
                    self.alerts_fired += 1
                    self._firing[rule.name] = info
                _M_ALERTS.labels(rule.name).inc()
                _M_FIRING.labels(rule.name).set(1)
                flight_recorder().record(
                    "alert", "fire", rule=rule.name, series=rule.series,
                    value=value, threshold=rule.threshold)
                hook = self.on_fire
                if hook is not None:
                    try:
                        hook(rule.name, dict(info))
                    except Exception:
                        pass    # evidence capture must never break
                                # the alert evaluation that fired it
            elif firing and was:
                with self._lock:
                    self._firing[rule.name]["value"] = \
                        rule.measure(self, now)
            elif was and not firing:
                with self._lock:
                    del self._firing[rule.name]
                _M_FIRING.labels(rule.name).set(0)
                flight_recorder().record(
                    "alert", "clear", rule=rule.name, series=rule.series)

    # ----------------------------------------------------------- queries
    def firing(self) -> list:
        """Currently-firing alerts, ordered by rule name."""
        with self._lock:
            return [dict(self._firing[k])
                    for k in sorted(self._firing)]

    def windows(self, n: int | None = None) -> dict:
        """Recent ``[[t, value], ...]`` per series (newest last) — the
        compact history block of the /debug/fleet replica summary."""
        if n is None:
            from ..flags import FLAGS
            n = int(FLAGS.get("FLAGS_obs_fleet_window") or 32)
        out = {}
        for name in sorted(self.series):
            pts = self.series[name].points()[-int(n):]
            out[name] = [[round(t, 3), round(v, 6)] for t, v in pts]
        return out

    def state(self) -> dict:
        with self._lock:
            ticks, samples, fired = (self.ticks, self.samples,
                                     self.alerts_fired)
        return {"ticks": ticks, "samples": samples,
                "alerts_fired": fired,
                "series": sorted(self.series),
                "rules": [r.describe() for r in self.rules],
                "firing": self.firing()}

    # ----------------------------------------------------------- sampler
    def start_sampling(self, interval_s: float) -> "TimeSeriesStore":
        """Spawn the production tick loop (daemon thread).  A non-
        positive interval is a no-op, mirroring the watchdog."""
        if interval_s is None or float(interval_s) <= 0 \
                or self._sampler is not None:
            return self
        interval_s = float(interval_s)

        def loop():
            while not self._sampler_stop.wait(interval_s):
                self.tick()

        self._sampler = threading.Thread(
            target=loop, name="obs-sampler", daemon=True)
        self._sampler.start()
        return self

    def stop(self):
        self._sampler_stop.set()
        if self._sampler is not None:
            self._sampler.join(timeout=5.0)
            self._sampler = None
        self._sampler_stop = threading.Event()


def serving_sources(store: TimeSeriesStore) -> TimeSeriesStore:
    """Register the standard serving telemetry on ``store``: raw
    counters/gauges read back from the registry plus the derived
    signals the default alert rules and the dashboard consume (tok/s,
    prefix hit rate, max SLO burn rate)."""
    store.add_metric("serving_tokens_total", "tokens")
    store.add_metric("serving_decode_steps_total", "decode_steps")
    store.add_metric("serving_queue_depth", "queue_depth")
    store.add_metric("serving_active_slots", "active_slots")
    store.add_metric("serving_pages_free", "pages_free")
    store.add_metric("serving_pages_in_use", "pages_in_use")
    store.add_metric("serving_prefix_cached_pages", "cached_pages")
    store.add_metric("serving_page_fragmentation_ratio", "fragmentation")
    store.add_metric("serving_spec_acceptance_rate", "acceptance_rate")
    store.add_metric("serving_spec_tokens_total", "spec_proposed",
                     labels={"result": "proposed"})
    store.add_metric("serving_recovery_total", "recoveries")
    store.add_metric("serving_host_syncs_total", "host_syncs")
    store.add_rate("tok_s", of="tokens")

    def _prefix_hit_rate():
        hits = metric_value("serving_prefix_cache_pages_total",
                            {"result": "hit"})
        misses = metric_value("serving_prefix_cache_pages_total",
                              {"result": "miss"})
        if hits is None or misses is None or hits + misses == 0:
            return None
        return hits / (hits + misses)

    store.add_source("prefix_hit_rate", _prefix_hit_rate)

    def _burn_rate_max():
        m = default_registry().get("serving_slo_burn_rate")
        if m is None:
            return None
        values = [child.value for _, child in m._series()]
        return max(values) if values else None

    store.add_source("burn_rate_max", _burn_rate_max)
    return store


def default_rules(shed_burn_rate: float | None = None,
                  window_s: float = 30.0) -> list:
    """The stock anomaly rules over :func:`serving_sources` series.
    ``shed_burn_rate`` defaults to ``FLAGS_serving_shed_burn_rate``
    (falling back to burn rate 1.0 — budget consumed exactly at the
    objective's limit — when shedding is off)."""
    if shed_burn_rate is None:
        from ..flags import FLAGS
        shed_burn_rate = float(
            FLAGS.get("FLAGS_serving_shed_burn_rate") or 0.0)
    return [
        AlertRule("tok_s_collapse", "tokens", kind="rate", below=0.5,
                  window_s=window_s, min_samples=3,
                  when=("active_slots", ">", 0),
                  help_="decode throughput collapsed while slots were "
                        "active (stall / livelock signal)"),
        AlertRule("fragmentation_climb", "fragmentation", kind="rate",
                  above=0.02, window_s=window_s, min_samples=3,
                  help_="pool fragmentation climbing: the queue head "
                        "is losing placeable pages"),
        AlertRule("acceptance_drop", "acceptance_rate", below=0.2,
                  min_samples=2, when=("spec_proposed", ">", 0),
                  help_="speculative acceptance collapsed — drafts are "
                        "being paid for and thrown away"),
        AlertRule("burn_rate_breach", "burn_rate_max",
                  above=(shed_burn_rate or 1.0), min_samples=1,
                  help_="an SLO dimension is burning error budget at/"
                        "over the shed line"),
        AlertRule("recovery_surge", "recoveries", kind="rate",
                  above=0.0, window_s=window_s, min_samples=2,
                  help_="self-healing events (quarantine/rebuild/"
                        "stall) within the rate window"),
    ]
