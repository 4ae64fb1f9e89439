"""Process-wide metrics registry: Counter / Gauge / Histogram with labels.

A copy of ``paddle_tpu/observability/registry.py`` (same metric names,
same export formats, the same sanitizer lock factory).  One registry
owns every runtime metric of the port and exports them as Prometheus
text or JSON.

Design constraints:
  * hot-path friendly — a bound child (``counter.labels(...)`` result,
    or the unlabeled default child) increments under one small lock;
    sub-microsecond, invisible next to a kernel launch.
  * optional event sampling — every counter and gauge change can also
    append a (perf_counter, name, value) sample so a chrome trace can
    carry "C"-phase counter tracks on the host clock.
"""
from __future__ import annotations

import json
import os
import time

from ..sanitizer import make_lock
from .quantiles import (  # noqa: F401  (re-export: one canonical impl)
    bucket_quantiles, merge_series_buckets, quantile_from_buckets)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "bucket_quantiles", "default_registry",
           "merge_series_buckets", "quantile_from_buckets",
           "SERVING_LATENCY_BUCKETS"]

# Prometheus-conventional default buckets (seconds-scale latencies).
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# Serving-latency buckets (TTFT / per-output-token): finer sub-ms floor
# than DEFAULT_BUCKETS — a decode step is tens of µs on-chip — while the
# tail still resolves multi-second queueing delays.
SERVING_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def _fmt_labels(labelnames, labelvalues):
    if not labelnames:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in zip(labelnames, labelvalues))
    return "{" + inner + "}"


def _escape(v):
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


def _escape_help(v):
    # HELP docstrings escape only backslash and newline (the text
    # exposition format; quotes stay literal there)
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


class _Child:
    """One (metric, labelvalues) time series."""

    __slots__ = ("_metric", "_labelvalues", "_lock", "_value")

    def __init__(self, metric, labelvalues):
        self._metric = metric
        self._labelvalues = labelvalues
        self._lock = make_lock(f"{metric.name}.child")
        self._value = 0.0

    @property
    def value(self):
        with self._lock:
            return self._value

    def _sample(self):
        reg = self._metric._registry
        if reg is not None and reg._sampling:
            reg._record_event(self._metric.name, self._labelvalues,
                              self._value)

    def reset(self):
        with self._lock:
            self._value = 0.0


class _CounterChild(_Child):
    def inc(self, n=1.0):
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n
        self._sample()


class _GaugeChild(_Child):
    def set(self, v):
        with self._lock:
            self._value = float(v)
        self._sample()

    def inc(self, n=1.0):
        with self._lock:
            self._value += n
        self._sample()

    def dec(self, n=1.0):
        self.inc(-n)


class _HistogramChild(_Child):
    __slots__ = ("_buckets", "_counts", "_sum", "_count")

    def __init__(self, metric, labelvalues):
        super().__init__(metric, labelvalues)
        self._buckets = metric.buckets
        self._counts = [0] * (len(self._buckets) + 1)   # +inf tail
        self._sum = 0.0
        self._count = 0

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._sum += v
            self._count += 1
            for i, le in enumerate(self._buckets):
                if v <= le:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def reset(self):
        with self._lock:
            self._counts = [0] * (len(self._buckets) + 1)
            self._sum = 0.0
            self._count = 0

    def snapshot(self):
        """Cumulative (le, count) pairs + sum/count, prometheus-style."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, acc = [], 0
        for le, c in zip(list(self._buckets) + ["+Inf"], counts):
            acc += c
            cum.append((le, acc))
        return {"buckets": cum, "sum": s, "count": total}

    def quantile(self, q):
        """Bucket-quantile estimate (upper bucket edge crossing the
        q-rank; see quantiles.quantile_from_buckets).  None when empty,
        ``"+Inf"`` when the rank lands in the overflow bucket."""
        snap = self.snapshot()
        return quantile_from_buckets(snap["buckets"], snap["count"], q)

    def quantiles(self, qs=(0.5, 0.95, 0.99)):
        snap = self.snapshot()
        return bucket_quantiles(snap["buckets"], snap["count"], qs)


class _Metric:
    """A named metric family; children are one per labelvalues tuple."""

    child_cls = _Child
    kind = "untyped"

    def __init__(self, name, help_="", labelnames=(), registry=None):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._registry = registry
        self._children: dict[tuple, _Child] = {}
        self._lock = make_lock(f"{name}.metric")
        if not self.labelnames:
            # pre-bind the unlabeled series so bare .inc()/.set() is one
            # attribute hop, no dict lookup on the hot path
            self._default = self._get_child(())
        else:
            self._default = None

    def labels(self, *labelvalues, **labelkw):
        if labelkw:
            if labelvalues:
                raise ValueError("pass labels positionally or by keyword, "
                                 "not both")
            labelvalues = tuple(labelkw[k] for k in self.labelnames)
        labelvalues = tuple(str(v) for v in labelvalues)
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} expects labels {self.labelnames}, "
                f"got {labelvalues}")
        return self._get_child(labelvalues)

    def _get_child(self, labelvalues):
        c = self._children.get(labelvalues)
        if c is None:
            with self._lock:
                c = self._children.setdefault(
                    labelvalues, self.child_cls(self, labelvalues))
        return c

    def _series(self):
        return list(self._children.items())

    def fold_label(self, labelname, value, into):
        """Bounded-cardinality eviction: move every child series whose
        ``labelname`` equals ``value`` into the series with that label
        replaced by ``into`` (values summed, originals dropped), so the
        family's grand total is preserved while the evicted label value
        disappears from the scrape.  Returns the number of series
        folded; a no-op when the family has no such label."""
        if labelname not in self.labelnames:
            return 0
        idx = self.labelnames.index(labelname)
        value, into = str(value), str(into)
        if value == into:
            return 0
        with self._lock:
            doomed = [lv for lv in self._children if lv[idx] == value]
            for lv in doomed:
                child = self._children.pop(lv)
                dest_lv = lv[:idx] + (into,) + lv[idx + 1:]
                dest = self._children.get(dest_lv)
                if dest is None:
                    dest = self.child_cls(self, dest_lv)
                    self._children[dest_lv] = dest
                self._fold_child(child, dest)
        return len(doomed)

    @staticmethod
    def _fold_child(child, dest):
        with child._lock:
            v = child._value
        with dest._lock:
            dest._value += v

    # delegate the unlabeled fast path
    def __getattr__(self, item):
        if item in ("inc", "dec", "set", "observe", "value", "count",
                    "sum", "snapshot", "quantile", "quantiles"):
            d = self.__dict__.get("_default")
            if d is None:
                raise ValueError(
                    f"metric {self.name!r} has labels {self.labelnames}; "
                    f"bind them with .labels(...) first")
            return getattr(d, item)
        raise AttributeError(item)


class Counter(_Metric):
    child_cls = _CounterChild
    kind = "counter"


class Gauge(_Metric):
    child_cls = _GaugeChild
    kind = "gauge"


class Histogram(_Metric):
    child_cls = _HistogramChild
    kind = "histogram"

    def __init__(self, name, help_="", labelnames=(), registry=None,
                 buckets=DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        super().__init__(name, help_, labelnames, registry)

    @staticmethod
    def _fold_child(child, dest):
        with child._lock:
            counts, s, n = list(child._counts), child._sum, child._count
        with dest._lock:
            for i, c in enumerate(counts):
                dest._counts[i] += c
            dest._sum += s
            dest._count += n


_METRIC_CLS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create metric families + bulk export (prometheus / JSON) +
    sampled counter events for the chrome trace."""

    MAX_EVENTS = 100_000          # sampling ring bound

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = make_lock("Registry._lock")
        self._sampling = False
        self._events: list[tuple[float, str, tuple, float]] = []
        self._events_lock = make_lock("Registry._events_lock")

    # ------------------------------------------------------- constructors
    def _get_or_create(self, kind, name, help_, labelnames, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if m.kind != kind or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind} "
                    f"with labels {m.labelnames}")
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = _METRIC_CLS[kind](name, help_, labelnames,
                                      registry=self, **kw)
                self._metrics[name] = m
            return m

    def counter(self, name, help_="", labelnames=()) -> Counter:
        return self._get_or_create("counter", name, help_, labelnames)

    def gauge(self, name, help_="", labelnames=()) -> Gauge:
        return self._get_or_create("gauge", name, help_, labelnames)

    def histogram(self, name, help_="", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create("histogram", name, help_, labelnames,
                                   buckets=buckets)

    def get(self, name):
        return self._metrics.get(name)

    def reset(self):
        """Zero every series in place and drop sampled events.  Families
        stay registered — modules hold pre-bound children (e.g. the
        eager-cache counters in ops/registry.py), so dropping them would
        orphan those hot-path handles."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            for _, child in m._series():
                child.reset()
        with self._events_lock:
            self._events.clear()

    # --------------------------------------------------- counter sampling
    def enable_event_sampling(self, on=True):
        self._sampling = bool(on)

    def _record_event(self, name, labelvalues, value):
        with self._events_lock:
            if len(self._events) < self.MAX_EVENTS:
                self._events.append(
                    (time.perf_counter(), name, labelvalues, value))

    def chrome_counter_events(self, pid=None):
        """Sampled metric changes as chrome-trace 'C' (counter) phase
        events, on the perf_counter clock RecordEvent spans use."""
        pid = os.getpid() if pid is None else pid
        with self._events_lock:
            events = list(self._events)
        out = []
        for t, name, labelvalues, value in events:
            series = name + _fmt_labels(
                self._metrics[name].labelnames
                if name in self._metrics else (), labelvalues)
            out.append({"name": series, "ph": "C", "ts": t * 1e6,
                        "pid": pid, "tid": 0, "args": {"value": value}})
        return out

    # ------------------------------------------------------------ export
    def to_prometheus(self) -> str:
        """Prometheus text exposition (format version 0.0.4).
        Conformance contract (tested by the text-format lint in
        tests/test_tracing.py): exactly one ``# HELP`` then one
        ``# TYPE`` line per family, in that order, before its samples;
        every histogram series exports a ``+Inf`` bucket whose
        cumulative count equals ``_count``, and both ``_sum`` and
        ``_count`` are present.  Serve with
        ``Content-Type: text/plain; version=0.0.4``."""
        lines = []
        for name, m in sorted(self._metrics.items()):
            lines.append(f"# HELP {name} {_escape_help(m.help)}".rstrip())
            lines.append(f"# TYPE {name} {m.kind}")
            for labelvalues, child in sorted(m._series()):
                lbl = _fmt_labels(m.labelnames, labelvalues)
                if m.kind == "histogram":
                    snap = child.snapshot()
                    for le, c in snap["buckets"]:
                        le_s = "+Inf" if le == "+Inf" else repr(le)
                        extra = (lbl[1:-1] + "," if lbl else "")
                        lines.append(
                            f'{name}_bucket{{{extra}le="{le_s}"}} {c}')
                    lines.append(f"{name}_sum{lbl} {snap['sum']}")
                    lines.append(f"{name}_count{lbl} {snap['count']}")
                else:
                    lines.append(f"{name}{lbl} {child.value}")
        return "\n".join(lines) + "\n"

    def to_dict(self) -> dict:
        out = {}
        for name, m in sorted(self._metrics.items()):
            series = []
            for labelvalues, child in sorted(m._series()):
                entry = {"labels": dict(zip(m.labelnames, labelvalues))}
                if m.kind == "histogram":
                    snap = child.snapshot()
                    entry["buckets"] = [[le, c] for le, c
                                        in snap["buckets"]]
                    entry["sum"] = snap["sum"]
                    entry["count"] = snap["count"]
                else:
                    entry["value"] = child.value
                series.append(entry)
            out[name] = {"type": m.kind, "help": m.help, "series": series}
        return out

    def to_json(self, indent=None) -> str:
        return json.dumps(self.to_dict(), indent=indent)


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default
