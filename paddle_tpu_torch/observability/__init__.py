"""Runtime telemetry for the port (ports ``paddle_tpu/observability``).

The metric names, span names and dump files are the reference's, so a
scrape, a trace or a dump of the port reads like one of the JAX
package.  One process-wide :class:`MetricsRegistry` owns every runtime
metric; beside it live the span tracer and flight recorder
(``tracing.py``), the resource tracker (``resources.py``), the
time-series store and alert rules (``timeseries.py``), the sampling
profiler (``profiling.py``), alert-triggered capture (``capture.py``),
the usage meter (``usage.py``) and the request log (``requestlog.py``).

Export: ``dump()`` writes Prometheus text + JSON (+ the retrace log,
the span ring, the flight ring and the resource snapshot) into
``FLAGS_metrics_dir``, and the side-files of whichever subsystems are
live (``usage.json``, ``quant.json``, ``lora.json``, ...).  The port
has no eager dispatch cache, so its :data:`retrace_log` stays empty
unless something records into it.
"""
from __future__ import annotations

import json
import os
import time
import weakref

from ..sanitizer import make_lock

from .registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, bucket_quantiles,
    default_registry, merge_series_buckets, quantile_from_buckets)
from .tracing import (  # noqa: F401
    FlightRecorder, Span, SpanContext, Tracer, flight_recorder,
    format_traceparent, parse_traceparent, tracer)
from .timeseries import (  # noqa: F401
    AlertRule, Series, TimeSeriesStore, default_rules, metric_value,
    serving_sources)
from .profiling import (  # noqa: F401
    SamplingProfiler, active_profiler, set_active_profiler)
from .capture import (  # noqa: F401
    DiagnosticCapture, active_capture, set_active_capture)
from .usage import (  # noqa: F401
    TenantTable, UsageMeter, active_usage, merge_usage, request_ledger,
    set_active_usage)
from .requestlog import (  # noqa: F401
    ExemplarStore, RequestLog, RequestTimeline, active_requestlog,
    merge_exemplars, set_active_requestlog)

__all__ = ["AlertRule", "Counter", "DiagnosticCapture",
           "ExemplarStore", "FlightRecorder", "Gauge",
           "Histogram", "MetricsRegistry", "RequestLog",
           "RequestTimeline", "ResourceTracker",
           "SamplingProfiler", "Series",
           "Span", "SpanContext", "TenantTable", "TimeSeriesStore",
           "Tracer", "UsageMeter",
           "active_capture", "active_profiler", "active_quant",
           "active_requestlog", "active_usage",
           "bucket_quantiles", "merge_series_buckets",
           "quantile_from_buckets",
           "default_registry", "default_rules", "counter", "gauge",
           "histogram", "metric_value", "retrace_log", "RetraceLog",
           "dump", "reset", "flight", "enable_event_sampling",
           "chrome_counter_events", "flight_recorder",
           "format_traceparent", "parse_traceparent",
           "merge_exemplars", "merge_usage", "request_ledger",
           "resource_tracker", "serving_sources",
           "active_lora", "set_active_lora", "release_providers",
           "set_active_capture", "set_active_profiler",
           "set_active_quant", "set_active_requestlog",
           "set_active_usage", "tracer"]

# the quantized-serving and multi-LoRA providers: dump() writes
# quant.json from the first's quant_snapshot() and lora.json from the
# second's lora_snapshot() (last engine built wins, like the profiler /
# usage holders).  The slots hold weak references: an engine the caller
# dropped, closed or not, is freed with its weights, and its slot reads
# None; close() and a worker's stop() clear theirs at once.
_active_quant = None
_active_lora = None


def _weak(provider):
    return None if provider is None else weakref.ref(provider)


def _deref(slot):
    return None if slot is None else slot()


def set_active_quant(provider):
    global _active_quant
    _active_quant = _weak(provider)


def active_quant():
    return _deref(_active_quant)


def set_active_lora(provider):
    global _active_lora
    _active_lora = _weak(provider)


def active_lora():
    return _deref(_active_lora)


def release_providers(*owners):
    """Clear the quant.json and lora.json slots that hold one of
    ``owners`` (a closed engine, a stopped worker): a slot holding
    another engine stays as it is."""
    global _active_quant, _active_lora
    if any(active_quant() is o for o in owners):
        _active_quant = None
    if any(active_lora() is o for o in owners):
        _active_lora = None


def counter(name, help_="", labelnames=()):
    return default_registry().counter(name, help_, labelnames)


def gauge(name, help_="", labelnames=()):
    return default_registry().gauge(name, help_, labelnames)


def histogram(name, help_="", labelnames=(), buckets=None):
    from .registry import DEFAULT_BUCKETS
    return default_registry().histogram(
        name, help_, labelnames, buckets=buckets or DEFAULT_BUCKETS)


def enable_event_sampling(on=True):
    default_registry().enable_event_sampling(on)


def chrome_counter_events(pid=None):
    return default_registry().chrome_counter_events(pid)


def flight(category, event, **attrs):
    """Record one engine flight-recorder event (bounded ring; see
    tracing.FlightRecorder).  Hot-path safe: one deque append."""
    flight_recorder().record(category, event, **attrs)


class RetraceLog:
    """Record of every eager-cache miss that built a new executable:
    op name + abstract input signature (shapes/dtypes/statics — never
    values).  The analog of jax's ``jax_log_compiles`` made queryable:
    a retrace storm (same op, ever-changing signatures) shows up as one
    op with many entries instead of a silently slow step."""

    MAX_ENTRIES = 10_000

    def __init__(self):
        self._lock = make_lock("RetraceLog._lock")
        self._entries: dict[tuple, dict] = {}
        self._dropped = 0

    def record(self, op: str, signature: str):
        key = (op, signature)
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                e["count"] += 1
                e["last_time"] = time.perf_counter()
                return
            if len(self._entries) >= self.MAX_ENTRIES:
                self._dropped += 1
                return
            self._entries[key] = {
                "op": op, "signature": signature, "count": 1,
                "first_time": time.perf_counter(),
                "last_time": time.perf_counter()}

    def entries(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._entries.values()]

    def by_op(self) -> dict[str, int]:
        """op -> number of distinct signatures (retrace-storm ranking)."""
        out: dict[str, int] = {}
        for e in self.entries():
            out[e["op"]] = out.get(e["op"], 0) + 1
        return out

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._dropped = 0

    def __len__(self):
        with self._lock:
            return len(self._entries)


retrace_log = RetraceLog()


def reset():
    """Drop all metrics + retrace entries + spans + flight events +
    resource accounting (tests / between runs)."""
    default_registry().reset()
    retrace_log.clear()
    tracer().reset()
    flight_recorder().clear()
    resource_tracker().reset()
    set_active_profiler(None)
    set_active_capture(None)
    set_active_usage(None)
    set_active_quant(None)
    set_active_lora(None)
    set_active_requestlog(None)


def dump(dir_=None) -> str | None:
    """Write the registry as ``metrics.prom`` + ``metrics.json``, the
    retrace log as ``retraces.json``, the span ring as ``trace.json``
    (chrome://tracing-loadable, with a parallel ``spans`` list for
    programmatic consumers), the flight-recorder ring as
    ``flight.json``, and the resource tracker's snapshot as
    ``resources.json`` into ``dir_`` (default: ``FLAGS_metrics_dir``).
    When a continuous profiler / diagnostic capture / usage meter /
    quantized engine / LoRA-serving engine / request log is active,
    adds ``profile.json`` / ``captures.json`` / ``usage.json`` /
    ``quant.json`` / ``lora.json`` / ``exemplars.json``.  Returns the
    directory, or None when no directory is configured."""
    if dir_ is None:
        from ..flags import FLAGS
        dir_ = FLAGS.get("FLAGS_metrics_dir") or None
    if not dir_:
        return None
    os.makedirs(dir_, exist_ok=True)
    reg = default_registry()
    with open(os.path.join(dir_, "metrics.prom"), "w") as f:
        f.write(reg.to_prometheus())
    with open(os.path.join(dir_, "metrics.json"), "w") as f:
        f.write(reg.to_json(indent=2))
    with open(os.path.join(dir_, "retraces.json"), "w") as f:
        json.dump({"entries": retrace_log.entries(),
                   "by_op": retrace_log.by_op()}, f, indent=2)
    tr = tracer()
    with open(os.path.join(dir_, "trace.json"), "w") as f:
        json.dump({"traceEvents": (tr.chrome_events()
                                   + chrome_counter_events()),
                   "spans": [s.to_dict() for s in tr.spans()],
                   "recorded": tr.spans_recorded,
                   "dropped": tr.spans_dropped}, f, indent=2)
    fr = flight_recorder()
    with open(os.path.join(dir_, "flight.json"), "w") as f:
        json.dump({"capacity": fr.capacity, "events": fr.snapshot()},
                  f, indent=2)
    with open(os.path.join(dir_, "resources.json"), "w") as f:
        json.dump(resource_tracker().snapshot(), f, indent=2)
    # side-files written only when their subsystems are live, so a
    # dump without them keeps the base file set
    prof = active_profiler()
    if prof is not None:
        with open(os.path.join(dir_, "profile.json"), "w") as f:
            json.dump(prof.snapshot(), f, indent=2)
    cap = active_capture()
    if cap is not None:
        with open(os.path.join(dir_, "captures.json"), "w") as f:
            json.dump(cap.index(), f, indent=2)
    meter = active_usage()
    if meter is not None:
        with open(os.path.join(dir_, "usage.json"), "w") as f:
            json.dump(meter.snapshot(), f, indent=2)
    quant = active_quant()
    if quant is not None:
        with open(os.path.join(dir_, "quant.json"), "w") as f:
            json.dump(quant.quant_snapshot(), f, indent=2)
    lora = active_lora()
    if lora is not None:
        with open(os.path.join(dir_, "lora.json"), "w") as f:
            json.dump(lora.lora_snapshot(), f, indent=2)
    rlog = active_requestlog()
    if rlog is not None:
        with open(os.path.join(dir_, "exemplars.json"), "w") as f:
            json.dump(rlog.snapshot(), f, indent=2)
    return dir_


# imported last: resources.py reads `retrace_log` and the registry the
# lines above set up
from .resources import ResourceTracker, resource_tracker  # noqa: E402,F401
