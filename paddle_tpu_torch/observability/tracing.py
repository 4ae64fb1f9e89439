"""Dapper-style request tracing + engine flight recorder.

Ports ``paddle_tpu/observability/tracing.py`` by copy: the same span
names, ``traceparent`` format, chrome-trace export and ring sizes, so a
trace of the port reads like one of the reference.

Two bounded, always-on event streams that answer the questions the
metrics registry cannot:

  * :class:`Tracer` — per-request spans with W3C ``traceparent``
    propagation.  "Where did THIS request spend its 900 ms" across
    client -> router -> replica -> engine: every layer starts spans
    under one 128-bit trace id, carried over HTTP in the standard
    ``traceparent: 00-<trace>-<span>-01`` header.  Finished spans land
    in a bounded per-process ring and export as chrome://tracing JSON
    on the same ``perf_counter`` clock the registry's sampled counter
    events use, so ``/debug/trace`` merges both onto one timeline.
  * :class:`FlightRecorder` — a fixed-size ring of recent
    scheduler/engine/BlockManager events (admit / evict / page-alloc /
    CoW / backpressure / host-sync).  When the serving watchdog
    detects a stalled decode loop it dumps this ring: the postmortem
    of what the engine was doing when it wedged (reference analog:
    CommTaskManager's hang dumps).

Both are pure stdlib, lock-bounded, and cheap enough to stay on in
production: recording a span is two ``perf_counter`` calls and one
deque append.
"""
from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import NamedTuple

from ..sanitizer import make_lock

__all__ = ["Span", "SpanContext", "Tracer", "FlightRecorder",
           "tracer", "flight_recorder", "format_traceparent",
           "parse_traceparent", "TRACEPARENT_HEADER"]

TRACEPARENT_HEADER = "traceparent"

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_torch_current_span", default=None)

# sentinel: "no parent passed — inherit the context-local span"
_INHERIT = object()


class SpanContext(NamedTuple):
    """The portable identity of a span: what crosses process/thread
    boundaries (and the wire, as a ``traceparent`` header)."""
    trace_id: str       # 32 lowercase hex chars
    span_id: str        # 16 lowercase hex chars


def format_traceparent(ctx: SpanContext) -> str:
    """W3C Trace Context header value (version 00, sampled)."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def parse_traceparent(header) -> SpanContext | None:
    """Parse a ``traceparent`` header; returns None on anything
    malformed (tracing must never fail a request)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(version, 16), int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id.lower(), span_id.lower())


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


class Span:
    """One named interval on the trace timeline.

    Created via :meth:`Tracer.start_span`; finish with :meth:`end` (or
    use as a context manager, which also makes it the context-local
    parent for spans started inside).  Timestamps are
    ``time.perf_counter()`` so spans line up with the native host
    tracer and sampled counter tracks.
    """

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "end_time", "attributes", "events", "pid", "tid",
                 "thread_name", "_tracer", "_token", "_ended")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: str | None, attributes: dict | None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.start = time.perf_counter()
        self.end_time: float | None = None
        self.attributes = dict(attributes) if attributes else {}
        self.events: list[dict] = []
        self.pid = os.getpid()
        t = threading.current_thread()
        self.tid = t.native_id if t.native_id is not None else t.ident
        self.thread_name = t.name
        self._token = None
        self._ended = False

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def duration(self) -> float | None:
        return None if self.end_time is None else self.end_time - self.start

    def set_attribute(self, key: str, value) -> "Span":
        self.attributes[key] = value
        return self

    def add_event(self, name: str, **attrs):
        """Point-in-time annotation inside the span (eviction, retry,
        park...) — exported as a chrome 'i' (instant) event."""
        self.events.append({"ts": time.perf_counter(), "name": name,
                            "attrs": attrs})

    def end(self, end_time: float | None = None):
        """Close the span and commit it to the tracer ring.  Idempotent
        — a double end() (finalize paths racing) records once."""
        if self._ended:
            return
        self._ended = True
        self.end_time = time.perf_counter() if end_time is None else end_time
        self._tracer._commit(self)

    def __enter__(self) -> "Span":
        self._token = _CURRENT.set(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        if exc is not None:
            self.attributes.setdefault("error", repr(exc))
        self.end()

    def to_dict(self) -> dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start": self.start, "end": self.end_time,
                "duration_s": self.duration, "pid": self.pid,
                "tid": self.tid, "thread": self.thread_name,
                "attributes": dict(self.attributes),
                "events": [dict(e) for e in self.events]}

    def __repr__(self):
        return (f"Span({self.name!r}, trace={self.trace_id[:8]}…, "
                f"dur={self.duration})")


class Tracer:
    """Span factory + bounded ring of finished spans.

    ``start_span`` with no explicit ``parent`` inherits the
    context-local span (set by using a span as a context manager) —
    that is how ``client.completion`` nests under ``router.request``
    without either layer knowing the other's internals.  Cross-thread
    parenting (HTTP handler -> engine worker) passes an explicit
    :class:`SpanContext` instead.
    """

    def __init__(self, max_spans: int | None = None):
        if max_spans is None:
            try:
                from ..flags import FLAGS
                max_spans = int(FLAGS.get("FLAGS_trace_buffer_size")
                                or 4096)
            except Exception:   # standalone use
                max_spans = 4096
        self.max_spans = int(max_spans)
        self._spans: deque[Span] = deque(maxlen=self.max_spans)
        self._lock = make_lock("Tracer._lock")
        self.spans_dropped = 0
        self.spans_recorded = 0

    # ------------------------------------------------------------- spans
    def start_span(self, name: str, parent=_INHERIT,
                   attributes: dict | None = None) -> Span:
        """Open a span.  ``parent`` may be a :class:`Span`, a
        :class:`SpanContext`, ``None`` (force a new root trace), or
        omitted (inherit the context-local current span)."""
        if parent is _INHERIT:
            parent = _CURRENT.get()
        if isinstance(parent, Span):
            parent = parent.context
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = _new_trace_id(), None
        return Span(self, name, trace_id, parent_id, attributes)

    def record_span(self, name: str, start: float, end: float, *,
                    parent=None, attributes: dict | None = None) -> Span:
        """Record an already-measured interval (RecordEvent capture,
        sampling sections) without the context-manager machinery."""
        start_f, end_f = float(start), float(end)    # before the span
        span = self.start_span(name, parent=parent, attributes=attributes)
        span.start = start_f
        span.end(end_f)
        return span

    def current_span(self) -> Span | None:
        return _CURRENT.get()

    def _commit(self, span: Span):
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.spans_dropped += 1
            self._spans.append(span)
            self.spans_recorded += 1

    # ----------------------------------------------------------- queries
    def spans(self, *, name: str | None = None,
              trace_id: str | None = None) -> list[Span]:
        """Snapshot of the finished-span ring, optionally filtered."""
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def reset(self):
        with self._lock:
            self._spans.clear()
            self.spans_dropped = 0
            self.spans_recorded = 0

    def __len__(self):
        with self._lock:
            return len(self._spans)

    # ------------------------------------------------------------ export
    def chrome_events(self, pid: int | None = None) -> list[dict]:
        """Finished spans as chrome-trace events: one "X" (complete)
        event per span on its real thread row, an "i" (instant) event
        per span event, plus "M" thread-name metadata so every
        EngineWorker / HTTP handler thread renders as its own named
        row instead of collapsing onto tid 0."""
        spans = self.spans()
        out: list[dict] = []
        threads_seen: dict[tuple, str] = {}
        for s in spans:
            p = pid if pid is not None else s.pid
            threads_seen.setdefault((p, s.tid), s.thread_name)
            args = {"trace_id": s.trace_id, "span_id": s.span_id}
            if s.parent_id:
                args["parent_id"] = s.parent_id
            args.update({k: v for k, v in s.attributes.items()})
            out.append({"name": s.name, "ph": "X", "pid": p,
                        "tid": s.tid, "ts": s.start * 1e6,
                        "dur": ((s.end_time or s.start) - s.start) * 1e6,
                        "cat": "tracing", "args": args})
            for ev in s.events:
                out.append({"name": f"{s.name}.{ev['name']}", "ph": "i",
                            "pid": p, "tid": s.tid,
                            "ts": ev["ts"] * 1e6, "s": "t",
                            "cat": "tracing",
                            "args": dict(ev["attrs"],
                                         trace_id=s.trace_id)})
        for (p, tid), tname in threads_seen.items():
            out.append({"name": "thread_name", "ph": "M", "pid": p,
                        "tid": tid, "args": {"name": tname}})
        return out

    def to_dict(self) -> dict:
        return {"spans": [s.to_dict() for s in self.spans()],
                "recorded": self.spans_recorded,
                "dropped": self.spans_dropped}


class FlightRecorder:
    """Fixed-size ring of recent engine events — the crash recorder.

    Every record is a dict with a monotonically increasing ``seq``, a
    ``perf_counter`` timestamp, a ``category`` (scheduler / engine /
    block_manager / server / watchdog), an ``event`` name, and
    free-form attributes.  ``snapshot()`` is what ``/debug/flight``
    serves and what the watchdog dumps on a stall.
    """

    def __init__(self, capacity: int | None = None):
        if capacity is None:
            try:
                from ..flags import FLAGS
                capacity = int(FLAGS.get("FLAGS_flight_recorder_size")
                               or 512)
            except Exception:
                capacity = 512
        self.capacity = int(capacity)
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._lock = make_lock("FlightRecorder._lock")
        self._seq = itertools.count()

    def record(self, category: str, event: str, **attrs):
        entry = {"seq": next(self._seq), "ts": time.perf_counter(),
                 "category": category, "event": event}
        if attrs:
            entry.update(attrs)
        with self._lock:
            self._ring.append(entry)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._ring]

    def clear(self):
        with self._lock:
            self._ring.clear()

    def __len__(self):
        with self._lock:
            return len(self._ring)

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump({"capacity": self.capacity,
                       "events": self.snapshot()}, f, indent=2)
        return path


_tracer = Tracer()
_flight = FlightRecorder()


def tracer() -> Tracer:
    return _tracer


def flight_recorder() -> FlightRecorder:
    return _flight
