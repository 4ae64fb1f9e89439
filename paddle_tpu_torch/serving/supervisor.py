"""Engine supervisor: step-level failure containment + self-healing.

Ports ``paddle_tpu/serving/supervisor.py`` by copy (host-side).

Wraps :meth:`Engine.step` for the worker loop.  A step that raises (a
poisoned device call, non-finite device state, an injected
:class:`~.faults.InjectedFault`) — or a stall the watchdog declared —
triggers a **recovery**: the engine rebuilds its ModelRunner and
replays every in-flight request from its committed tokens
(:meth:`Engine.recover`), so one bad step costs one re-prefill pass,
not the process.  Recoveries are budgeted
(``FLAGS_serving_max_recoveries``); when the budget is exhausted the
supervisor **escalates to drain**: in-flight requests finish with
``finish_reason="error"``, admission stops, and the replica reports
itself unhealthy — the router's circuit breaker then routes around it.

Every event lands on ``serving_recovery_total{kind}``
(quarantine | rebuild | stall | drain), in the flight recorder, and as
``supervisor.recover`` spans in the trace ring (``/debug/trace``).

Threading: :meth:`step` runs on the single engine thread (the
EngineWorker loop); :meth:`note_stall` is called from the watchdog
thread and only flips a flag — recovery itself always happens on the
engine thread, preserving the engine's single-threaded contract.
"""
from __future__ import annotations

import time

from .. import observability as _obs
from ..flags import FLAGS
from ..sanitizer import make_lock

__all__ = ["EngineSupervisor"]

_M_RECOVERY = _obs.counter(
    "serving_recovery_total",
    "self-healing events: 'quarantine' = one request failed in place "
    "(finish_reason='error', batch kept running), 'rebuild' = runner "
    "rebuilt + in-flight requests replayed, 'stall' = rebuild declared "
    "by the watchdog, 'drain' = restart budget exhausted, escalated",
    ("kind",))


class EngineSupervisor:
    """Self-healing wrapper around one engine's step loop.

    ``max_recoveries`` bounds runner rebuilds per process (default
    ``FLAGS_serving_max_recoveries``); past it, failures escalate to
    drain instead of looping forever on a persistently broken device.
    """

    def __init__(self, engine, *, max_recoveries: int | None = None,
                 clock=time.monotonic):
        self.engine = engine
        if max_recoveries is None:
            max_recoveries = int(
                FLAGS.get("FLAGS_serving_max_recoveries") or 0)
        self.max_recoveries = int(max_recoveries)
        self._clock = clock
        # guards the counters below: step() mutates on the engine
        # thread, note_stall() on the watchdog thread, stats() on
        # handler threads
        self._lock = make_lock("EngineSupervisor._lock")
        self._stall_pending = False
        self.recoveries = 0          # rebuilds performed (mirror)
        self.escalated = False       # budget exhausted -> draining
        self.last_error: str | None = None

    # ------------------------------------------------------------ inputs
    def note_stall(self, *_args, **_kw):
        """Watchdog callback (``watchdog.on_stall``): request a recovery
        at the next :meth:`step`.  Never recovers inline — the watchdog
        thread must not touch engine state."""
        with self._lock:
            self._stall_pending = True

    # -------------------------------------------------------------- loop
    def step(self) -> bool:
        """One supervised engine iteration.  Returns whether work
        happened (recovery counts as work — the loop must not sleep
        through it)."""
        with self._lock:
            stalled = self._stall_pending
            self._stall_pending = False
        if stalled:
            self._recover("stall", "watchdog-declared stall")
            return True
        try:
            return self.engine.step()
        except Exception as e:
            self._recover("step_error", e)
            return True

    # ---------------------------------------------------------- recovery
    def _recover(self, kind: str, err):
        with self._lock:
            self.last_error = f"{kind}: {err}"
            exhausted = (self.escalated
                         or self.recoveries >= self.max_recoveries)
            if not exhausted:
                self.recoveries += 1
        if exhausted:
            self._escalate(err)
            return
        label = "stall" if kind == "stall" else "rebuild"
        _M_RECOVERY.labels(label).inc()
        _obs.flight("supervisor", "recover", kind=kind,
                    error=str(err)[:160],
                    budget_left=self.max_recoveries - self.recoveries)
        t0 = time.perf_counter()
        try:
            result = self.engine.recover()
        except Exception as e:
            # the rebuild itself failed: the device is gone for good —
            # escalate instead of crashing the worker loop
            self._escalate(e)
            return
        _obs.tracer().record_span(
            "supervisor.recover", t0, time.perf_counter(),
            attributes={"kind": kind, **result})
        log = getattr(self.engine, "requestlog", None)
        if log is not None:
            # forensics: count the sweep (per-request replay seconds
            # already landed in each timeline's recovery bucket)
            log.note_recovery(result)

    def _escalate(self, err):
        """Restart budget exhausted: stop admitting, fail what is in
        flight, and leave the replica up but draining — /healthz shows
        it, the router's breaker routes around it."""
        with self._lock:
            first = not self.escalated
            self.escalated = True
        if not first:
            return
        _M_RECOVERY.labels("drain").inc()
        now = self._clock()
        eng = self.engine
        eng.scheduler.drain()
        for slot, req in enumerate(eng.scheduler.slots):
            if req is not None:
                eng._quarantine(
                    slot, req,
                    f"recovery budget exhausted after "
                    f"{self.recoveries} rebuilds ({err})", now)
        _obs.flight("supervisor", "escalate", error=str(err)[:160],
                    recoveries=self.recoveries)

    # -------------------------------------------------------------- info
    def stats(self) -> dict:
        with self._lock:
            return {"recoveries": self.recoveries,
                    "max_recoveries": self.max_recoveries,
                    "escalated": self.escalated,
                    "stall_pending": self._stall_pending,
                    "last_error": self.last_error}
