"""Serving watchdog: detect a stalled decode loop and dump state.

Ports ``paddle_tpu/serving/watchdog.py`` by copy (pure Python,
with the reference's metric names, span names, JSON fields and
routes).

Reference analog: the distributed CommTaskManager watchdog (and its
Paddle ancestor) — a side thread that notices work not progressing and
dumps diagnostics while the hang is live, instead of leaving only a
killed process to autopsy.

Detection rule: the engine's ``progress`` counter (incremented at the
end of every ``Engine.step``) has not moved for ``stall_seconds`` while
the scheduler still holds active slots.  Both reads are plain attribute
loads — the watchdog NEVER takes the worker lock, because the wedged
engine thread is usually the one holding it; a locking watchdog would
hang right alongside the thing it is meant to report.

On a trip the watchdog writes ``watchdog_<n>.json`` into
``FLAGS_metrics_dir`` (when set) containing the flight-recorder ring
(the scheduler/engine/block-manager events leading up to the stall),
every thread's current stack, and the last observed progress/active
values; bumps ``serving_watchdog_stalls_total``; and latches the
``serving_watchdog_stalled`` gauge until progress resumes.  One dump
per stall episode — a 60-second hang is one event, not sixty.

``check(now)`` is the whole detection step and takes an explicit
timestamp, so unit tests drive it with a fake clock in milliseconds;
``start()`` just runs ``check`` on a daemon-thread poll loop.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback

from .. import observability as _obs
from ..sanitizer import make_lock

__all__ = ["Watchdog"]

_M_STALLS = _obs.counter(
    "serving_watchdog_stalls_total",
    "decode-loop stalls detected (active slots, no step progress)")
_M_STALLED = _obs.gauge(
    "serving_watchdog_stalled",
    "1 while the decode loop is currently considered stalled")


class Watchdog:
    """Monitors one :class:`~paddle_tpu_torch.serving.engine.Engine`.

    ``stall_seconds`` <= 0 disables the poll loop entirely (``start``
    becomes a no-op); ``check`` still works for tests.
    """

    def __init__(self, engine, stall_seconds: float, *,
                 poll_interval: float | None = None, dump_dir=None,
                 clock=time.monotonic):
        self.engine = engine
        self.stall_seconds = float(stall_seconds)
        self.poll_interval = (poll_interval if poll_interval is not None
                              else max(self.stall_seconds / 4, 0.05))
        self._dump_dir = dump_dir
        self._clock = clock
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._lock = make_lock("Watchdog._lock")  # guards only watchdog state
        self._last_progress = -1
        self._last_change: float | None = None
        self._tripped = False           # latched for the current episode
        self.stalls = 0                 # python-side mirror of _M_STALLS
        self.last_dump_path: str | None = None
        # optional stall callback (EngineSupervisor.note_stall): invoked
        # once per episode, AFTER the dump, from the watchdog thread —
        # the callee must only flag state, never touch the engine
        self.on_stall = None

    # --------------------------------------------------------- detection
    def check(self, now: float | None = None) -> bool:
        """One detection step; returns True when THIS call detected a
        new stall episode (and dumped).  Lock-free against the engine:
        reads ``engine.progress`` and ``scheduler.active_count`` only.
        """
        now = self._clock() if now is None else now
        progress = self.engine.progress
        active = self.engine.scheduler.active_count
        with self._lock:
            if progress != self._last_progress or active == 0:
                # moving (or idle — an idle engine is not stalled)
                self._last_progress = progress
                self._last_change = now
                if self._tripped:
                    self._tripped = False
                    _M_STALLED.set(0)
                return False
            if self._last_change is None:
                self._last_change = now
                return False
            if now - self._last_change < self.stall_seconds:
                return False
            if self._tripped:
                return False            # one dump per episode
            self._tripped = True
            stalled_for = now - self._last_change
            self.stalls += 1
            n = self.stalls
        _M_STALLS.inc()
        _M_STALLED.set(1)
        _obs.flight("watchdog", "stall", progress=progress,
                    active=active, stalled_for=round(stalled_for, 3))
        self.last_dump_path = self._dump(progress, active, stalled_for, n)
        if self.on_stall is not None:
            try:
                self.on_stall()
            except Exception:       # a broken callback must not break
                traceback.print_exc()   # stall detection itself
        return True

    def state(self) -> dict:
        with self._lock:
            return {"enabled": self.stall_seconds > 0,
                    "stall_seconds": self.stall_seconds,
                    "stalled": self._tripped,
                    "stalls": self.stalls,
                    "last_progress": self._last_progress,
                    "last_dump": self.last_dump_path}

    # -------------------------------------------------------------- dump
    def _dump(self, progress, active, stalled_for, n) -> str | None:
        """Assemble the hang report.  Everything read here must be safe
        against a wedged engine: flight ring (own lock, never held by
        the engine), thread stacks (interpreter-level), and plain
        attribute reads — NOT ``engine.stats()``, which walks scheduler
        structures the stuck thread may be mutating."""
        try:
            # tracker takes only its own lock (+ registry read-back) —
            # safe against the wedged engine, same as the flight ring
            resources = _obs.resource_tracker().snapshot()
        except Exception:
            resources = None
        try:
            # who holds / waits on every sanitized lock right now; with
            # FLAGS_sanitizer off there are no instrumented locks and
            # this is an empty graph.  Reads only the sanitizer's own
            # bookkeeping lock — a wedged engine cannot block it.
            from ..sanitizer import lock_wait_graph
            lock_graph = lock_wait_graph()
        except Exception:
            lock_graph = None
        report = {
            "stalled_for_s": round(stalled_for, 3),
            "progress": progress,
            "active_slots": active,
            "threads": self._thread_stacks(),
            "flight": {"capacity": _obs.flight_recorder().capacity,
                       "events": _obs.flight_recorder().snapshot()},
            "resources": resources,
            "lock_wait_graph": lock_graph,
        }
        dir_ = self._dump_dir
        if dir_ is None:
            from ..flags import FLAGS
            dir_ = FLAGS.get("FLAGS_metrics_dir") or None
        if not dir_:
            return None
        try:
            os.makedirs(dir_, exist_ok=True)
            path = os.path.join(dir_, f"watchdog_{n}.json")
            with open(path, "w") as f:
                json.dump(report, f, indent=2)
            return path
        except OSError:
            return None

    @staticmethod
    def _thread_stacks() -> list[dict]:
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for ident, frame in frames.items():
            out.append({
                "thread_id": ident,
                "name": names.get(ident, "?"),
                "stack": [ln.rstrip() for ln in
                          traceback.format_stack(frame)],
            })
        return out

    # --------------------------------------------------------- poll loop
    def start(self):
        if self.stall_seconds <= 0 or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-watchdog")
        self._thread.start()

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def _run(self):
        while not self._stop.wait(self.poll_interval):
            try:
                self.check()
            except Exception:       # a broken watchdog must not crash
                traceback.print_exc()   # the server it watches
