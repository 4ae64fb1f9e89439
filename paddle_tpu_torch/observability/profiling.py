"""Continuous sampling profiler, phase-attributed (reference analog:
the host profiler + timer statistic tables of Paddle's profiler, grown
into an always-on "why is it slow" layer).

Ports ``paddle_tpu/observability/profiling.py`` by copy (pure Python,
with the reference's metric names, span names, JSON fields and
routes).

:class:`SamplingProfiler` walks ``sys._current_frames()`` on an
interval and aggregates per-thread stacks into a bounded table keyed by
``(phase, thread, stack)``.  *Phase* comes from a caller-supplied
``phases`` callable mapping thread idents to what that thread is doing
right now — the serving server wires it to the engine's
``current_phase`` attribute (published at the same seams that charge
``serving_step_phase_seconds_total``), so a hot stack splits into
prefill / prefill_chunk / decode / verify / host_sync / idle buckets
instead of one undifferentiated engine blob.

Outputs:

  * ``folded()`` — Brendan-Gregg folded stacks
    (``phase;thread;frame;... count``), flamegraph-ready;
  * ``chrome_events()`` — instant events on the same ``perf_counter``
    microsecond scale as :meth:`Tracer.chrome_events`, so samples merge
    into the existing chrome trace export;
  * ``snapshot()`` — the bounded JSON bundle DiagnosticCapture embeds.

The shape follows the watchdog/timeseries split exactly: ``sample(now)``
is one explicit step driven by a fake clock in unit tests (sub-second
suites); ``start_sampling()`` runs it on a daemon thread in production
and is a no-op for a non-positive interval.  With
``FLAGS_obs_profile_interval_s`` unset no profiler object is ever
constructed — the serving path's only cost is an attribute test, the
same zero-overhead contract as fault injection and the sanitizer
(pinned by the reference's perf-gate ``profiling`` scenario).
"""
from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from collections import deque

from ..sanitizer import make_lock
from .registry import default_registry

__all__ = ["SamplingProfiler", "active_profiler", "set_active_profiler"]

_M_SAMPLES = default_registry().counter(
    "obs_profile_samples_total",
    "sampling-profiler sweeps over sys._current_frames")
_M_DROPPED = default_registry().counter(
    "obs_profile_dropped_total",
    "per-thread stack observations dropped at the distinct-stack cap")


class SamplingProfiler:
    """Aggregating stack sampler over every live thread.

    ``phases`` (optional) is a zero-argument callable returning
    ``{thread_ident: phase_str}``; threads it does not name are
    attributed to phase ``"other"``.  ``max_stacks`` bounds the number
    of distinct ``(phase, thread, stack)`` keys kept (further distinct
    stacks count into ``dropped`` — fixed memory, like every other ring
    in observability/).  The sweeping thread never samples itself.
    """

    MAX_SECONDS = 60.0      # cap for on-demand /debug/profile windows

    def __init__(self, interval_s: float = 0.01, *,
                 phases=None, max_stacks: int = 2048,
                 max_depth: int = 64, ring_size: int = 4096,
                 clock=time.perf_counter):
        self.interval_s = float(interval_s)
        self._phases = phases
        self.max_stacks = int(max_stacks)
        self.max_depth = int(max_depth)
        self._clock = clock
        self._lock = make_lock("SamplingProfiler._lock")
        # (phase, thread_name, stack_tuple) -> observation count
        self._stacks: dict[tuple, int] = {}
        # bounded recent-sample ring for the chrome-trace merge:
        # (t, ident, thread_name, phase, leaf_frame)
        self._ring: deque = deque(maxlen=int(ring_size))
        self.samples = 0            # sweeps taken (python mirror)
        self.observations = 0       # per-thread stacks recorded
        self.dropped = 0            # observations lost to max_stacks
        self.started_at: float | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ---------------------------------------------------------- sampling
    def sample(self, now: float | None = None) -> int:
        """One sweep: walk every thread's current frame, attribute it
        to a phase, and bump the aggregate table.  Returns the number
        of stacks observed.  Explicit ``now`` keeps tests on a fake
        clock; production passes nothing."""
        now = self._clock() if now is None else float(now)
        try:
            phase_of = self._phases() if self._phases is not None else {}
        except Exception:
            phase_of = {}           # a broken source must not kill sweeps
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        me = threading.get_ident()
        seen = 0
        with self._lock:
            if self.started_at is None:
                self.started_at = now
            self.samples += 1
            for ident, frame in frames.items():
                if ident == me:
                    continue        # never profile the sampler itself
                stack = self._walk(frame)
                if not stack:
                    continue
                phase = str(phase_of.get(ident, "other"))
                key = (phase, names.get(ident, f"thread-{ident}"),
                       stack)
                n = self._stacks.get(key)
                if n is None and len(self._stacks) >= self.max_stacks:
                    self.dropped += 1
                    continue
                self._stacks[key] = (n or 0) + 1
                self.observations += 1
                seen += 1
                self._ring.append((now, ident, key[1], phase,
                                   stack[-1]))
        _M_SAMPLES.inc()
        return seen

    def _walk(self, frame) -> tuple:
        """Root-first tuple of ``file:function`` frames (function
        granularity, not line — line-level keys explode the distinct-
        stack table without helping a flamegraph)."""
        out = []
        while frame is not None and len(out) < self.max_depth:
            code = frame.f_code
            out.append(f"{os.path.basename(code.co_filename)}"
                       f":{code.co_name}")
            frame = frame.f_back
        out.reverse()
        return tuple(out)

    # ----------------------------------------------------------- outputs
    def folded(self, top: int | None = None) -> str:
        """Folded-stack text: ``phase;thread;frame;... count`` per
        line, heaviest first — feed to flamegraph.pl / speedscope."""
        with self._lock:
            items = sorted(self._stacks.items(),
                           key=lambda kv: -kv[1])
        if top is not None:
            items = items[:int(top)]
        lines = []
        for (phase, thread, stack), count in items:
            lines.append(";".join((phase, thread) + stack)
                         + f" {count}")
        return "\n".join(lines)

    def top_stacks(self, n: int = 50) -> list[dict]:
        with self._lock:
            items = sorted(self._stacks.items(),
                           key=lambda kv: -kv[1])[:int(n)]
        return [{"phase": phase, "thread": thread,
                 "stack": list(stack), "count": count}
                for (phase, thread, stack), count in items]

    def by_phase(self) -> dict[str, int]:
        """phase -> observation count (the attribution histogram)."""
        out: dict[str, int] = {}
        with self._lock:
            for (phase, _, _), count in self._stacks.items():
                out[phase] = out.get(phase, 0) + count
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def chrome_events(self, pid: int | None = None) -> list[dict]:
        """Recent samples as chrome-trace instant events, on the same
        perf_counter microsecond timebase as Tracer.chrome_events —
        concatenating the two lists yields one merged timeline."""
        pid = os.getpid() if pid is None else pid
        with self._lock:
            ring = list(self._ring)
        return [{"name": f"sample:{phase}", "ph": "i", "s": "t",
                 "ts": t * 1e6, "pid": pid, "tid": ident,
                 "cat": "profile",
                 "args": {"phase": phase, "leaf": leaf,
                          "thread": name}}
                for t, ident, name, phase, leaf in ring]

    def stats(self) -> dict:
        with self._lock:
            return {"interval_s": self.interval_s,
                    "samples": self.samples,
                    "observations": self.observations,
                    "distinct_stacks": len(self._stacks),
                    "dropped": self.dropped,
                    "started_at": self.started_at}

    def snapshot(self, top: int = 50) -> dict:
        """Bounded JSON bundle: what DiagnosticCapture embeds and
        ``observability.dump()`` writes as ``profile.json``."""
        return {"stats": self.stats(), "by_phase": self.by_phase(),
                "top_stacks": self.top_stacks(top)}

    def reset(self):
        with self._lock:
            self._stacks.clear()
            self._ring.clear()
            self.samples = self.observations = self.dropped = 0
            self.started_at = None

    # --------------------------------------------------------- poll loop
    def start_sampling(self,
                       interval_s: float | None = None
                       ) -> "SamplingProfiler":
        """Spawn the production sweep loop (daemon thread).  A non-
        positive interval is a no-op, mirroring the watchdog."""
        interval = (self.interval_s if interval_s is None
                    else float(interval_s))
        if interval <= 0 or self._thread is not None:
            return self
        self.interval_s = interval
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.sample()
                except Exception:   # a broken sweep must not crash
                    traceback.print_exc()   # the process it profiles

        self._thread = threading.Thread(
            target=loop, name="obs-profiler", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def profile_for(self, seconds: float,
                    clock=time.monotonic) -> "SamplingProfiler":
        """Blocking on-demand window (what ``GET /debug/profile?
        seconds=N`` runs in its handler thread): sweep every
        ``interval_s`` for ``seconds`` (capped at MAX_SECONDS), then
        return self for rendering."""
        seconds = min(max(float(seconds), 0.0), self.MAX_SECONDS)
        interval = self.interval_s if self.interval_s > 0 else 0.01
        end = clock() + seconds
        while clock() < end:
            self.sample()
            time.sleep(interval)
        return self


# process-wide continuous profiler (the serving server installs its own
# here when FLAGS_obs_profile_interval_s > 0, so observability.dump()
# can write profile.json next to the other artifacts)
_ACTIVE: SamplingProfiler | None = None


def active_profiler() -> SamplingProfiler | None:
    return _ACTIVE


def set_active_profiler(profiler: SamplingProfiler | None):
    global _ACTIVE
    _ACTIVE = profiler
    return profiler
