"""Runtime lockset sanitizer: instrumented locks + Eraser-style races.

Ports ``paddle_tpu/sanitizer/lockset.py`` by copy.  A static lock pass
cannot see races that only manifest through aliasing, callbacks, or
data-dependent control flow, so this module instruments the real
execution:

* :class:`SanitizedLock` / :class:`SanitizedRLock` are drop-in
  ``threading`` lock replacements that maintain a per-thread held-lock
  stack, record the global acquisition-order graph, and report a
  runtime ABBA inversion (lock B taken under A somewhere, A under B
  somewhere else) the moment the second order is observed — no actual
  deadlock required.  They implement the ``_release_save`` /
  ``_acquire_restore`` / ``_is_owned`` protocol, so a plain
  ``threading.Condition(wrapped_lock)`` works unchanged.
* :class:`TrackedField` is an opt-in descriptor implementing the Eraser
  lockset algorithm per (instance, field): Virgin -> Exclusive(first
  thread) -> Shared/Shared-Modified, intersecting the candidate lockset
  with the locks held at every post-first-thread access; a write with
  an empty candidate set is reported once.
* :func:`lock_wait_graph` snapshots who holds / who waits on every live
  sanitized lock (the watchdog embeds it in hang dumps).

Violations become :class:`~.findings.Finding` records (rules
``sanitizer-lock-order`` / ``sanitizer-lockset``) attributed to the
acquire/access site, deduplicated by fingerprint, and retrievable via
:func:`findings` — the reference's schema and fingerprints (the port
keeps its own copy of the record and its text reporter).

Production code never constructs these classes directly: it calls the
:func:`make_lock` / :func:`make_rlock` / :func:`make_condition`
factories, which return plain ``threading`` primitives unless
``FLAGS_sanitizer`` is set — zero overhead when off.
"""
from __future__ import annotations

import os
import sys
import threading

from .findings import Finding, render_text

__all__ = ["RULES", "SanitizedLock", "SanitizedRLock", "TrackedField",
           "enabled", "make_lock", "make_rlock", "make_condition",
           "findings", "clear", "render", "lock_wait_graph"]

RULES = {
    "sanitizer-lock-order": "runtime lock acquisition inverts an "
                            "order observed earlier (ABBA)",
    "sanitizer-lockset": "shared field accessed by multiple threads "
                         "with an empty candidate lockset",
}

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
# frames to skip when attributing a violation to user code: this module
# and threading.py (Condition drives the wrapper through its protocol)
_SKIP_FILES = {os.path.abspath(__file__),
               os.path.abspath(threading.__file__)}

# module-internal mutexes are PLAIN locks — instrumenting the
# instrumentation would recurse
_graph_lock = threading.Lock()
_order: dict[tuple, tuple] = {}       # (outer, inner) -> first site
_order_reported: set = set()          # frozenset({a, b}) pairs
_threads: dict[int, list] = {}        # ident -> that thread's held list
_locks: list = []                     # weakrefs of live sanitized locks

_tls = threading.local()


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
        with _graph_lock:
            _threads[threading.get_ident()] = h
            if len(_threads) > 256:     # prune dead handler threads
                live = {t.ident for t in threading.enumerate()}
                for ident in [i for i in _threads if i not in live]:
                    del _threads[ident]
    return h


def _call_site() -> tuple:
    """(repo-relative path, line) of the nearest frame outside this
    module — the acquire/access site violations are attributed to."""
    f = sys._getframe(1)
    while f is not None and \
            os.path.abspath(f.f_code.co_filename) in _SKIP_FILES:
        f = f.f_back
    if f is None:                       # pragma: no cover - defensive
        return "<unknown>", 0
    path = os.path.abspath(f.f_code.co_filename)
    if path.startswith(_REPO_ROOT + os.sep):
        path = os.path.relpath(path, _REPO_ROOT)
    return path.replace(os.sep, "/"), f.f_lineno


# --------------------------------------------------------------- report
class _Reporter:
    def __init__(self):
        self._lock = threading.Lock()
        self._findings: list[Finding] = []
        self._fps: set = set()

    def report(self, rule, path, line, message, hint=""):
        f = Finding(rule, path, line, message, severity="error",
                    hint=hint)
        with self._lock:
            if f.fingerprint in self._fps:
                return
            self._fps.add(f.fingerprint)
            self._findings.append(f)
        if getattr(_tls, "reporting", False):
            return                      # no recursive flight events
        _tls.reporting = True
        try:        # best-effort breadcrumb in the flight ring
            from .. import observability as _obs
            _obs.flight("sanitizer", rule, path=path, line=line,
                        message=message)
        except Exception:
            pass
        finally:
            _tls.reporting = False

    def findings(self) -> list[Finding]:
        with self._lock:
            return list(self._findings)

    def clear(self):
        with self._lock:
            self._findings.clear()
            self._fps.clear()


_reporter = _Reporter()


def findings() -> list[Finding]:
    """All violations observed so far (deduplicated, stable order)."""
    return _reporter.findings()


def clear():
    """Drop recorded findings and the observed order graph (tests)."""
    _reporter.clear()
    with _graph_lock:
        _order.clear()
        _order_reported.clear()


def render() -> str:
    """Text report, rendered as the reference's analysis reporters do."""
    return render_text(findings())


# ---------------------------------------------------------------- locks
class SanitizedLock:
    """Instrumented ``threading.Lock`` (reentrant in the subclass).

    The wrapper never recursively acquires ``_inner`` — reentrancy is
    counted here — so ``_inner`` stays a plain Lock even for the RLock
    variant, and ``Condition`` integration releases it exactly once.
    """

    _reentrant = False

    def __init__(self, name: str | None = None):
        self._inner = threading.Lock()
        site = _call_site()
        self.name = name or f"{site[0]}:{site[1]}"
        self._owner: int | None = None
        self._owner_name = ""
        self._count = 0
        self._waiters: dict[int, str] = {}
        with _graph_lock:
            _locks.append(self)
            if len(_locks) > 4096:      # bound unbounded-creation use
                del _locks[:2048]

    # ------------------------------------------------------ acquisition
    def acquire(self, blocking=True, timeout=-1):
        ident = threading.get_ident()
        if self._reentrant and self._owner == ident:
            # tpu-lint: disable=lock-unlocked-write
            self._count += 1        # re-entry: we already own the lock
            return True
        held = _held()
        self._check_order(held)
        me = threading.current_thread().name
        with _graph_lock:
            self._waiters[ident] = me
        try:
            ok = self._inner.acquire(blocking, timeout)
        finally:
            with _graph_lock:
                self._waiters.pop(ident, None)
        if not ok:
            return False
        self._owner = ident
        self._owner_name = me
        self._count = 1
        held.append(self)
        return True

    def release(self):
        ident = threading.get_ident()
        owner = self._owner
        if owner is None:
            raise RuntimeError(f"release of unacquired {self.name}")
        if self._reentrant and owner != ident:
            raise RuntimeError(
                f"release of RLock {self.name} by non-owner thread")
        if self._reentrant and self._count > 1:
            # tpu-lint: disable=lock-unlocked-write
            self._count -= 1        # owner-only path: no race possible
            return
        self._drop()

    def _drop(self):
        # owner bookkeeping precedes the inner release on purpose: the
        # moment _inner is free another thread may acquire and set a
        # new owner, which must not be overwritten afterwards — the
        # inner lock itself orders these writes
        owner = self._owner
        # tpu-lint: disable=lock-unlocked-write
        self._owner = None
        # tpu-lint: disable=lock-unlocked-write
        self._count = 0
        with _graph_lock:           # plain Lock allows cross-thread
            held = _threads.get(owner)  # release: fix the OWNER's stack
        if held is not None:
            for i in range(len(held) - 1, -1, -1):
                if held[i] is self:
                    del held[i]
                    break
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    # ------------------------------------- threading.Condition protocol
    def _is_owned(self):
        return self._owner == threading.get_ident()

    def _release_save(self):
        ident = threading.get_ident()
        if self._owner != ident:
            raise RuntimeError(f"wait on {self.name} by non-owner")
        count = self._count
        self._drop()
        return count

    def _acquire_restore(self, count):
        self.acquire()
        # tpu-lint: disable=lock-unlocked-write
        self._count = count         # we own the lock again right here

    # ------------------------------------------------------ order graph
    def _check_order(self, held):
        if not held:
            return
        site = _call_site()
        to_report = []
        with _graph_lock:
            for outer in held:
                if outer is self or outer.name == self.name:
                    continue            # reentrant / same-site lock
                edge = (outer.name, self.name)
                if edge not in _order:
                    _order[edge] = site
                rev = _order.get((self.name, outer.name))
                if rev is None:
                    continue
                pair = frozenset(edge)
                if pair not in _order_reported:
                    _order_reported.add(pair)
                    to_report.append((outer.name, rev))
        # report OUTSIDE _graph_lock: the flight recorder takes its own
        # (possibly sanitized) locks
        for outer_name, rev in to_report:
            _reporter.report(
                "sanitizer-lock-order", site[0], site[1],
                f"lock {self.name} acquired while holding "
                f"{outer_name}, but the opposite order was observed "
                f"at {rev[0]}:{rev[1]} (runtime ABBA — a deadlock "
                "waiting for the right interleaving)",
                hint="pick one global order for these locks and "
                     "acquire them in that order everywhere")

    def __repr__(self):
        state = f"owner={self._owner_name!r}" if self._owner else "free"
        return f"<{type(self).__name__} {self.name} {state}>"


class SanitizedRLock(SanitizedLock):
    _reentrant = True


# ------------------------------------------------------- Eraser lockset
_VIRGIN, _EXCLUSIVE, _SHARED, _SHARED_MOD = range(4)


class _FieldMonitor:
    """Eraser state machine for one (instance, field)."""

    __slots__ = ("label", "state", "first", "lockset", "reported",
                 "_lock")

    def __init__(self, label):
        self.label = label
        self.state = _VIRGIN
        self.first = None
        self.lockset = None             # frozen candidate set, lazily
        self.reported = False
        self._lock = threading.Lock()   # plain: monitor internals

    def access(self, write: bool):
        ident = threading.get_ident()
        held = frozenset(lk.name for lk in _held())
        fire = None
        with self._lock:
            if self.state == _VIRGIN:
                self.state = _EXCLUSIVE
                self.first = ident
            elif self.state == _EXCLUSIVE and ident == self.first:
                pass                    # still single-threaded
            else:
                self.lockset = held if self.lockset is None \
                    else self.lockset & held
                if write or self.state == _SHARED_MOD:
                    self.state = _SHARED_MOD
                else:
                    self.state = _SHARED
                if self.state == _SHARED_MOD and not self.lockset \
                        and not self.reported:
                    self.reported = True
                    fire = _call_site()
        if fire is not None:
            _reporter.report(
                "sanitizer-lockset", fire[0], fire[1],
                f"field {self.label} is accessed by multiple threads "
                "with an empty candidate lockset (no single lock "
                "protects every access) — Eraser-style data race",
                hint="guard every access with one lock, or document "
                     "the hand-off that makes this safe")


class TrackedField:
    """Opt-in shared-field monitor (fixtures/tests — every access goes
    through a descriptor, so not for hot production paths).

    ``count = TrackedField(0)`` on a class body makes every read/write
    of ``obj.count`` feed the Eraser state machine with the locks the
    accessing thread currently holds (sanitized locks only)."""

    def __init__(self, default=None):
        self.default = default
        self.name = "?"
        self.owner_name = "?"

    def __set_name__(self, owner, name):
        self.name = name
        self.owner_name = owner.__name__

    def _monitor(self, obj) -> _FieldMonitor:
        key = f"_tracked_monitor_{self.name}"
        mon = obj.__dict__.get(key)
        if mon is None:     # setdefault: one monitor even under races
            mon = obj.__dict__.setdefault(
                key, _FieldMonitor(f"{self.owner_name}.{self.name}"))
        return mon

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        self._monitor(obj).access(write=False)
        return obj.__dict__.get(f"_tracked_value_{self.name}",
                                self.default)

    def __set__(self, obj, value):
        self._monitor(obj).access(write=True)
        obj.__dict__[f"_tracked_value_{self.name}"] = value


# ------------------------------------------------------ lock-wait graph
def lock_wait_graph() -> dict:
    """Snapshot of held/waited sanitized locks: per-thread held stacks,
    per-lock owner + waiters, waiter->owner edges, and any wait cycles
    (live deadlocks).  Safe to call from the watchdog while the engine
    is wedged — takes only the sanitizer's internal lock."""
    live = {t.ident: t.name for t in threading.enumerate()}
    with _graph_lock:
        locks_snap = [(lk.name, lk._owner, lk._owner_name,
                       dict(lk._waiters)) for lk in _locks]
        held_snap = {ident: [lk.name for lk in hl]
                     for ident, hl in _threads.items()
                     if ident in live and hl}
    locks_out, edges, waits_on = [], [], {}
    for name, owner, owner_name, waiters in locks_snap:
        if owner is None and not waiters:
            continue                    # idle lock: noise
        locks_out.append({"lock": name, "owner": owner,
                          "owner_name": owner_name or None,
                          "waiters": sorted(waiters.values())})
        for wident, wname in waiters.items():
            if owner is not None:
                edges.append({"waiter": wname, "owner": owner_name,
                              "lock": name})
                waits_on.setdefault(wident, set()).add(owner)
    cycles = _wait_cycles(waits_on, live)
    return {"threads": {live[i]: names for i, names in
                        held_snap.items() if i in live},
            "locks": locks_out, "wait_edges": edges,
            "deadlocks": cycles}


def _wait_cycles(waits_on, live) -> list:
    cycles, seen = [], set()
    for start in waits_on:
        path, node = [], start
        on_path = {}
        while node in waits_on and node not in on_path:
            on_path[node] = len(path)
            path.append(node)
            node = next(iter(waits_on[node]))
        if node in on_path:
            cyc = path[on_path[node]:]
            key = frozenset(cyc)
            if key not in seen:
                seen.add(key)
                cycles.append([live.get(i, str(i)) for i in cyc])
    return cycles


# ------------------------------------------------------------ factories
def enabled() -> bool:
    from ..flags import FLAGS
    return bool(FLAGS.get("FLAGS_sanitizer"))


def make_lock(name: str | None = None):
    """A mutex: plain ``threading.Lock`` normally, instrumented under
    ``FLAGS_sanitizer``.  ``name`` stabilizes the lock's identity in
    reports across instances (default: creation site)."""
    if not enabled():
        return threading.Lock()
    return SanitizedLock(name)


def make_rlock(name: str | None = None):
    if not enabled():
        return threading.RLock()
    return SanitizedRLock(name)


def make_condition(lock=None, name: str | None = None):
    """A ``threading.Condition`` over ``lock`` (or a fresh RLock from
    the factory).  A sanitized lock passed in keeps its wrapper — the
    Condition drives it through the ``_release_save`` protocol, so the
    held-lock stack stays consistent across ``wait()``."""
    if lock is None:
        lock = make_rlock(name)
    return threading.Condition(lock)
