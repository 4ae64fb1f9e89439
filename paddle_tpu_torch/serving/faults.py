"""Deterministic fault injection for the serving stack (chaos harness).

Ports ``paddle_tpu/serving/faults.py`` by copy (host-side, no device
code): the same plan grammar, firing rules and seeded RNG, so one spec
and one seed fire the same sequence in both packages.  The flight
recorder the reference also stamps comes with the observability slice.

A :class:`FaultPlan` holds a list of *entries*, each naming an
injection **site** (a string checked at an existing seam) plus a firing
rule — ``at=N`` (fire on the Nth matching check, deterministic) or
``p=P`` (fire with probability P per check, from a seeded RNG) — and
optional match/behavior params.  Every seam asks
``plan.check(site, **ctx)`` and gets back the entry's params dict when
the fault fires, ``None`` otherwise.

Zero overhead when off: holders
keep ``faults = None`` by default and every site guards with
``if self.faults is not None`` — no plan object, no call, no branch
beyond the None test.  Plans come from ``FLAGS_serving_fault_plan``
(env-settable) via :func:`fault_plan_from_flags`, or are built
programmatically in tests/benchmarks.

Known sites (the seam that checks each one):

===============  ====================================================
site             seam
===============  ====================================================
``step_raise``   engine decode: raise :class:`InjectedFault` before
                 dispatching the decode step (poisoned runner)
``nan_logits``   engine sampling: overwrite one slot's logits row with
                 NaN before token selection (params: ``slot``)
``page_alloc``   BlockManager page acquisition: report synthetic
                 device-OOM (allocation returns None → backpressure)
``slow_step``    engine decode: sleep ``seconds`` before the step
                 (watchdog/stall food; params: ``seconds``)
``conn_reset``   HTTP server (not ported yet): close the client
                 connection before any response bytes
``stream_hangup``  HTTP server (not ported yet): kill the socket
                 mid-SSE after ``sent`` streamed tokens
``spill_fail``   engine preemption: fail the device→host KV page copy
                 of a preempt-and-swap spill — the preemption must
                 abort cleanly (victim keeps its device pages and
                 slot; pool census leak stays 0; params: ``req``,
                 ``page`` match filters)
===============  ====================================================

Every firing increments ``serving_fault_injected_total{site}``, so
injected chaos shows in the metrics exactly like organic failures.
"""
from __future__ import annotations

import random

from .. import observability as _obs
from ..flags import FLAGS

__all__ = ["FaultPlan", "InjectedFault", "fault_plan_from_flags"]

_M_INJECTED = _obs.counter(
    "serving_fault_injected_total",
    "faults injected by the chaos harness, by site",
    ("site",))


class InjectedFault(RuntimeError):
    """Raised by seams that inject a failure by raising (step_raise).

    Deliberately a RuntimeError subclass: recovery paths must treat it
    exactly like an organic poisoned-step error — tests that catch
    InjectedFault specially would prove nothing about real faults.
    """


class _Entry:
    __slots__ = ("site", "at", "times", "p", "params", "match", "seen",
                 "fired")

    def __init__(self, site, at, times, p, params, match):
        self.site = site
        self.at = at          # fire on the at-th matching check (1-based)
        self.times = times    # consecutive firings once triggered
        self.p = p            # per-check probability (alternative to at)
        self.params = params  # behavior params handed to the seam
        self.match = match    # ctx keys that must equal to count a check
        self.seen = 0         # matching checks so far
        self.fired = 0        # firings so far


class FaultPlan:
    """Seedable, deterministic fault schedule.

    Not thread-safe by design: entry counters are simple ints mutated
    on the engine/server threads that own each site.  Probabilistic
    entries draw from one ``random.Random(seed)`` in check order, so a
    fixed seed plus a deterministic caller replays the same faults.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = random.Random(seed)
        self._entries: list[_Entry] = []
        self.injected: dict[str, int] = {}  # site -> count (test mirror)

    # -------------------------------------------------------- building
    def add(self, site: str, *, at: int | None = None,
            p: float | None = None, times: int = 1, **params):
        """Schedule a fault at ``site``.

        ``at=N`` fires on the Nth matching check; ``p=P`` fires each
        check with probability P (exactly one of the two).  ``times``
        extends an ``at`` firing to N..N+times-1.  Non-rule keyword args
        are params: keys the seam passes in ``check(**ctx)`` act as
        match filters (e.g. ``slot=1`` only counts checks for slot 1),
        the rest ride along in the returned dict (e.g. ``seconds=0.2``).
        """
        if (at is None) == (p is None):
            raise ValueError(
                f"fault {site!r}: exactly one of at= or p= required")
        if at is not None and at < 1:
            raise ValueError(f"fault {site!r}: at= is 1-based, got {at}")
        self._entries.append(_Entry(site, at, times, p, dict(params), None))
        return self

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse the ``FLAGS_serving_fault_plan`` grammar.

        Comma-separated entries: ``seed=S`` sets the plan seed,
        ``site@N[:k=v]*`` is ``add(site, at=N, ...)``,
        ``site~P[:k=v]*`` is ``add(site, p=P, ...)``.  Param values
        parse as int, then float, else string.
        """
        seed = 0
        pending = []
        for raw in spec.split(","):
            raw = raw.strip()
            if not raw:
                continue
            if raw.startswith("seed="):
                seed = int(raw[5:])
                continue
            head, *parts = raw.split(":")
            if "@" in head:
                site, _, n = head.partition("@")
                rule = {"at": int(n)}
            elif "~" in head:
                site, _, prob = head.partition("~")
                rule = {"p": float(prob)}
            else:
                raise ValueError(
                    f"fault spec entry {raw!r}: need site@N or site~P")
            params = {}
            for part in parts:
                k, _, v = part.partition("=")
                params[k] = _parse_value(v)
            pending.append((site, rule, params))
        plan = cls(seed=seed)
        for site, rule, params in pending:
            plan.add(site, **rule, **params)
        return plan

    # -------------------------------------------------------- checking
    def check(self, site: str, **ctx):
        """Ask whether a fault fires at ``site`` for this check.

        Returns the entry's params dict when one fires (seams read
        behavior params like ``seconds`` from it), else None.  Match
        params — entry params whose key appears in ``ctx`` — must equal
        the ctx value for the check to count against that entry.
        """
        for e in self._entries:
            if e.site != site:
                continue
            matched = True
            for k, v in e.params.items():
                if k in ctx and ctx[k] != v:
                    matched = False
                    break
            if not matched:
                continue
            e.seen += 1
            if e.p is not None:
                fire = self._rng.random() < e.p
            else:
                fire = e.at <= e.seen < e.at + e.times
            if fire:
                e.fired += 1
                self.injected[site] = self.injected.get(site, 0) + 1
                _M_INJECTED.labels(site).inc()
                return e.params
        return None

    def stats(self) -> dict:
        return {"seed": self.seed, "injected": dict(self.injected),
                "entries": [{"site": e.site, "at": e.at, "p": e.p,
                             "times": e.times, "seen": e.seen,
                             "fired": e.fired, "params": dict(e.params)}
                            for e in self._entries]}

    def __repr__(self):
        sites = ",".join(sorted({e.site for e in self._entries}))
        return f"FaultPlan(seed={self.seed}, sites=[{sites}])"


def _parse_value(v: str):
    for t in (int, float):
        try:
            return t(v)
        except ValueError:
            pass
    return v


def fault_plan_from_flags() -> FaultPlan | None:
    """Build a plan from ``FLAGS_serving_fault_plan``; None when the
    flag is empty — the holder then skips every site check entirely."""
    spec = FLAGS["FLAGS_serving_fault_plan"]
    return FaultPlan.from_spec(spec) if spec else None
