"""Per-request SLO tracking for the serving engine.

Ports ``paddle_tpu/serving/slo.py`` by copy (pure Python,
with the reference's metric names, span names, JSON fields and
routes).

Every finished request is checked against configurable latency targets
— TTFT (arrival -> first token), TPOT (average inter-token latency),
and E2E (arrival -> completion) — and the verdicts feed:

  * ``serving_slo_requests_total{dimension, result}`` — good /
    violation counters per dimension (the raw SLI);
  * ``serving_slo_burn_rate{dimension}`` — violation rate over the
    last ``window`` finished requests divided by the error budget
    ``1 - objective``.  Burn rate 1.0 means the service is consuming
    its budget exactly as fast as the objective allows; > 1.0 means
    an alert-worthy burn (the multiwindow-burn-rate alerting input).

Targets come from an explicit :class:`SLOConfig` or from flags
(``FLAGS_serving_slo_ttft_ms`` / ``_tpot_ms`` / ``_e2e_ms``, with
``FLAGS_serving_slo_objective``); a dimension with target 0 is not
checked.  A request that finishes without ever producing a first token
(cancelled / deadline-evicted while queued) counts as a TTFT and E2E
violation when those targets are set — it never met any latency bar.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from .. import observability as _obs
from ..sanitizer import make_lock

__all__ = ["SLOConfig", "SLOTracker"]

_M_SLO = _obs.counter(
    "serving_slo_requests_total",
    "per-request SLO verdicts by dimension (ttft/tpot/e2e) and result "
    "(good/violation)", ("dimension", "result"))
_M_BURN = _obs.gauge(
    "serving_slo_burn_rate",
    "violation rate over the recent request window / error budget "
    "(1-objective); sustained > 1.0 burns the SLO", ("dimension",))


@dataclass(frozen=True)
class SLOConfig:
    """Latency targets in seconds; 0 disables a dimension."""
    ttft_s: float = 0.0
    tpot_s: float = 0.0
    e2e_s: float = 0.0
    objective: float = 0.99

    @classmethod
    def from_flags(cls) -> "SLOConfig":
        from ..flags import FLAGS
        return cls(
            ttft_s=float(FLAGS.get("FLAGS_serving_slo_ttft_ms") or 0.0)
            / 1e3,
            tpot_s=float(FLAGS.get("FLAGS_serving_slo_tpot_ms") or 0.0)
            / 1e3,
            e2e_s=float(FLAGS.get("FLAGS_serving_slo_e2e_ms") or 0.0)
            / 1e3,
            objective=float(FLAGS.get("FLAGS_serving_slo_objective")
                            or 0.99))

    @property
    def enabled(self) -> bool:
        return self.ttft_s > 0 or self.tpot_s > 0 or self.e2e_s > 0


class SLOTracker:
    """Sliding-window SLO accounting.  ``observe(req, now)`` is called
    once per finished request from ``Engine._finalize``."""

    def __init__(self, config: SLOConfig, window: int = 256):
        if not 0.0 < config.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {config.objective}")
        self.config = config
        self.window = int(window)
        self._lock = make_lock("SLOTracker._lock")
        self._recent: dict[str, deque] = {
            d: deque(maxlen=self.window) for d in ("ttft", "tpot", "e2e")}
        # python-side mirrors (stats()/tests without registry spelunking)
        self.good: dict[str, int] = {d: 0 for d in self._recent}
        self.violations: dict[str, int] = {d: 0 for d in self._recent}
        # optional per-verdict mirror, called as (req, dimension, ok)
        # alongside each _check — the usage meter wires it to attribute
        # SLO verdicts to the request's tenant (None = off)
        self.verdict_hook = None
        # optional violation-exemplar hook, called as (req, dimension,
        # ok, measured_seconds) — the request log wires it to snapshot
        # the violating request's timeline + attribution, carrying its
        # trace id so /debug/trace and /debug/exemplars join on one id
        # (None = off; measured is None when no first token landed)
        self.exemplar_hook = None

    def observe(self, req, now: float):
        cfg = self.config
        ttft = (None if req.first_token_at is None
                else req.first_token_at - req.arrival_time)
        tpot = None
        if req.num_generated > 1 and req.first_token_at is not None \
                and req.last_token_at is not None:
            tpot = ((req.last_token_at - req.first_token_at)
                    / (req.num_generated - 1))
        e2e = now - req.arrival_time
        if cfg.ttft_s > 0:
            # no first token at all = the request never met ANY bar
            self._verdict(req, "ttft",
                          ttft is not None and ttft <= cfg.ttft_s,
                          ttft)
        if cfg.tpot_s > 0 and tpot is not None:
            self._verdict(req, "tpot", tpot <= cfg.tpot_s, tpot)
        if cfg.e2e_s > 0:
            self._verdict(req, "e2e", e2e <= cfg.e2e_s, e2e)

    def _verdict(self, req, dim: str, ok: bool,
                 value: float | None = None):
        self._check(dim, ok)
        if self.verdict_hook is not None:
            self.verdict_hook(req, dim, ok)
        if self.exemplar_hook is not None:
            self.exemplar_hook(req, dim, ok, value)

    def _check(self, dim: str, ok: bool):
        budget = max(1.0 - self.config.objective, 1e-9)
        with self._lock:
            win = self._recent[dim]
            win.append(0 if ok else 1)
            if ok:
                self.good[dim] += 1
            else:
                self.violations[dim] += 1
            rate = sum(win) / len(win)
        _M_SLO.labels(dim, "good" if ok else "violation").inc()
        _M_BURN.labels(dim).set(rate / budget)

    def burn_rate(self, dim: str) -> float:
        budget = max(1.0 - self.config.objective, 1e-9)
        with self._lock:
            win = self._recent[dim]
            rate = (sum(win) / len(win)) if win else 0.0
        return rate / budget

    def burn_rates(self) -> dict:
        """Per-dimension burn rate for every configured dimension —
        the fleet summary block /debug/fleet publishes per replica."""
        cfg = self.config
        return {d: self.burn_rate(d)
                for d, t in (("ttft", cfg.ttft_s), ("tpot", cfg.tpot_s),
                             ("e2e", cfg.e2e_s)) if t > 0}

    def max_burn_rate(self) -> float:
        """Worst burn rate across the configured dimensions — the load-
        shedding signal (``FLAGS_serving_shed_burn_rate``).  0.0 when no
        dimension has a target or nothing finished yet."""
        cfg = self.config
        dims = [d for d, t in (("ttft", cfg.ttft_s), ("tpot", cfg.tpot_s),
                               ("e2e", cfg.e2e_s)) if t > 0]
        if not dims:
            return 0.0
        return max(self.burn_rate(d) for d in dims)

    def stats(self) -> dict:
        burn = {d: round(r, 6) for d, r in self.burn_rates().items()}
        with self._lock:
            return {"targets": {"ttft_s": self.config.ttft_s,
                                "tpot_s": self.config.tpot_s,
                                "e2e_s": self.config.e2e_s,
                                "objective": self.config.objective},
                    "good": dict(self.good),
                    "violations": dict(self.violations),
                    "burn_rates": burn}
