"""Iteration-level priority scheduler (Orca-style continuous batching).

Ports ``paddle_tpu/serving/scheduler.py`` (host-side, numpy only).
Each engine iteration the scheduler (1) evicts finished / cancelled /
past-deadline sequences so their pages and slot free immediately,
(2) admits queued requests into free decode slots in (priority, FCFS)
order, reserving their whole page budget up front (all-or-nothing: an
admitted request can never exhaust the pool mid-decode), and
(3) reports backpressure when the head of the queue cannot be placed.
Within a priority class admission is strict FCFS — a head request that
does not fit blocks the queue rather than being overtaken (no
starvation of large requests).

When the head outranks a resident and cannot be placed, the scheduler
preempts: the lowest-priority, most-recently-admitted DECODE resident
is handed to the engine's ``_preempt`` callback (which spills its
exclusive KV pages to the BlockManager host tier and parks the slot)
and re-queued ahead of later arrivals of its class; on re-admission
the engine resumes it from prompt + generated-so-far with greedy
token-for-token parity.  All-default-priority traffic never preempts
and degenerates to the exact FCFS order this scheduler always had.
"""
from __future__ import annotations

import time
from collections import deque

from .. import observability as _obs
from .block_manager import BlockManager
from .request import Request, RequestState

__all__ = ["Scheduler"]

_M_QUEUE_DEPTH = _obs.gauge(
    "serving_queue_depth", "requests waiting for a decode slot")
_M_ACTIVE = _obs.gauge(
    "serving_active_slots", "decode slots occupied by live sequences")
_M_ADMITTED = _obs.counter(
    "serving_admissions_total", "requests admitted into decode slots")
_M_EVICTED = _obs.counter(
    "serving_evictions_total", "sequences evicted from decode slots",
    ("reason",))
_M_BACKPRESSURE = _obs.counter(
    "serving_backpressure_total",
    "scheduling passes where the queue head could not be placed",
    ("reason",))
_M_PREEMPTED = _obs.counter(
    "serving_preemptions_total",
    "residents evicted for a higher-priority request (KV spilled to "
    "host, request re-queued for resume)")


class Scheduler:
    def __init__(self, blocks: BlockManager, max_slots: int, *,
                 clock=None, preempt_enabled: bool = True):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.blocks = blocks
        self.max_slots = int(max_slots)
        self.slots: list[Request | None] = [None] * self.max_slots
        self.queue: deque[Request] = deque()
        self.draining = False
        self.preempt_enabled = bool(preempt_enabled)
        self._clock = clock or time.monotonic
        self._arrivals = 0         # FIFO stamps handed out by submit()
        self._finalize = None      # engine callback: (req, reason, now)
        self._on_evict = None      # engine callback: (slot,) — park it
        self._preempt = None       # engine callback: (slot,) -> bool
        # usage meter (observability.usage), wired by the engine when
        # metering is on; with FLAGS_serving_fair_share it biases
        # victim selection toward the heaviest-page-second tenant
        self.usage = None

    # ------------------------------------------------------------ intake
    @staticmethod
    def _key(req: Request):
        # total admission order: higher priority first, FCFS (by the
        # submit-time arrival stamp — NOT the Request id, which is
        # construction order) within a class; a preempted victim keeps
        # its original stamp and so re-queues ahead of later arrivals
        # of its class
        return (-req.priority, req.arrival_seq)

    def submit(self, req: Request):
        if req.arrival_seq is None:
            req.arrival_seq = self._arrivals
            self._arrivals += 1
        key = self._key(req)
        if not self.queue or key >= self._key(self.queue[-1]):
            self.queue.append(req)      # the common (all-FCFS) path
        else:
            items = list(self.queue)
            for i, q in enumerate(items):
                if self._key(q) > key:
                    items.insert(i, req)
                    break
            self.queue = deque(items)
        _M_QUEUE_DEPTH.set(len(self.queue))

    def drain(self):
        """Stop admitting; running sequences finish, queued ones wait
        (resume() re-opens admission)."""
        self.draining = True

    def resume(self):
        self.draining = False

    def has_work(self) -> bool:
        if any(r is not None for r in self.slots):
            return True
        if not self.queue:
            return False
        if not self.draining:
            return True
        # drain: queued requests wait for resume(), but cancelled or
        # past-deadline ones must still be dropped — deadline drops only
        # run inside schedule(), so reporting "no work" here would
        # starve them until resume() and blow their deadlines silently
        now = self._clock()
        return any(r.cancel_requested
                   or (r.deadline is not None and now > r.deadline)
                   for r in self.queue)

    @property
    def active_count(self) -> int:
        return sum(r is not None for r in self.slots)

    # ---------------------------------------------------------- one pass
    def schedule(self, now: float) -> list[tuple[int, Request]]:
        """One scheduling pass: evict dead sequences, expire deadlines,
        admit FCFS.  Returns the newly admitted ``(slot, request)``
        pairs — the engine prefills them before the next decode step."""
        # 1) iteration-level eviction of cancelled / expired residents
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if req.cancel_requested:
                self.evict(i, "cancelled", now)
            elif req.deadline is not None and now > req.deadline:
                req.cancel_requested = True
                self.evict(i, "deadline", now)

        # 2) drop queued requests that were cancelled or expired
        kept = deque()
        for req in self.queue:
            if req.cancel_requested:
                _obs.flight("scheduler", "queue_drop", req=req.id,
                            reason="cancelled")
                self._finish(req, "cancelled", now)
            elif req.deadline is not None and now > req.deadline:
                _obs.flight("scheduler", "queue_drop", req=req.id,
                            reason="deadline")
                self._finish(req, "deadline", now)
            else:
                kept.append(req)
        self.queue = kept

        # 3) (priority, FCFS) admission
        admitted: list[tuple[int, Request]] = []
        while self.queue and not self.draining:
            head = self.queue[0]
            free = [i for i, r in enumerate(self.slots) if r is None]
            if not free:
                if self._try_preempt(head, now):
                    continue
                _M_BACKPRESSURE.labels("slots").inc()
                _obs.flight("scheduler", "backpressure", reason="slots",
                            head=self.queue[0].id, queued=len(self.queue))
                break
            # prefix-cache-aware reservation: shared prefix pages are
            # refcounted, only the uncached suffix is charged against
            # the pool — with caching off this is the plain page count.
            # A resume (preempted victim) re-reserves for its effective
            # prompt (original + generated) and its remaining budget —
            # for a fresh request these are exactly prompt/max_new
            pages = self.blocks.allocate_seq(head.id, head.resume_tokens(),
                                             head.remaining_new_tokens,
                                             adapter=head.adapter)
            if pages is None:
                # pool exhausted: the head waits (and blocks the queue —
                # strict FCFS), surfaced as backpressure, not an error
                if self._try_preempt(head, now):
                    continue
                _M_BACKPRESSURE.labels("pages").inc()
                _obs.flight("scheduler", "backpressure", reason="pages",
                            head=self.queue[0].id, queued=len(self.queue))
                break
            self.queue.popleft()
            slot = free[0]
            self.slots[slot] = head
            head.state = RequestState.PREFILL
            head.admitted_at = now
            _M_ADMITTED.inc()
            _obs.flight("scheduler", "admit", req=head.id, slot=slot,
                        pages=len(pages), queued=len(self.queue))
            if head.root_span is not None:
                head.root_span.add_event("scheduler.admit", slot=slot,
                                         pages=len(pages))
            admitted.append((slot, head))

        _M_QUEUE_DEPTH.set(len(self.queue))
        _M_ACTIVE.set(self.active_count)
        # fragmentation against the queue head's demand: idle pages the
        # blocked request cannot use (0.0 when nothing waits)
        head_need = None
        if self.queue:
            head = self.queue[0]
            head_need = self.blocks.pages_needed(
                head.resume_tokens().size, head.remaining_new_tokens)
        self.blocks.record_fragmentation(head_need)
        return admitted

    # -------------------------------------------------------- preemption
    def _try_preempt(self, head: Request, now: float) -> bool:
        """Make room for ``head`` by preempting a lower-priority DECODE
        resident: lowest class first, most-recently-admitted within the
        class (it has the least sunk work).  With
        ``FLAGS_serving_fair_share`` set and a usage meter wired, the
        heaviest-page-second tenant's residents are preferred within
        the lowest class — the tenant that consumed the most KV
        residency pays for the displacement first.  The engine callback
        spills the victim's exclusive pages to host RAM and parks the
        slot; a False return (spill failed / no engine) leaves the
        victim untouched.  On success the victim is re-queued for
        resume."""
        if not self.preempt_enabled or self._preempt is None:
            return False
        victims = [(i, r) for i, r in enumerate(self.slots)
                   if r is not None and r.state == RequestState.DECODE
                   and r.priority < head.priority]
        if not victims:
            return False
        heavy = None
        if self.usage is not None:
            from ..flags import FLAGS
            if FLAGS.get("FLAGS_serving_fair_share"):
                heavy = self.usage.heaviest_tenant()
        slot, victim = min(
            victims, key=lambda ir: (
                ir[1].priority,
                0 if getattr(ir[1], "tenant", None) == heavy else 1,
                -(ir[1].admitted_at or 0.0)))
        if not self._preempt(slot):
            return False
        self.slots[slot] = None
        victim.state = RequestState.QUEUED
        victim.admitted_at = None
        victim.preemptions += 1
        _M_PREEMPTED.inc()
        _obs.flight("scheduler", "preempt", req=victim.id, slot=slot,
                    by=head.id, generated=victim.num_generated)
        if victim.root_span is not None:
            victim.root_span.add_event("scheduler.preempt", slot=slot,
                                       by=head.id)
        self.submit(victim)
        _M_ACTIVE.set(self.active_count)
        return True

    # ---------------------------------------------------------- eviction
    def evict(self, slot: int, reason: str, now: float):
        """Free a slot and its pages; finalizes the request unless it
        already finished (reason 'finished' keeps its finish_reason)."""
        req = self.slots[slot]
        if req is None:
            return
        self.slots[slot] = None
        self.blocks.free_seq(req.id)
        if self._on_evict is not None:
            self._on_evict(slot)
        _M_EVICTED.labels(reason).inc()
        if req.timeline is not None and reason != "finished":
            # non-finish evictions (cancel/deadline/error) mark the
            # waterfall — the reason a timeline ends mid-lifecycle
            req.timeline.mark("evict", now, slot=slot, reason=reason)
        _obs.flight("scheduler", "evict", req=req.id, slot=slot,
                    reason=reason, generated=req.num_generated)
        if req.root_span is not None:
            req.root_span.add_event("scheduler.evict", slot=slot,
                                    reason=reason)
        _M_ACTIVE.set(self.active_count)
        if not req.is_finished():
            self._finish(req, reason, now)

    def _finish(self, req: Request, reason: str, now: float):
        if self._finalize is not None:
            self._finalize(req, reason, now)
        else:                       # standalone scheduler (tests)
            req.finish_reason = reason
            req.state = RequestState.CANCELLED \
                if reason in ("cancelled", "deadline") else RequestState.DONE
            req.finished_at = now
