"""Request lifecycle for the continuous-batching engine.

Ports ``paddle_tpu/serving/request.py`` (host-side, numpy only).  A
request moves QUEUED -> PREFILL -> DECODE -> DONE (or CANCELLED from
any live state).  Tokens stream out as they are sampled: consumers can
poll :attr:`output_tokens`, register an ``on_token`` callback, or pull
from :meth:`stream` (which drives the attached engine when it runs dry,
so a plain ``for tok in req.stream():`` serves the request end to end).
With ``sync_interval > 1`` tokens surface in bursts of up to
``sync_interval`` — the host only observes the device token ring at
sync points, trading streaming latency for fewer device round-trips.
"""
from __future__ import annotations

import enum
import itertools
import time

import numpy as np

from ..models.generation import GenerationConfig
from ..sanitizer import make_lock

__all__ = ["Request", "RequestState", "GenerationConfig"]

_ids = itertools.count()
_ids_lock = make_lock("request._ids_lock")


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    CANCELLED = "cancelled"


class Request:
    """One generation request.

    ``gen`` is a per-request :class:`GenerationConfig` — each request
    chooses its own ``max_new_tokens`` / ``eos_token_id`` / sampling
    knobs; the engine batches them anyway (iteration-level scheduling:
    the batch composition is a per-step decision, not a compile-time
    one)."""

    def __init__(self, prompt, gen: GenerationConfig | None = None, *,
                 deadline: float | None = None, on_token=None,
                 arrival_time: float | None = None, priority: int = 0,
                 tenant: str | None = None, adapter: str | None = None):
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        gen = gen or GenerationConfig()
        if gen.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        with _ids_lock:
            self.id = next(_ids)
        self.prompt = prompt
        self.gen = gen
        self.deadline = deadline          # absolute, on the engine clock
        # scheduling class: higher admits first and may preempt lower
        # residents (server maps low/normal/high -> -1/0/1; any int works)
        self.priority = int(priority)
        # times this request was preempted (evicted for a higher class
        # and re-queued for resume)
        self.preemptions = 0
        self.on_token = on_token
        self.state = RequestState.QUEUED
        self.cancel_requested = False
        # length|eos|cancelled|deadline|error
        self.finish_reason: str | None = None
        # human-readable failure detail when finish_reason == "error"
        # (quarantined by the engine: non-finite logits, replay failure,
        # recovery budget exhausted, ...)
        self.error: str | None = None
        self.output_tokens: list[int] = []
        # prompt tokens served from the engine's prefix cache at
        # admission (0 with caching off); set by Engine._prefill
        self.num_cached_tokens = 0

        # ------------------------------------------------ cost ledger
        # Per-request cost attribution (observability.usage): plain
        # counters the engine bumps unconditionally at the seams that
        # already update the global mirrors, so summed ledgers equal
        # the global counters exactly on deterministic workloads.
        # Billing tenant (HTTP X-Tenant header / body field / submit
        # kwarg; "" and None canonicalize to "anon").
        self.tenant = str(tenant).strip() if tenant else "anon"
        # LoRA adapter id (HTTP X-Adapter header / body field / submit
        # kwarg; None = dense base model).  Resolved to a bank row by
        # the engine's AdapterStore at submit; the row is re-acquired on
        # preemption resume so the id, not the row, is durable state.
        self.adapter = str(adapter).strip() if adapter else None
        self._adapter_row = 0             # bank row, set by Engine.submit
        self.queue_seconds = 0.0          # admission + resume re-queues
        self.prefill_computed_tokens = 0  # prompt tokens run on device
        self.prefill_cached_tokens = 0    # skipped via prefix cache/CoW
        self.prefill_chunks = 0           # chunked-prefill chunks run
        self.spec_proposed_tokens = 0     # draft tokens proposed
        self.spec_accepted_tokens = 0     # draft tokens accepted
        self.pages_allocated = 0          # fresh pool acquisitions
        self.spilled_pages = 0            # pages copied to host on
        self.spill_bytes = 0              # ... preemption, and back on
        self.restored_pages = 0           # ... resume
        self.restore_bytes = 0
        self.replays = 0                  # recovery replays
        # KV residency, folded in by the UsageMeter (0.0 when off)
        self.page_seconds = 0.0
        self.host_page_seconds = 0.0

        # tracing (observability.tracing): the engine opens a root
        # "request" span per request — parented under the caller's
        # traceparent when one arrived over HTTP — plus child spans for
        # the queue wait and the decode phase.  All None when tracing
        # is not in play (engine-only tests, bare Request objects).
        self.trace_parent = None          # SpanContext from the caller
        self.root_span = None
        self.queue_span = None
        self.decode_span = None
        # tail-latency forensics (observability.requestlog): the
        # engine's RequestLog attaches a RequestTimeline at submit;
        # None when forensics is off — every engine seam guards on it
        self.timeline = None

        # timing (engine clock): TTFT = first_token_at - arrival_time
        self.arrival_time = time.monotonic() if arrival_time is None \
            else arrival_time
        # queue-wait anchor for the cost ledger: reset to "now" on a
        # preemption re-queue so queue_seconds sums every wait
        self._queued_since = self.arrival_time
        self.admitted_at: float | None = None
        # FIFO stamp assigned by the scheduler at FIRST submit; a
        # preempted victim keeps it, so it re-queues ahead of later
        # arrivals of its class (Request ids are construction order,
        # which is not necessarily submission order)
        self.arrival_seq: int | None = None
        self.first_token_at: float | None = None
        self.last_token_at: float | None = None
        self.finished_at: float | None = None

        self._engine = None               # set by Engine.submit

    # ------------------------------------------------------------- status
    @property
    def num_generated(self) -> int:
        return len(self.output_tokens)

    def is_finished(self) -> bool:
        return self.state in (RequestState.DONE, RequestState.CANCELLED)

    def resume_tokens(self) -> np.ndarray:
        """Prompt + tokens generated so far — the effective prompt a
        preempted request re-prefills from on re-admission."""
        if not self.output_tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.output_tokens, np.int32)])

    @property
    def remaining_new_tokens(self) -> int:
        """Generation budget left after any already-emitted tokens."""
        return max(self.gen.max_new_tokens - self.num_generated, 1)

    def cancel(self):
        """Request cancellation.  Queued requests drop at the next
        scheduling pass; running requests are evicted at the next
        iteration boundary (their pages return to the pool)."""
        if not self.is_finished():
            self.cancel_requested = True

    # ---------------------------------------------------------- streaming
    def stream(self):
        """Yield output tokens in order.  When no token is pending and
        the request is attached to an engine, drives ``engine.step()``
        until the next token lands (or the request finishes)."""
        i = 0
        while True:
            while i < len(self.output_tokens):
                yield self.output_tokens[i]
                i += 1
            if self.is_finished():
                return
            if self._engine is None:
                return
            if not self._engine.step() and not self.is_finished() \
                    and i >= len(self.output_tokens):
                raise RuntimeError(
                    f"engine made no progress while request {self.id} is "
                    f"{self.state.value} (drained engine?)")

    def result(self) -> list[int]:
        """Block (by driving the attached engine) until finished; returns
        the generated tokens."""
        for _ in self.stream():
            pass
        return list(self.output_tokens)

    # ------------------------------------------------- engine-side hooks
    def _emit(self, token: int, now: float):
        self.output_tokens.append(int(token))
        if self.first_token_at is None:
            self.first_token_at = now
        self.last_token_at = now
        if self.on_token is not None:
            self.on_token(self, int(token))

    def __repr__(self):
        return (f"Request(id={self.id}, state={self.state.value}, "
                f"prompt_len={self.prompt.size}, "
                f"generated={self.num_generated}/{self.gen.max_new_tokens})")
