"""HTTP serving front-end for the continuous-batching engine.

Ports ``paddle_tpu/serving/server.py`` by copy (pure Python,
with the reference's metric names, span names, JSON fields and
routes).

Turns an in-process :class:`~paddle_tpu_torch.serving.Engine` into a network
service with zero new dependencies (stdlib ``http.server`` only):

  * ``POST /v1/completions`` — OpenAI-compatible completion endpoint
    over token ids (this layer has no tokenizer): blocking JSON or
    ``"stream": true`` SSE (``data: {...}`` chunks, terminated by
    ``data: [DONE]``).  Per-request ``timeout`` wires straight into the
    engine's deadline/cancel machinery; a client that disconnects
    mid-stream cancels its request at the next iteration boundary.
  * admission control — when the scheduler's queue is full the server
    answers ``429`` with a ``Retry-After`` header (backpressure is a
    protocol answer, never a hang or a 500); while draining it answers
    ``503``.
  * ``POST /v1/batches`` — the offline lane: a JSONL job (inline
    records or a server-side file) drip-fed at the ``"batch"``
    priority class, preempted by interactive traffic, with
    ``GET /v1/batches/<id>`` progress and a JSONL output file.
  * ``GET /healthz`` (engine stats + drain state), ``GET /metrics``
    (the observability registry's Prometheus export),
    ``GET /debug/resources`` (resource-tracker snapshot + engine pool
    census), ``GET /debug/profile`` (on-demand phase-attributed
    sampling-profiler window, folded / chrome / json),
    ``GET /debug/captures`` (alert-triggered diagnostic capture
    bundles), ``POST /drain`` /
    ``POST /resume`` (rolling restarts), and graceful drain on SIGTERM:
    in-flight streams finish, queued requests are failed fast, then the
    listener closes.

:func:`serve` takes a Llama ``config`` and ``state`` dict (or a built
``engine=``); the engine runs on CUDA unless ``device="cpu"`` is
passed.  ``python -m paddle_tpu_torch.serving.server`` serves a random
model on the card.

Threading model: the engine stays single-threaded.  One
:class:`EngineWorker` thread owns it and drives ``engine.step()``;
HTTP handler threads (``ThreadingHTTPServer``) only ever call
``worker.submit()`` under the worker lock and then consume tokens from
a per-request ``queue.Queue`` fed by the engine thread through the
request's ``on_token`` callback.
"""
from __future__ import annotations

import json
import queue
import signal
import socket
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import observability as _obs
from ..flags import FLAGS
from ..sanitizer import make_condition, make_rlock
from .engine import Engine
from .lora.batch import BATCH_PRIORITY, BatchJob
from .request import GenerationConfig, Request
from .supervisor import EngineSupervisor
from .watchdog import Watchdog

__all__ = ["BackpressureError", "DrainingError", "EngineWorker",
           "ServingServer", "serve"]

_M_HTTP_REQS = _obs.counter(
    "serving_http_requests_total", "HTTP requests by route and status",
    ("route", "code"))
_M_HTTP_REJECT = _obs.counter(
    "serving_http_rejections_total",
    "completions rejected before admission: 'backpressure' -> 429, "
    "'draining' -> 503, 'invalid' -> 400", ("reason",))
_M_HTTP_INFLIGHT = _obs.gauge(
    "serving_http_inflight",
    "completion requests currently held by handler threads")
_M_HTTP_CANCELS = _obs.counter(
    "serving_http_stream_cancels_total",
    "SSE streams cancelled by client disconnect")
_M_SLO_SHED = _obs.counter(
    "serving_slo_shed_total",
    "admissions refused (429) because an SLO dimension's burn rate "
    "crossed FLAGS_serving_shed_burn_rate, by priority class (only "
    "classes <= FLAGS_serving_shed_max_priority are shed)", ("class",))

# wire-level priority classes <-> scheduler integers; arbitrary ints
# are also accepted in request bodies for finer-grained fleets.
# "batch" is the offline lane: below every interactive class, so batch
# residents lose every admission race and preempt first.
_PRIORITY_NAMES = {"low": -1, "normal": 0, "high": 1,
                   "batch": BATCH_PRIORITY}
_PRIORITY_CLASS = {v: k for k, v in _PRIORITY_NAMES.items()}


def _priority_class(priority: int) -> str:
    """Metric label for a priority int (named classes stay readable)."""
    return _PRIORITY_CLASS.get(int(priority), str(int(priority)))


def _http_latency_hist():
    return _obs.histogram(
        "serving_http_request_seconds",
        "completion handler wall time (request read -> response end)",
        buckets=_obs.registry.SERVING_LATENCY_BUCKETS)


class BackpressureError(RuntimeError):
    """Admission queue full — surfaces as HTTP 429 + Retry-After."""


class DrainingError(RuntimeError):
    """Server is draining — surfaces as HTTP 503."""


class EngineWorker:
    """Owns an :class:`Engine` and drives it from ONE background thread.

    The engine is single-threaded by design (one device step, host-side
    slot mirrors), so every touch goes through :attr:`lock`: the worker
    thread holds it across ``engine.step()``, handler threads hold it
    for the (cheap) ``submit()``.  Token delivery back to handlers is
    lock-free — the engine thread runs each request's ``on_token``
    callback, which pushes into that handler's private queue.
    """

    def __init__(self, engine: Engine, *, max_queue: int = 64,
                 idle_wait: float = 0.005,
                 supervisor: EngineSupervisor | None = None):
        self.engine = engine
        # every step goes through the supervisor: a poisoned step costs
        # a runner rebuild + replay, not the worker thread
        self.supervisor = supervisor or EngineSupervisor(engine)
        self.max_queue = int(max_queue)
        self.lock = make_rlock("EngineWorker.lock")
        self._wake = make_condition(self.lock, name="EngineWorker._wake")
        self._stop = False
        self._started = False
        self._idle_wait = float(idle_wait)
        # recent Request objects, newest last (introspection + tests)
        self.requests: deque[Request] = deque(maxlen=512)
        # offline batch jobs by id: pumped by the worker thread between
        # steps, introspected by GET /v1/batches/<id>
        self.batches: dict[str, BatchJob] = {}
        # take over the engine's lora.json provider slot so the dump
        # also carries batch-job progress (engine registers itself at
        # construction; the worker wraps it — last writer wins)
        if engine.lora is not None:
            _obs.set_active_lora(self)
        # burn-rate sheds by priority class (mirror of
        # serving_slo_shed_total; /debug/fleet's scheduling block)
        self.shed_by_class: dict[str, int] = {}
        self._stall_until = 0.0     # inject_stall test hook
        self._thread = threading.Thread(
            target=self._loop, name="engine-worker", daemon=True)

    # --------------------------------------------------------- lifecycle
    def start(self) -> "EngineWorker":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        """Stop the engine thread; the lora.json and quant.json slots
        that hold this worker or its engine let them go."""
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        if self._started:
            self._thread.join(timeout=timeout)
        _obs.release_providers(self, self.engine)

    def _loop(self):
        while True:
            with self._wake:
                if self._stop:
                    return
                now = time.monotonic()
                if now < self._stall_until:
                    # inject_stall in effect: hold the loop without
                    # stepping — active slots persist while progress
                    # freezes, which is exactly the watchdog's trigger
                    self._wake.wait(min(self._stall_until - now, 0.05))
                    continue
                # the offline lane: top every live job's window back up
                # before stepping — batch submissions land at
                # BATCH_PRIORITY, so interactive arrivals still win the
                # admission race inside the scheduler pass
                if self.batches and not self.engine.scheduler.draining:
                    for job in list(self.batches.values()):
                        if not job.done:
                            job.pump(self.engine.submit)
                if not self.engine.scheduler.has_work():
                    self._wake.wait(self._idle_wait)
                    continue
                self.supervisor.step()

    def inject_stall(self, seconds: float):
        """TEST HOOK: wedge the decode loop for ``seconds`` — the worker
        thread keeps running but stops calling ``engine.step()``, so an
        in-flight request sits in its slot making zero progress (the
        condition the serving watchdog exists to catch)."""
        with self._wake:
            self._stall_until = time.monotonic() + float(seconds)
            self._wake.notify_all()

    # ------------------------------------------------------------ intake
    @property
    def draining(self) -> bool:
        return self.engine.scheduler.draining

    def submit(self, prompt, gen: GenerationConfig | None = None, *,
               timeout_s: float | None = None, on_token=None,
               trace=None, priority: int = 0,
               tenant: str | None = None,
               adapter: str | None = None) -> Request:
        """Thread-safe admission with backpressure: raises
        :class:`DrainingError` / :class:`BackpressureError` instead of
        queueing unboundedly; ``timeout_s`` becomes an absolute engine
        deadline (the existing cancel machinery enforces it).  ``trace``
        (a tracing.SpanContext) parents the engine-side request spans —
        the handler passes its ``server.request`` span context so the
        trace survives the hop onto the engine thread.  ``priority``
        is the scheduling class: burn-rate shedding only rejects
        classes <= ``FLAGS_serving_shed_max_priority``, and higher
        classes may preempt lower residents inside the engine.
        ``tenant`` is the usage-meter billing dimension; with
        ``FLAGS_serving_fair_share`` set and a meter wired, burn-rate
        shedding only refuses the heaviest-page-second tenant's
        requests within the shedable classes.  ``adapter`` names a
        registered LoRA adapter (unknown names reject with 400 at the
        HTTP layer via the engine's KeyError)."""
        priority = int(priority)
        with self._wake:
            if self.engine.scheduler.draining:
                raise DrainingError(
                    "server is draining; not admitting new requests")
            if len(self.engine.scheduler.queue) >= self.max_queue:
                raise BackpressureError(
                    f"admission queue full ({self.max_queue} waiting)")
            # SLO-driven shedding: refuse BEFORE the queue fills when
            # the live burn rate says admitted requests are already
            # missing their targets (429 + Retry-After, like queue-full).
            # Only the shedable classes are refused — high-priority
            # traffic keeps flowing and relies on preemption for room.
            shed = float(FLAGS.get("FLAGS_serving_shed_burn_rate") or 0.0)
            shed_max = int(
                FLAGS.get("FLAGS_serving_shed_max_priority") or 0)
            if shed > 0 and self.engine.slo is not None \
                    and priority <= shed_max:
                burn = self.engine.slo.max_burn_rate()
                if burn >= shed and self._should_shed(tenant):
                    cls = _priority_class(priority)
                    _M_SLO_SHED.labels(cls).inc()
                    self.shed_by_class[cls] = \
                        self.shed_by_class.get(cls, 0) + 1
                    _obs.flight("server", "slo_shed", burn=round(burn, 3),
                                threshold=shed, priority=priority)
                    raise BackpressureError(
                        f"SLO burn rate {burn:.2f} at/over shed "
                        f"threshold {shed:g}")
            deadline = (None if timeout_s is None
                        else self.engine._clock() + float(timeout_s))
            req = self.engine.submit(prompt, gen, deadline=deadline,
                                     on_token=on_token, trace=trace,
                                     priority=priority, tenant=tenant,
                                     adapter=adapter)
            self.requests.append(req)
            self._wake.notify_all()
        return req

    def submit_batch(self, job: BatchJob) -> BatchJob:
        """Register an offline batch job: the worker thread drip-feeds
        its records at BATCH_PRIORITY between engine steps (first
        window tops up at the next loop iteration)."""
        with self._wake:
            if self.engine.scheduler.draining:
                raise DrainingError(
                    "server is draining; not accepting batch jobs")
            self.batches[job.id] = job
            # batch lane works on dense engines too — make sure the
            # lora.json provider is wired so the dump carries the jobs
            _obs.set_active_lora(self)
            self._wake.notify_all()
        return job

    def lora_snapshot(self) -> dict:
        """``lora.json`` provider: the engine's adapter census plus
        every offline batch job's progress (the engine alone cannot
        see the jobs — they live on the worker)."""
        snap = self.engine.lora_snapshot()
        with self._wake:
            snap["batch_jobs"] = {jid: j.progress()
                                  for jid, j in self.batches.items()}
        return snap

    def _should_shed(self, tenant) -> bool:
        """Fair-share gate for burn-rate shedding: with
        ``FLAGS_serving_fair_share`` set and a usage meter wired, only
        the heaviest-page-second tenant's requests are refused — the
        tenant that consumed the most KV residency absorbs the overload
        first.  Everything sheds (the pre-existing behavior) when the
        flag or the meter is off, or no tenant has any history yet."""
        meter = self.engine.usage
        if meter is None:
            return True
        name = meter.tenants.canonical(tenant)
        if FLAGS.get("FLAGS_serving_fair_share"):
            heavy = meter.heaviest_tenant()
            if heavy is not None and name != heavy:
                return False
        # lock order is worker.lock -> meter._lock everywhere (the
        # engine's own meter calls nest the same way) and the meter
        # never calls back into the worker, so this cannot deadlock
        # tpu-lint: disable=callback-under-lock
        meter.on_shed(name)
        return True

    # ------------------------------------------------------------- drain
    def drain(self, timeout: float | None = None) -> bool:
        """Graceful drain: stop admitting, let in-flight sequences run
        to completion, then fail the never-admitted queued requests fast
        (their handlers would otherwise wait on a queue that drain will
        never schedule).  Returns False if ``timeout`` elapsed first."""
        with self.lock:
            self.engine.scheduler.drain()
        t0 = time.monotonic()
        while True:
            with self.lock:
                if self.engine.scheduler.active_count == 0:
                    break
            if timeout is not None and time.monotonic() - t0 > timeout:
                return False
            time.sleep(0.002)
        with self.lock:
            now = self.engine._clock()
            while self.engine.scheduler.queue:
                r = self.engine.scheduler.queue.popleft()
                self.engine.scheduler._finish(r, "cancelled", now)
        return True

    def resume(self):
        with self._wake:
            self.engine.scheduler.resume()
            self._wake.notify_all()

    # -------------------------------------------------------------- info
    def stats(self) -> dict:
        with self.lock:
            st = self.engine.stats()
            st["draining"] = self.engine.scheduler.draining
            st["max_queue"] = self.max_queue
        st["supervisor"] = self.supervisor.stats()
        return st


# --------------------------------------------------------------- protocol
def _parse_priority(value) -> int:
    """Priority from a body field or header: a named class
    (low/normal/high) or any int.  Raises ValueError otherwise."""
    if isinstance(value, str):
        name = value.strip().lower()
        if name in _PRIORITY_NAMES:
            return _PRIORITY_NAMES[name]
        try:
            return int(name)
        except ValueError:
            raise ValueError(
                f"invalid 'priority' {value!r}: use low/normal/high "
                "or an integer") from None
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValueError(
            f"invalid 'priority' {value!r}: use low/normal/high or "
            "an integer")
    return int(value)


def _parse_tenant(value) -> str | None:
    """Tenant id from a body field or the X-Tenant header: any
    non-empty string (whitespace-stripped); None / "" mean unset (the
    engine canonicalizes to "anon")."""
    if value is None:
        return None
    if not isinstance(value, str):
        raise ValueError(
            f"invalid 'tenant' {value!r}: must be a string")
    return value.strip() or None


def _parse_adapter(value) -> str | None:
    """LoRA adapter name from a body field or the X-Adapter header:
    any non-empty string (whitespace-stripped); None / "" mean the
    dense base model."""
    if value is None:
        return None
    if not isinstance(value, str):
        raise ValueError(
            f"invalid 'adapter' {value!r}: must be a string")
    return value.strip() or None


def _parse_completion(body: dict):
    """Validate a /v1/completions body -> (prompt, gen, stream,
    timeout_s, priority, tenant, adapter).  Raises ValueError with a
    client-facing message."""
    if not isinstance(body, dict):
        raise ValueError("request body must be a JSON object")
    prompt = body.get("prompt")
    if prompt is None:
        raise ValueError("missing 'prompt' (a list of token ids)")
    if isinstance(prompt, str):
        raise ValueError(
            "text prompts are not supported — this server speaks token "
            "ids (pass 'prompt' as a list of ints)")
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    temperature = float(body.get("temperature", 1.0))
    do_sample = body.get("do_sample")
    if do_sample is None:
        # OpenAI semantics: temperature 0 means greedy.  Sampling stays
        # opt-in ('do_sample' or an explicit non-default temperature)
        # because it needs an engine built with emit_logits=True.
        do_sample = "temperature" in body and temperature > 0.0
    gen = GenerationConfig(
        max_new_tokens=int(body.get("max_tokens", 16)),
        do_sample=bool(do_sample),
        temperature=temperature if temperature > 0 else 1.0,
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        eos_token_id=(None if body.get("eos_token_id") is None
                      else int(body["eos_token_id"])),
        seed=int(body.get("seed", 0)))
    timeout_s = body.get("timeout")
    if timeout_s is not None:
        timeout_s = float(timeout_s)
        if timeout_s <= 0:
            raise ValueError("'timeout' must be > 0 seconds")
    priority = _parse_priority(body.get("priority", 0))
    tenant = _parse_tenant(body.get("tenant"))
    adapter = _parse_adapter(body.get("adapter"))
    return prompt, gen, bool(body.get("stream", False)), timeout_s, \
        priority, tenant, adapter


_FINISH_REASON = {"length": "length", "eos": "stop",
                  "cancelled": "cancelled", "deadline": "timeout",
                  "error": "error"}


def _finish_reason(req: Request) -> str | None:
    if req.finish_reason is None:
        return None
    return _FINISH_REASON.get(req.finish_reason, req.finish_reason)


def _usage_json(req: Request) -> dict:
    """The enriched OpenAI-style ``usage`` block: token totals plus the
    per-request cost ledger highlights (cached prompt split, queue
    wait, speculation yield)."""
    plen = int(req.prompt.size)
    return {"prompt_tokens": plen,
            "completion_tokens": req.num_generated,
            "total_tokens": plen + req.num_generated,
            "prompt_tokens_cached": req.num_cached_tokens,
            "queue_ms": round(req.queue_seconds * 1e3, 3),
            "spec_accepted_tokens": req.spec_accepted_tokens,
            # adapter label only when one served the request, so dense
            # responses keep their exact pre-LoRA shape
            **({"adapter": req.adapter} if req.adapter else {})}


def _completion_json(model_name: str, req: Request) -> dict:
    return {
        "id": f"cmpl-{req.id}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": model_name,
        "choices": [{
            "index": 0,
            "text": " ".join(str(t) for t in req.output_tokens),
            "token_ids": list(req.output_tokens),
            "finish_reason": _finish_reason(req),
        }],
        "usage": _usage_json(req),
        # deprecated (one release): moved into usage.prompt_tokens_cached
        "num_cached_tokens": req.num_cached_tokens,
        **({"error": req.error} if req.error else {}),
    }


def _chunk_json(model_name: str, req: Request, tok: int | None,
                final: bool) -> dict:
    out = {
        "id": f"cmpl-{req.id}",
        "object": "text_completion.chunk",
        "model": model_name,
        "choices": [{
            "index": 0,
            "text": "" if tok is None else f"{tok} ",
            "token_ids": [] if tok is None else [int(tok)],
            "finish_reason": _finish_reason(req) if final else None,
        }],
    }
    if final:
        # the final SSE chunk mirrors the blocking response's usage
        # block, so streaming clients get the same cost attribution
        out["usage"] = _usage_json(req)
    return out


# ----------------------------------------------------------------- server
class ServingServer(ThreadingHTTPServer):
    """Threaded HTTP front door over one :class:`EngineWorker`.

    ``port=0`` binds an ephemeral port (tests); :attr:`address` reports
    the bound ``host:port``.  ``start()`` spawns both the engine worker
    and the accept loop; ``stop()`` is the graceful SIGTERM path —
    drain (finish in-flight streams), then close the listener.
    """

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, worker: EngineWorker, host: str = "127.0.0.1",
                 port: int = 0, *, retry_after_s: float = 1.0,
                 hard_timeout_s: float = 600.0,
                 model_name: str = "paddle-tpu-torch",
                 watchdog_s: float | None = None,
                 timeseries_interval_s: float | None = None,
                 profile_interval_s: float | None = None):
        self.worker = worker
        self.retry_after_s = float(retry_after_s)
        self.hard_timeout_s = float(hard_timeout_s)
        self.model_name = model_name
        if watchdog_s is None:
            watchdog_s = float(
                FLAGS.get("FLAGS_serving_watchdog_seconds") or 0.0)
        self.watchdog = Watchdog(worker.engine, watchdog_s)
        # stall -> self-healing: the watchdog flags the supervisor, the
        # engine thread performs the recovery at its next step
        self.watchdog.on_stall = worker.supervisor.note_stall
        # fleet telemetry: with the interval unset NOTHING is built —
        # no store, no sampler thread, no per-request cost beyond the
        # `is not None` tests below (the faults/sanitizer contract)
        if timeseries_interval_s is None:
            timeseries_interval_s = float(
                FLAGS.get("FLAGS_obs_timeseries_interval_s") or 0.0)
        self._ts_interval = float(timeseries_interval_s)
        self.timeseries = None
        if self._ts_interval > 0:
            store = _obs.serving_sources(_obs.TimeSeriesStore())
            for rule in _obs.default_rules():
                store.add_rule(rule)
            self.timeseries = store
        # continuous phase-attributed profiling — same contract: with
        # the interval unset no profiler object or sweep thread exists
        if profile_interval_s is None:
            profile_interval_s = float(
                FLAGS.get("FLAGS_obs_profile_interval_s") or 0.0)
        self._profile_interval = float(profile_interval_s)
        self.profiler = None
        if self._profile_interval > 0:
            self.profiler = _obs.set_active_profiler(
                _obs.SamplingProfiler(self._profile_interval,
                                      phases=self._engine_phases))
        # alert-triggered diagnostic capture rides the timeseries
        # store's fire hook: no alerts -> no capture object either
        self.capture = None
        if self.timeseries is not None:
            self.capture = _obs.set_active_capture(
                _obs.DiagnosticCapture(profiler=self.profiler)
                .attach(self.timeseries))
        self._latency = _http_latency_hist()
        self._serve_thread: threading.Thread | None = None
        self._stop_thread: threading.Thread | None = None
        super().__init__((host, port), _Handler)

    @property
    def address(self) -> str:
        return f"{self.server_address[0]}:{self.server_address[1]}"

    def _engine_phases(self) -> dict:
        """Thread-ident -> phase map for the sampling profiler: the
        engine worker thread reports ``engine.current_phase``.  Plain
        attribute reads, lock-free — the watchdog contract."""
        t = self.worker._thread
        if t is None or t.ident is None:
            return {}
        return {t.ident: self.worker.engine.current_phase}

    def start(self) -> "ServingServer":
        self.worker.start()
        self.watchdog.start()       # no-op when watchdog_s <= 0
        if self.timeseries is not None:
            self.timeseries.start_sampling(self._ts_interval)
        if self.profiler is not None:
            self.profiler.start_sampling()
        self._serve_thread = threading.Thread(
            target=self.serve_forever, name=f"http:{self.address}",
            daemon=True)
        self._serve_thread.start()
        return self

    def stop(self, *, drain_timeout: float | None = None):
        """Graceful shutdown: drain in-flight work, then close."""
        self.watchdog.stop()
        if self.timeseries is not None:
            self.timeseries.stop()
        if self.profiler is not None:
            self.profiler.stop()
        self.worker.drain(timeout=drain_timeout)
        self.shutdown()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5.0)
        self.worker.stop()
        self.server_close()

    def install_signal_handlers(self,
                                sigs=(signal.SIGTERM, signal.SIGINT)):
        """SIGTERM/SIGINT => graceful drain-then-exit.  Only callable
        from the main thread (signal module restriction).  The handler
        must return immediately, so stop() runs on its own thread; the
        handle is retained (``_stop_thread``) so the foreground path
        can join it, and a second signal during a drain is a no-op
        instead of racing a second stop() against the first."""
        def _graceful(signum, frame):
            if self._stop_thread is not None:
                return          # already draining; don't stack stops
            self._stop_thread = threading.Thread(
                target=self.stop, name="server-shutdown", daemon=True)
            self._stop_thread.start()
        for s in sigs:
            signal.signal(s, _graceful)

    def fleet_summary(self) -> dict:
        """Compact replica summary for ``GET /debug/fleet``: pool
        census + fragmentation, cached-chain digest, slots/queue
        headroom, SLO burn rates, spec acceptance, recovery counts,
        firing alerts, and recent time-series windows.  The engine half
        walks scheduler state, so it runs under the worker lock; the
        telemetry half reads the store lock-free."""
        worker = self.worker
        with worker.lock:
            eng = worker.engine
            b = eng.blocks
            pool = b.pool_accounting()
            head_need = None
            if eng.scheduler.queue:
                head = eng.scheduler.queue[0]
                head_need = b.pages_needed(head.prompt.size,
                                           head.gen.max_new_tokens)
            pool["fragmentation_ratio"] = round(
                b.fragmentation(head_need), 6)
            prefix = b.prefix_digest()
            lookups = b.prefix_hits + b.prefix_misses
            prefix["hits"] = b.prefix_hits
            prefix["misses"] = b.prefix_misses
            prefix["hit_rate"] = (round(b.prefix_hits / lookups, 6)
                                  if lookups else None)
            active = eng.scheduler.active_count
            slots = {"active": active, "max": eng.scheduler.max_slots,
                     "free": eng.scheduler.max_slots - active}
            queue = {"depth": len(eng.scheduler.queue),
                     "max": worker.max_queue}
            slo = None
            if eng.slo is not None:
                slo = {"burn_rates": {
                           d: round(r, 6)
                           for d, r in eng.slo.burn_rates().items()},
                       "max_burn_rate": round(eng.slo.max_burn_rate(),
                                              6)}
            spec = {"spec_k": eng.spec_k}
            if eng._spec is not None:
                spec.update(eng._spec.snapshot())
            recovery = {"recoveries": eng.recoveries,
                        "quarantines": eng.quarantines,
                        "replayed_requests": eng.replayed_requests}
            scheduling = {"prefill_chunk": eng.prefill_chunk,
                          "prefill_chunks": eng.prefill_chunks,
                          "max_prefill_gap": eng.max_prefill_gap,
                          "preemptions": eng.preemptions,
                          "spill_aborts": eng.spill_aborts,
                          "spilled_pages": b.spilled_pages,
                          "restored_pages": b.restored_pages,
                          "spill_bytes": b.spill_bytes,
                          "host_parked_pages": b.host_parked,
                          "shed_by_class": dict(worker.shed_by_class)}
            usage = (eng.usage.snapshot()
                     if eng.usage is not None else None)
            # tail forensics: dominant latency cause + worst exemplar
            # (age on the engine clock) for the dashboard's tail line
            tail = (eng.requestlog.tail_summary(now=eng._clock())
                    if eng.requestlog is not None else None)
            # adapter residency census: the router folds this into its
            # expected-hit-rate score so adapter traffic sticks to
            # replicas already holding the weights
            adapters = (eng.lora_snapshot()
                        if eng.lora is not None else None)
            batches = {jid: j.progress()
                       for jid, j in worker.batches.items()}
            draining = eng.scheduler.draining
        # raw cumulative latency buckets, not quantiles: consumers
        # (dashboard, router) merge buckets ACROSS replicas and then
        # estimate — averaging per-replica quantiles would be wrong
        latency = {}
        reg = _obs.default_registry()
        for key, mname in (("ttft", "serving_ttft_seconds"),
                           ("e2e", "serving_e2e_seconds")):
            fam = reg.get(mname)
            if fam is None:
                continue
            merged, count, total = _obs.merge_series_buckets(
                [child.snapshot() for _, child in fam._series()])
            if count:
                latency[key] = {"buckets": merged, "count": count,
                                "sum": round(total, 9)}
        ts = self.timeseries
        return {"kind": "replica", "model": self.model_name,
                "address": self.address, "draining": draining,
                "pool": pool, "prefix": prefix, "slots": slots,
                "queue": queue, "slo": slo, "spec": spec,
                "recovery": recovery, "scheduling": scheduling,
                "usage": usage, "tail": tail, "adapters": adapters,
                "batches": batches, "latency": latency,
                "watchdog": self.watchdog.state(),
                "alerts": ({"firing": ts.firing(),
                            "fired_total": ts.alerts_fired,
                            "ticks": ts.ticks}
                           if ts is not None else None),
                "profiling": (self.profiler.stats()
                              if self.profiler is not None else None),
                "captures": (self.capture.index()
                             if self.capture is not None else None),
                "series": ts.windows() if ts is not None else {}}


# one-line descriptions for GET /debug/ — operators stop guessing paths
_DEBUG_INDEX = {
    "/debug/": "this index",
    "/debug/trace": "span ring + sampled counter tracks "
                    "(chrome://tracing loadable)",
    "/debug/flight": "flight-recorder event ring + watchdog state",
    "/debug/resources": "resource-tracker snapshot + engine pool census",
    "/debug/fleet": "compact replica summary: pool census, prefix "
                    "digest, burn rates, alerts, series windows",
    "/debug/profile": "sample a phase-attributed profile window: "
                      "?seconds=N&format=folded|chrome|json",
    "/debug/captures": "alert-triggered diagnostic capture index + "
                       "retained evidence bundles",
    "/debug/usage": "per-tenant usage table (tokens, page-seconds, "
                    "goodput) + the page-seconds conservation check",
    "/debug/requests/<id>": "one request's lifecycle waterfall + "
                            "critical-path attribution "
                            "(?format=chrome for chrome://tracing)",
    "/debug/exemplars": "worst-K SLO-violation exemplars per dimension "
                        "+ the attribution conservation census",
}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: ServingServer

    def log_message(self, fmt, *args):      # metrics, not stderr noise
        pass

    # ----------------------------------------------------------- helpers
    def _json(self, code: int, obj: dict, route: str, headers=()):
        body = json.dumps(obj).encode()
        # counted before the answer goes out: a client that scrapes
        # /metrics right after reading it sees its own request
        _M_HTTP_REQS.labels(route, str(code)).inc()
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError,
                ConnectionAbortedError):
            pass

    def _error(self, code: int, message: str, route: str, *,
               etype: str = "invalid_request_error", headers=()):
        self._json(code, {"error": {"message": message, "type": etype,
                                    "code": code}}, route,
                   headers=headers)

    def _read_body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n > 0 else b"{}"
        return json.loads(raw.decode() or "{}")

    # ------------------------------------------------------------ routes
    def do_GET(self):
        if self.path == "/healthz":
            st = self.worker_stats()
            st["status"] = "draining" if st["draining"] else "ok"
            st["watchdog"] = self.server.watchdog.state()
            ts = self.server.timeseries
            if ts is not None:
                st["alerts"] = {"firing": ts.firing(),
                                "fired_total": ts.alerts_fired}
            self._json(200, st, "/healthz")
        elif self.path == "/metrics":
            text = _obs.default_registry().to_prometheus().encode()
            _M_HTTP_REQS.labels("/metrics", "200").inc()
            try:
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(text)))
                self.end_headers()
                self.wfile.write(text)
            except (BrokenPipeError, ConnectionResetError):
                pass
        elif self.path == "/debug/flight":
            fr = _obs.flight_recorder()
            self._json(200, {"capacity": fr.capacity,
                             "events": fr.snapshot(),
                             "watchdog": self.server.watchdog.state()},
                       "/debug/flight")
        elif self.path == "/debug/trace":
            # curl -s :port/debug/trace > t.json  ->  chrome://tracing
            self._json(200, {"traceEvents":
                             (_obs.tracer().chrome_events()
                              + _obs.chrome_counter_events())},
                       "/debug/trace")
        elif self.path == "/debug/resources":
            # process tracker (memory/compiles/goodput/throughput) plus
            # the engine-local pool census; the engine half walks
            # scheduler state, so it runs under the worker lock
            snap = _obs.resource_tracker().snapshot()
            worker = self.server.worker
            with worker.lock:
                snap["engine"] = worker.engine.resource_snapshot()
            self._json(200, snap, "/debug/resources")
        elif self.path == "/debug/fleet":
            self._json(200, self.server.fleet_summary(), "/debug/fleet")
        elif self.path.split("?", 1)[0] == "/debug/profile":
            self._profile()
        elif self.path.split("?", 1)[0] == "/debug/captures":
            cap = self.server.capture
            if cap is None:
                self._error(
                    404, "diagnostic capture disabled (set "
                    "FLAGS_obs_timeseries_interval_s > 0)",
                    "/debug/captures")
            else:
                self._json(200, {"kind": "replica", "index": cap.index(),
                                 "recent": cap.recent()},
                           "/debug/captures")
        elif self.path == "/debug/usage":
            worker = self.server.worker
            meter = worker.engine.usage
            if meter is None:
                self._error(
                    404, "usage metering disabled (set "
                    "FLAGS_serving_usage_meter or pass usage= to the "
                    "engine)", "/debug/usage")
            else:
                with worker.lock:
                    snap = meter.snapshot()
                self._json(200, dict(snap, kind="replica"),
                           "/debug/usage")
        elif self.path == "/debug/exemplars":
            worker = self.server.worker
            log = worker.engine.requestlog
            if log is None:
                self._error(
                    404, "request log disabled (set "
                    "FLAGS_serving_request_log or pass requestlog= to "
                    "the engine)", "/debug/exemplars")
            else:
                with worker.lock:
                    snap = log.snapshot()
                self._json(200, dict(snap, kind="replica"),
                           "/debug/exemplars")
        elif self.path.split("?", 1)[0].startswith("/debug/requests/"):
            self._request_waterfall()
        elif self.path == "/v1/batches":
            worker = self.server.worker
            with worker.lock:
                jobs = {jid: j.progress()
                        for jid, j in worker.batches.items()}
            self._json(200, {"jobs": jobs}, "/v1/batches")
        elif self.path.startswith("/v1/batches/"):
            jid = self.path[len("/v1/batches/"):]
            worker = self.server.worker
            with worker.lock:
                job = worker.batches.get(jid)
                prog = job.progress() if job is not None else None
            if prog is None:
                self._error(404, f"no batch job {jid!r}", "/v1/batches")
            else:
                self._json(200, prog, "/v1/batches")
        elif self.path in ("/debug", "/debug/"):
            self._json(200, {"endpoints": _DEBUG_INDEX}, "/debug/")
        else:
            self._error(404, f"no route {self.path}", self.path)

    def _request_waterfall(self):
        """``GET /debug/requests/<id>[?format=chrome]``: one request's
        lifecycle waterfall — the event list + the critical-path
        attribution whose buckets sum to its measured E2E — or the
        chrome://tracing-loadable export of the same timeline."""
        from urllib.parse import parse_qs, urlparse
        u = urlparse(self.path)
        route = "/debug/requests"         # bounded metric label
        worker = self.server.worker
        log = worker.engine.requestlog
        if log is None:
            self._error(404, "request log disabled (set "
                        "FLAGS_serving_request_log or pass requestlog= "
                        "to the engine)", route)
            return
        rid_s = u.path[len("/debug/requests/"):]
        try:
            rid = int(rid_s)
        except ValueError:
            self._error(400, "request id must be an integer, got "
                        f"{rid_s!r}", route)
            return
        fmt = parse_qs(u.query).get("format", ["json"])[0]
        if fmt not in ("json", "chrome"):
            self._error(400, f"unknown format {fmt!r} (json | chrome)",
                        route)
            return
        with worker.lock:
            tl = log.get(rid)
            doc = None if tl is None else (
                tl.chrome_trace() if fmt == "chrome" else tl.to_dict())
        if doc is None:
            self._error(404, f"no timeline for request {rid} (never "
                        "submitted here, or evicted from the bounded "
                        "log)", route)
        else:
            if fmt != "chrome":
                doc = dict(doc, kind="replica")
            self._json(200, doc, route)

    def _profile(self):
        """``GET /debug/profile?seconds=N[&format=...]``: sample a
        fresh phase-attributed window from THIS handler thread (the
        continuous profiler, when armed, keeps running independently)
        and render it folded (flamegraph text, the default), as a
        chrome-trace merge with the span ring, or as the JSON snapshot
        (what the router fan-out aggregates)."""
        from urllib.parse import parse_qs, urlparse
        q = parse_qs(urlparse(self.path).query)
        try:
            seconds = float(q.get("seconds", ["1.0"])[0])
        except ValueError:
            self._error(400, "seconds must be a number",
                        "/debug/profile")
            return
        fmt = q.get("format", ["folded"])[0]
        if fmt not in ("folded", "chrome", "json"):
            self._error(400, f"unknown format {fmt!r} (folded | "
                        "chrome | json)", "/debug/profile")
            return
        interval = (self.server._profile_interval
                    if self.server._profile_interval > 0 else 0.01)
        prof = _obs.SamplingProfiler(
            interval, phases=self.server._engine_phases)
        prof.profile_for(seconds)
        if fmt == "json":
            self._json(200, dict(prof.snapshot(), kind="replica"),
                       "/debug/profile")
            return
        if fmt == "chrome":
            self._json(200, {"traceEvents":
                             (_obs.tracer().chrome_events()
                              + prof.chrome_events()),
                             "stats": prof.stats()},
                       "/debug/profile")
            return
        text = (prof.folded() + "\n").encode()
        _M_HTTP_REQS.labels("/debug/profile", "200").inc()
        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(text)))
            self.end_headers()
            self.wfile.write(text)
        except (BrokenPipeError, ConnectionResetError,
                ConnectionAbortedError):
            pass

    def worker_stats(self) -> dict:
        return self.server.worker.stats()

    def do_POST(self):
        if self.path == "/v1/completions":
            self._completions()
        elif self.path == "/v1/batches":
            self._batches()
        elif self.path == "/drain":
            try:
                body = self._read_body()
            except (ValueError, json.JSONDecodeError):
                body = {}
            ok = self.server.worker.drain(timeout=body.get("timeout"))
            self._json(200 if ok else 504, {"drained": ok}, "/drain")
        elif self.path == "/resume":
            self.server.worker.resume()
            self._json(200, {"resumed": True}, "/resume")
        else:
            self._error(404, f"no route {self.path}", self.path)

    # ----------------------------------------------------------- batches
    def _batches(self):
        """``POST /v1/batches``: start an offline batch job.  Body:
        ``{"records": [{"prompt": [ids], ...}, ...]}`` for inline
        records or ``{"input_path": "file.jsonl"}`` for a server-side
        JSONL file; optional ``window`` / ``max_tokens`` / ``tenant`` /
        ``adapter`` / ``output_path``.  The job drip-feeds at the
        "batch" priority class (below every interactive name) and
        ``GET /v1/batches/<id>`` reports progress."""
        route = "/v1/batches"
        try:
            body = self._read_body()
        except (ValueError, json.JSONDecodeError):
            return self._error(400, "invalid JSON body", route)
        try:
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
            kw = {"window": int(body.get("window", 2)),
                  "max_tokens": int(body.get("max_tokens", 16)),
                  "tenant": _parse_tenant(body.get("tenant")),
                  "adapter": _parse_adapter(body.get("adapter"))}
            if body.get("output_path") is not None:
                kw["output_path"] = str(body["output_path"])
            path = body.get("input_path")
            if path is not None:
                job = BatchJob.from_jsonl(str(path), **kw)
            elif isinstance(body.get("records"), list):
                job = BatchJob(body["records"], **kw)
            else:
                raise ValueError(
                    "pass 'records' (a list of {'prompt': [ids]} "
                    "objects) or 'input_path' (a server-side JSONL "
                    "file)")
        except OSError as e:
            return self._error(400, f"cannot read input_path: {e}",
                               route)
        except (ValueError, TypeError) as e:
            return self._error(400, str(e), route)
        try:
            self.server.worker.submit_batch(job)
        except DrainingError as e:
            return self._error(503, str(e), route,
                               etype="overloaded_error")
        _obs.flight("server", "batch_submit", job=job.id,
                    records=len(job.records))
        self._json(200, job.progress(), route)

    # ------------------------------------------------------- completions
    def _completions(self):
        # join the caller's distributed trace (W3C traceparent) — or
        # start a fresh one when the request arrived untraced
        parent = _obs.parse_traceparent(self.headers.get("traceparent"))
        span = _obs.tracer().start_span(
            "server.request", parent=parent,
            attributes={"route": "/v1/completions",
                        "model": self.server.model_name,
                        "remote": parent is not None})
        with span:
            self._completions_traced(span)

    def _completions_traced(self, span):
        route = "/v1/completions"
        t0 = time.monotonic()
        faults = self.server.worker.engine.faults
        if faults is not None and \
                faults.check("conn_reset", route=route) is not None:
            # synthetic peer reset before any response bytes: the client
            # sees RemoteDisconnected, the router's pre-response retry
            # path re-dispatches to another replica
            span.set_attribute("fault", "conn_reset")
            self._drop_connection()
            return
        try:
            body = self._read_body()
        except (ValueError, json.JSONDecodeError):
            _M_HTTP_REJECT.labels("invalid").inc()
            span.set_attribute("status", 400)
            return self._error(400, "invalid JSON body", route)
        try:
            prompt, gen, stream, timeout_s, priority, tenant, adapter = \
                _parse_completion(body)
            # the X-Priority / X-Tenant / X-Adapter headers override
            # the body (gateways tag traffic classes, billing
            # dimensions, and adapter routes without rewriting payloads)
            hdr = self.headers.get("X-Priority")
            if hdr is not None:
                priority = _parse_priority(hdr)
            hdr = self.headers.get("X-Tenant")
            if hdr is not None:
                tenant = _parse_tenant(hdr) or tenant
            hdr = self.headers.get("X-Adapter")
            if hdr is not None:
                adapter = _parse_adapter(hdr) or adapter
        except (ValueError, TypeError) as e:
            _M_HTTP_REJECT.labels("invalid").inc()
            span.set_attribute("status", 400)
            return self._error(400, str(e), route)
        span.set_attribute("stream", stream)
        if priority:
            span.set_attribute("priority", priority)
        if tenant:
            span.set_attribute("tenant", tenant)
        if adapter:
            span.set_attribute("adapter", adapter)

        toks: queue.Queue = queue.Queue()
        try:
            req = self.server.worker.submit(
                prompt, gen, timeout_s=timeout_s, trace=span.context,
                priority=priority, tenant=tenant, adapter=adapter,
                on_token=lambda r, t: toks.put(int(t)))
        except DrainingError as e:
            _M_HTTP_REJECT.labels("draining").inc()
            span.set_attribute("status", 503)
            return self._error(
                503, str(e), route, etype="overloaded_error",
                headers=[("Retry-After", f"{self.server.retry_after_s:g}")])
        except BackpressureError as e:
            _M_HTTP_REJECT.labels("backpressure").inc()
            span.set_attribute("status", 429)
            return self._error(
                429, str(e), route, etype="overloaded_error",
                headers=[("Retry-After", f"{self.server.retry_after_s:g}")])
        except (ValueError, TypeError, KeyError) as e:
            # engine-side validation; KeyError is an unknown adapter
            # name from the AdapterStore
            _M_HTTP_REJECT.labels("invalid").inc()
            span.set_attribute("status", 400)
            msg = e.args[0] if isinstance(e, KeyError) and e.args \
                else str(e)
            return self._error(400, str(msg), route)
        span.set_attribute("req", req.id)

        hard_deadline = t0 + (timeout_s or self.server.hard_timeout_s) \
            + 5.0
        _M_HTTP_INFLIGHT.inc()
        try:
            if stream:
                self._stream(req, toks, route, hard_deadline)
            else:
                self._blocking(req, toks, route, hard_deadline)
            if req.finish_reason is not None:
                span.set_attribute("finish_reason", req.finish_reason)
        finally:
            _M_HTTP_INFLIGHT.dec()
            self.server._latency.observe(time.monotonic() - t0)

    def _wait_token(self, req: Request, toks: queue.Queue,
                    hard_deadline: float):
        """Next token, or None when the request is finished and its
        queue is fully drained.  The hard deadline is a backstop for a
        wedged engine — the per-request timeout normally fires first
        through the engine's own deadline eviction."""
        while True:
            try:
                return toks.get(timeout=0.05)
            except queue.Empty:
                # on_token runs BEFORE finalize, so once is_finished()
                # is observed every token is already in the queue
                if req.is_finished() and toks.empty():
                    return None
                if time.monotonic() > hard_deadline:
                    req.cancel()
                    return None

    def _blocking(self, req: Request, toks: queue.Queue, route: str,
                  hard_deadline: float):
        while self._wait_token(req, toks, hard_deadline) is not None:
            pass
        if not req.is_finished():       # hard-timeout backstop tripped
            return self._error(504, "request timed out server-side",
                               route, etype="timeout_error")
        self._json(200, _completion_json(self.server.model_name, req),
                   route)

    def _stream(self, req: Request, toks: queue.Queue, route: str,
                hard_deadline: float):
        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
        except (OSError, ValueError):
            req.cancel()
            _M_HTTP_CANCELS.inc()
            return
        _M_HTTP_REQS.labels(route, "200").inc()
        self.close_connection = True
        name = self.server.model_name
        faults = self.server.worker.engine.faults
        sent = 0
        with _obs.tracer().start_span("server.stream") as ss:
            try:
                while True:
                    tok = self._wait_token(req, toks, hard_deadline)
                    if tok is None:
                        break
                    self._send_event(_chunk_json(name, req, tok, False))
                    sent += 1
                    if faults is not None and faults.check(
                            "stream_hangup", sent=sent,
                            req=req.id) is not None:
                        # synthetic mid-SSE hangup: hard-shutdown the
                        # socket so the NEXT write fails exactly like a
                        # real peer reset (the except below takes the
                        # cancel path, freeing the slot and its pages)
                        ss.set_attribute("fault", "stream_hangup")
                        self._drop_connection()
                self._send_event(_chunk_json(name, req, None, True))
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except (OSError, ValueError):
                # OSError covers the peer-reset family (BrokenPipe/
                # ConnectionReset/ConnectionAborted/EBADF); ValueError is
                # "write to closed file" after an injected hangup
                # client went away mid-stream: cancel so the engine
                # frees the slot/pages at the next iteration boundary
                req.cancel()
                ss.set_attribute("cancelled", True)
                _M_HTTP_CANCELS.inc()
            ss.set_attribute("tokens", sent)

    def _send_event(self, obj: dict):
        self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
        # flush per event: SSE latency AND prompt disconnect detection
        self.wfile.flush()

    def _drop_connection(self):
        """Fault-injection helper: kill the client connection like a
        dying process would.  ``shutdown`` (not ``close``) — rfile/wfile
        hold the fd alive through socket refcounting, so a plain close
        would leave writes silently succeeding."""
        self.close_connection = True
        try:
            self.connection.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass


def serve(config=None, state=None, *, model=None,
          engine: Engine | None = None,
          host: str = "127.0.0.1", port: int = 0, max_queue: int = 64,
          retry_after_s: float = 1.0, model_name: str = "paddle-tpu-torch",
          watchdog_s: float | None = None,
          timeseries_interval_s: float | None = None,
          profile_interval_s: float | None = None,
          start: bool = True, **engine_kw) -> ServingServer:
    """One-call server bring-up::

        server = serve(llama3_8b(), state, port=8000, max_slots=8,
                       enable_prefix_cache=True)
        print("listening on", server.address)

    Pass a ``model`` (a ``LlamaForCausalLM``, as the reference's
    ``serve(model)``: served on its parameters' device), or ``config``
    and ``state`` (a Llama config and its state dict; ``engine_kw``
    forwards to :func:`~paddle_tpu_torch.serving.create_engine`, whose
    ``device=None`` runs on CUDA), or a prebuilt ``engine=``.  A model
    passed first (``serve(model)``) is told from a config by its
    ``functional_state``.  With ``start=False`` the
    caller wires signals and starts the server itself.  ``watchdog_s``
    arms the decode-loop watchdog (default:
    ``FLAGS_serving_watchdog_seconds``; 0 off), ``timeseries_interval_s``
    arms the fleet-telemetry sampler (default:
    ``FLAGS_obs_timeseries_interval_s``; 0 off — nothing is built; with
    it on, alert fires also trigger diagnostic captures),
    ``profile_interval_s`` arms the continuous phase-attributed sampling
    profiler (default: ``FLAGS_obs_profile_interval_s``; 0 off — nothing
    is built), and when the ``FLAGS_serving_slo_*`` targets are set the
    engine gets an :class:`~paddle_tpu_torch.serving.slo.SLOTracker`
    automatically (likewise a usage meter under
    ``FLAGS_serving_usage_meter`` and a request log under
    ``FLAGS_serving_request_log``).
    """
    if hasattr(config, "functional_state"):
        model, config = config, None
    if model is not None and (config is not None or state is not None):
        raise ValueError("pass model=, or config= and state=, not both")
    if engine is None:
        if model is None and (config is None or state is None):
            raise ValueError("pass model=, config= and state=, or engine=")
        from .engine import create_engine
        if "slo" not in engine_kw:
            from .slo import SLOConfig, SLOTracker
            slo_cfg = SLOConfig.from_flags()
            if slo_cfg.enabled:
                engine_kw["slo"] = SLOTracker(slo_cfg)
        if "usage" not in engine_kw \
                and FLAGS.get("FLAGS_serving_usage_meter"):
            from ..observability.usage import UsageMeter
            engine_kw["usage"] = UsageMeter(max_tenants=int(
                FLAGS.get("FLAGS_serving_usage_max_tenants") or 64))
        if "requestlog" not in engine_kw \
                and FLAGS.get("FLAGS_serving_request_log"):
            from ..observability.requestlog import RequestLog
            engine_kw["requestlog"] = RequestLog(
                k=int(FLAGS.get("FLAGS_serving_exemplars_k") or 8))
        engine = create_engine(model, **engine_kw) if model is not None \
            else create_engine(config, state, **engine_kw)
    elif config is not None or state is not None or model is not None \
            or engine_kw:
        extra = sorted(engine_kw) + [n for n, v in (("config", config),
                                                    ("state", state),
                                                    ("model", model))
                                     if v is not None]
        raise ValueError(f"engine= given; unexpected {sorted(extra)}")
    worker = EngineWorker(engine, max_queue=max_queue)
    server = ServingServer(worker, host, port,
                           retry_after_s=retry_after_s,
                           model_name=model_name, watchdog_s=watchdog_s,
                           timeseries_interval_s=timeseries_interval_s,
                           profile_interval_s=profile_interval_s)
    if start:
        server.start()
    return server


def _main(argv=None):
    """Demo entry point: serve a randomly initialized llama (no
    checkpoint needed) on the card::

        python -m paddle_tpu_torch.serving.server --port 8000
        curl -s localhost:8000/v1/completions -d \\
            '{"prompt": [1,2,3], "max_tokens": 8}'

    The model is a tiny llama (``--layers/--hidden/--vocab``, 4 heads)
    with random weights from seed 0.
    """
    import argparse

    ap = argparse.ArgumentParser(description=_main.__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--max-model-len", type=int, default=256)
    ap.add_argument("--layers", type=int, default=2)
    # 4 heads of 32: the card's paged-attention kernel is built for head
    # dims 32/64/128/256 (the reference's default 64 gives head_dim 16)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=128)
    ap.add_argument("--prefix-cache",
                    action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--sync-interval", type=int, default=1)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: at most N prompt tokens per "
                    "engine step (0 = whole prompt; default "
                    "FLAGS_serving_prefill_chunk)")
    ap.add_argument("--preempt",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="priority preempt-and-swap (default "
                    "FLAGS_serving_preempt); requests pick a class via "
                    "body 'priority' or the X-Priority header")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="speculative decoding draft length (0 = off; "
                    "default FLAGS_serving_spec_k); greedy outputs are "
                    "identical either way")
    ap.add_argument("--emit-logits", action="store_true",
                    help="enable do_sample requests")
    ap.add_argument("--mesh", default=None,
                    help="tensor-parallel mesh size (e.g. 2 or tp=2; "
                    "default FLAGS_serving_mesh_tp): one process per "
                    "card, this one rank 0 on cuda:0; it must divide "
                    "the 4 q heads and the 2 kv heads")
    ap.add_argument("--quant", choices=("none", "int8", "int4"),
                    default="none",
                    help="weight-only quantized serving (default "
                    "FLAGS_serving_quant): int8/int4 weights through the "
                    "K4 GEMV, embeddings/norms/lm_head stay dense")
    ap.add_argument("--kv-quant",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="int8 KV pages with per-(page-row, head) f32 "
                    "scales (default FLAGS_serving_kv_quant)")
    args = ap.parse_args(argv)

    import torch

    from .. import resolve_device
    from ..models import init_state, llama_tiny
    dev = resolve_device()          # the card; raises without one
    cfg = llama_tiny(num_hidden_layers=args.layers, hidden_size=args.hidden,
                     intermediate_size=2 * args.hidden,
                     vocab_size=args.vocab, num_attention_heads=4,
                     num_key_value_heads=2,
                     max_position_embeddings=args.max_model_len)
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    server = serve(cfg, state, host=args.host, port=args.port,
                   max_queue=args.max_queue, max_slots=args.max_slots,
                   page_size=args.page_size,
                   max_model_len=args.max_model_len,
                   emit_logits=args.emit_logits,
                   enable_prefix_cache=args.prefix_cache,
                   sync_interval=args.sync_interval, mesh=args.mesh,
                   spec_k=args.spec_k,
                   prefill_chunk=args.prefill_chunk,
                   preempt=args.preempt,
                   quant=(None if args.quant == "none" else args.quant),
                   kv_quant=args.kv_quant, start=False)
    server.install_signal_handlers()
    server.start()
    print(f"serving on http://{server.address} "
          f"(SIGTERM drains gracefully)", flush=True)
    try:
        while server._serve_thread.is_alive():
            server._serve_thread.join(timeout=1.0)
    except KeyboardInterrupt:
        server.stop()
    if server._stop_thread is not None:     # signal-driven shutdown:
        server._stop_thread.join(timeout=30.0)  # let the drain finish
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
