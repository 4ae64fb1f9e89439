"""Multi-replica router: prefix-affinity load balancing + health circuit.

Ports ``paddle_tpu/serving/router.py`` by copy (pure Python,
with the reference's metric names, span names, JSON fields and
routes).

The scaling layer above ``server.py``: N independent engine replicas
(each its own process or in-process server), one front door.

  * **Prefix-affinity routing** — requests whose prompts share the same
    page-aligned leading chunk rendezvous-hash to the same replica, so
    the prefix cache keeps its hit rate under multi-replica
    scale-out (a shared system prompt's KV pages stay hot on ONE
    replica instead of being rebuilt on all of them).  Prompts shorter
    than a page, or whose affinity target is down, fall back to the
    least-loaded replica.  Requests naming a LoRA adapter salt the
    rendezvous key with the adapter name, so each adapter's traffic
    concentrates where its bank row is already resident.
  * **Health probing + circuit breaking** — a prober hits each
    replica's ``/healthz``; ``fail_threshold`` consecutive failures
    open the circuit (replica leaves rotation), and the replica is
    re-admitted after ``cooldown_s`` (or immediately on a successful
    probe).  Request-level transport failures count toward the same
    circuit.
  * **Bounded retry** — a transport failure *before any response
    bytes* (connection refused/reset at send) is idempotent to retry:
    the router retries on up to ``max_retries`` other replicas.
    HTTP-level answers (429 backpressure, 400 validation) are never
    retried — the replica spoke.

Use programmatically (:meth:`Router.completion`) or as an HTTP
front-end (:meth:`Router.serve` — same wire protocol as ``server.py``,
so :class:`~paddle_tpu_torch.serving.ServingClient` points at either).
"""
from __future__ import annotations

import hashlib
import http.client
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import observability as _obs
from ..sanitizer import make_lock
from .client import ServingClient, ServingHTTPError

__all__ = ["NoReplicaAvailable", "Replica", "Router", "RouterServer"]

_M_REQS = _obs.counter(
    "router_requests_total",
    "requests routed, by replica and outcome ('ok', 'error', or "
    "'http_<status>' when the replica answered non-2xx)",
    ("replica", "outcome"))
_M_RETRIES = _obs.counter(
    "router_retries_total",
    "requests retried on another replica after an idempotent "
    "transport failure")
_M_FAILOVERS = _obs.counter(
    "router_failovers_total",
    "mid-stream failovers: a replica died after response bytes flowed "
    "and the stream was resumed on a healthy replica by re-submitting "
    "prompt + delivered tokens (idempotent requests only: greedy, or "
    "sampled with an explicit seed)")
_M_UP = _obs.gauge(
    "router_replica_up",
    "1 = replica in rotation, 0 = circuit open", ("replica",))
_M_PROBES = _obs.counter(
    "router_probes_total", "health probes", ("replica", "result"))
_M_PICKS = _obs.counter(
    "router_picks_total",
    "replica selection path: 'affinity' (prefix hash target), "
    "'least_loaded' (no page-aligned prefix, or target down)",
    ("kind",))
_M_FLEET = _obs.counter(
    "router_fleet_collections_total",
    "/debug/fleet summary fetches piggybacked on the health sweep "
    "('fail' degrades the cluster view, never the circuit)",
    ("replica", "result"))
_M_EXPECTED_HIT = _obs.gauge(
    "router_expected_prefix_hit_rate",
    "last expected-prefix-hit-rate estimate per replica: 1.0 when the "
    "prompt's root chunk digest is in the replica's published prefix "
    "digest, else the replica's observed hit rate as a prior",
    ("replica",))


class NoReplicaAvailable(RuntimeError):
    """Every replica is excluded or circuit-open."""


class Replica:
    """One backend endpoint + its circuit-breaker state."""

    def __init__(self, address):
        self.address = ServingClient(address).address   # normalized
        self.fails = 0              # consecutive probe/request failures
        self.down_until = 0.0       # monotonic; 0 = in rotation
        self.inflight = 0
        self.last_error: str | None = None
        self.stats: dict = {}       # last /healthz payload
        self.fleet: dict | None = None  # last /debug/fleet summary
        self.fleet_at = 0.0         # monotonic collection time
        _M_UP.labels(self.address).set(1)

    def available(self, now: float) -> bool:
        return now >= self.down_until

    def snapshot(self, now: float) -> dict:
        return {"address": self.address,
                "up": self.available(now),
                "fails": self.fails,
                "inflight": self.inflight,
                "cooldown_remaining_s": max(0.0, self.down_until - now),
                "last_error": self.last_error}


class Router:
    """Load balancer over N serving replicas.

    ``addresses`` are ``host:port`` strings.  ``page_size`` must match
    the replicas' engine page size — the affinity key is the prompt's
    first ``affinity_pages`` full pages, so only page-aligned sharing
    (what the prefix cache can actually reuse) influences routing.
    """

    def __init__(self, addresses, *, page_size: int = 64,
                 affinity_pages: int = 1, fail_threshold: int = 3,
                 cooldown_s: float = 2.0, max_retries: int = 1,
                 probe_interval_s: float = 1.0,
                 probe_timeout_s: float = 2.0,
                 request_timeout_s: float = 120.0,
                 clock=time.monotonic):
        if not addresses:
            raise ValueError("router needs at least one replica address")
        if fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1")
        self.replicas = [Replica(a) for a in addresses]
        self.page_size = int(page_size)
        self.affinity_pages = int(affinity_pages)
        self.fail_threshold = int(fail_threshold)
        self.cooldown_s = float(cooldown_s)
        self.max_retries = int(max_retries)
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.request_timeout_s = float(request_timeout_s)
        self._clock = clock
        self._lock = make_lock("Router._lock")
        self._probe_stop = threading.Event()
        self._probe_thread: threading.Thread | None = None
        self.failovers = 0          # mirror of router_failovers_total

    # ------------------------------------------------------- selection
    def _affinity_key(self, prompt, adapter: str | None = None) \
            -> bytes | None:
        """Rendezvous key: the prompt's page-aligned leading chunk,
        salted with the adapter name when one is set — adapter traffic
        sticks to one replica (its bank row stays loaded there), and
        two adapters over the same shared prompt can land on different
        replicas instead of thrashing one bank.  Dense requests keep
        the exact pre-LoRA key bytes."""
        ids = np.asarray(prompt, np.int32).reshape(-1)
        aligned = (ids.size // self.page_size) * self.page_size
        take = min(aligned, self.affinity_pages * self.page_size)
        chunk = ids[:take].tobytes() if take > 0 else b""
        if not chunk and adapter is None:
            return None
        tag = b"" if adapter is None else adapter.encode() + b"\x00"
        return hashlib.sha1(tag + chunk).digest()

    @staticmethod
    def _rendezvous_score(key: bytes, address: str) -> int:
        h = hashlib.sha1(key + address.encode()).digest()
        return int.from_bytes(h[:8], "big")

    @staticmethod
    def resumable(kw: dict) -> bool:
        """Whether a request may be re-dispatched after tokens flowed:
        greedy requests resume exactly (same prompt prefix -> same
        continuation); sampled requests only when the caller pinned an
        explicit seed (best effort — the replica mixes the request id
        into its RNG stream, so the resumed suffix is *a* valid sample,
        not bit-identical to the lost one)."""
        do_sample = kw.get("do_sample")
        if do_sample is None:
            do_sample = ("temperature" in kw
                         and float(kw.get("temperature") or 0.0) > 0.0)
        return (not do_sample) or (kw.get("seed") is not None)

    def pick(self, prompt, exclude=(),
             adapter: str | None = None) -> Replica:
        """Choose a replica for this prompt (and adapter, when the
        request names one).  Raises :class:`NoReplicaAvailable` when
        nothing is in rotation."""
        now = self._clock()
        with self._lock:
            avail = [r for r in self.replicas
                     if r not in exclude and r.available(now)]
            if not avail:
                raise NoReplicaAvailable(
                    "no replica available: "
                    + ", ".join(f"{r.address} "
                                f"(fails={r.fails}, "
                                f"excluded={r in exclude})"
                                for r in self.replicas))
            key = self._affinity_key(prompt, adapter)
            if key is not None:
                # rendezvous over the FULL replica set (stable as
                # replicas flap), honored only while the winner is up
                winner = max(self.replicas,
                             key=lambda r: self._rendezvous_score(
                                 key, r.address))
                if winner in avail:
                    _M_PICKS.labels("affinity").inc()
                    return winner
            chosen = min(avail, key=lambda r: (r.inflight, r.address))
            _M_PICKS.labels("least_loaded").inc()
            return chosen

    # --------------------------------------------------------- circuit
    def _mark_success(self, rep: Replica):
        with self._lock:
            rep.fails = 0
            rep.down_until = 0.0
            rep.last_error = None
        _M_UP.labels(rep.address).set(1)

    def _mark_failure(self, rep: Replica, err: BaseException):
        with self._lock:
            rep.fails += 1
            rep.last_error = repr(err)
            if rep.fails >= self.fail_threshold:
                rep.down_until = self._clock() + self.cooldown_s
                opened = True
            else:
                opened = False
        if opened:
            _M_UP.labels(rep.address).set(0)

    # --------------------------------------------------------- probing
    def probe_once(self):
        """One health sweep over every replica (the prober thread calls
        this every ``probe_interval_s``; tests call it directly).  Each
        healthy probe also piggybacks a ``/debug/fleet`` summary fetch
        on the same sweep — the replica just answered /healthz, so a
        fleet failure (e.g. an older build without the route) only
        degrades the cluster view, never the circuit."""
        for rep in self.replicas:
            client = ServingClient(rep.address,
                                   timeout=self.probe_timeout_s)
            try:
                st = client.healthz()
                rep.stats = st
                self._mark_success(rep)
                _M_PROBES.labels(rep.address, "ok").inc()
            except Exception as e:      # refused, reset, timeout, 5xx
                self._mark_failure(rep, e)
                _M_PROBES.labels(rep.address, "fail").inc()
                rep.fleet = None        # stale census must not linger
                continue
            try:
                rep.fleet = client.request("GET", "/debug/fleet")
                rep.fleet_at = self._clock()
                _M_FLEET.labels(rep.address, "ok").inc()
            except Exception:
                rep.fleet = None
                _M_FLEET.labels(rep.address, "fail").inc()

    def start_probing(self) -> "Router":
        if self._probe_thread is None:
            def loop():
                while not self._probe_stop.wait(self.probe_interval_s):
                    self.probe_once()
            self._probe_thread = threading.Thread(
                target=loop, name="router-prober", daemon=True)
            self._probe_thread.start()
        return self

    def stop(self):
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5.0)
            self._probe_thread = None

    # ------------------------------------------------------ completion
    def completion(self, prompt, *, stream: bool = False, **kw):
        """Route one completion.  Transport failures before any
        response bytes retry on up to ``max_retries`` other replicas;
        HTTP answers (429/503/400...) propagate as ServingHTTPError.

        Opens a ``router.request`` span covering pick + retry; the
        :class:`ServingClient` call inside nests under it (contextvar)
        and carries the trace to the replica as a traceparent header."""
        with _obs.tracer().start_span(
                "router.request",
                attributes={"stream": bool(stream)}) as span:
            return self._completion_traced(span, prompt, stream=stream,
                                           **kw)

    def _completion_traced(self, span, prompt, *, stream, **kw):
        tried: list[Replica] = []
        last_exc: BaseException | None = None
        adapter = kw.get("adapter")
        for attempt in range(self.max_retries + 1):
            try:
                rep = self.pick(prompt, exclude=tried, adapter=adapter)
            except NoReplicaAvailable:
                if last_exc is None:
                    raise
                raise NoReplicaAvailable(
                    "all retry candidates failed "
                    f"(last: {last_exc!r})") from last_exc
            span.set_attribute("replica", rep.address)
            span.set_attribute("attempts", attempt + 1)
            client = ServingClient(rep.address,
                                   timeout=self.request_timeout_s)
            with self._lock:
                rep.inflight += 1
            try:
                if stream:
                    # connection + status check happen before the
                    # generator is returned, so a refused/reset replica
                    # still lands in the retry path below
                    events = client.completion(prompt, stream=True, **kw)
                    return self._stream_through(rep, events,
                                                prompt=prompt, kw=kw,
                                                tried=tried)
                out = client.completion(prompt, **kw)
            except ServingHTTPError as e:
                # the replica ANSWERED — it is alive; never retried
                with self._lock:
                    rep.inflight -= 1
                self._mark_success(rep)
                _M_REQS.labels(rep.address, f"http_{e.status}").inc()
                raise
            except OSError as e:
                with self._lock:
                    rep.inflight -= 1
                self._mark_failure(rep, e)
                _M_REQS.labels(rep.address, "error").inc()
                tried.append(rep)
                last_exc = e
                if attempt < self.max_retries:
                    _M_RETRIES.inc()
                    span.add_event("retry", replica=rep.address,
                                   error=repr(e))
                continue
            with self._lock:
                rep.inflight -= 1
            self._mark_success(rep)
            _M_REQS.labels(rep.address, "ok").inc()
            return out
        raise NoReplicaAvailable(
            f"request failed on {len(tried)} replica(s) "
            f"(last: {last_exc!r})") from last_exc

    def _stream_through(self, rep: Replica, events, *, prompt=None,
                        kw=None, tried=None):
        """Wrap a replica's SSE stream: success/failure feeds the
        circuit, inflight releases when the stream ends.

        Mid-stream death of the replica — a transport error, or the
        stream ending before the final (finish_reason-bearing) chunk —
        **fails over** when the request is :meth:`resumable`: the
        router re-submits ``prompt + delivered tokens`` (with
        ``max_tokens`` reduced accordingly) to a healthy replica and
        keeps yielding, so the consumer sees one complete token
        sequence.  Non-resumable streams keep the old semantics: the
        error (or truncation) surfaces to the caller."""
        kw = dict(kw or {})
        can_resume = prompt is not None and self.resumable(kw)
        max_tokens = int(kw.get("max_tokens", 16))
        tried = list(tried or [])

        def gen():
            cur_rep, cur_events = rep, events
            delivered: list[int] = []
            failovers_left = self.max_retries
            while True:
                finished = False
                err: BaseException | None = None
                try:
                    try:
                        for ev in cur_events:
                            ch = ev["choices"][0]
                            delivered.extend(
                                int(t) for t in (ch.get("token_ids")
                                                 or ()))
                            if ch.get("finish_reason") is not None:
                                finished = True
                            yield ev
                    except OSError as e:
                        err = e
                except BaseException:
                    # GeneratorExit (consumer closed the stream) or an
                    # error thrown in: release inflight and propagate
                    with self._lock:
                        cur_rep.inflight -= 1
                    raise
                with self._lock:
                    cur_rep.inflight -= 1
                if err is None and finished:
                    self._mark_success(cur_rep)
                    _M_REQS.labels(cur_rep.address, "ok").inc()
                    return
                # the replica died mid-stream (transport error, or EOF
                # before the final chunk — a hangup surfaces as a clean
                # close on the client side)
                if err is None:
                    err = ConnectionError(
                        "stream ended before the final chunk")
                self._mark_failure(cur_rep, err)
                _M_REQS.labels(cur_rep.address, "error").inc()
                tried.append(cur_rep)
                if not can_resume or failovers_left <= 0:
                    raise err
                remaining = max_tokens - len(delivered)
                if remaining <= 0:
                    return      # every token was already delivered
                resume_prompt = [int(t) for t in prompt] + delivered
                resume_kw = dict(kw, max_tokens=remaining,
                                 resume_from=len(delivered))
                switched = False
                while failovers_left > 0 and not switched:
                    failovers_left -= 1
                    try:
                        nxt = self.pick(resume_prompt, exclude=tried,
                                        adapter=kw.get("adapter"))
                    except NoReplicaAvailable:
                        break
                    client = ServingClient(
                        nxt.address, timeout=self.request_timeout_s)
                    with self._lock:
                        nxt.inflight += 1
                    try:
                        cur_events = client.completion(resume_prompt,
                                                       stream=True,
                                                       **resume_kw)
                    except (OSError, ServingHTTPError) as e:
                        with self._lock:
                            nxt.inflight -= 1
                        self._mark_failure(nxt, e)
                        _M_REQS.labels(nxt.address, "error").inc()
                        tried.append(nxt)
                        continue
                    switched = True
                if not switched:
                    raise err
                with self._lock:
                    self.failovers += 1
                _M_FAILOVERS.inc()
                _obs.flight("router", "failover",
                            from_=cur_rep.address, to=nxt.address,
                            delivered=len(delivered),
                            remaining=remaining)
                cur_rep = nxt
        return gen()

    # ------------------------------------------------------- fleet view
    def _root_chunk_digest(self, prompt) -> str | None:
        """sha1 (16 hex chars) of the prompt's first full page chunk —
        the exact hash replicas publish for their root-level cached
        chunks (BlockManager.prefix_digest), so digest equality means
        the replica already holds this prompt's leading KV pages."""
        ids = np.asarray(prompt, np.int32).reshape(-1)
        if ids.size < self.page_size:
            return None
        return hashlib.sha1(
            ids[:self.page_size].tobytes()).hexdigest()[:16]

    def prefix_hit_estimate(self, prompt,
                            adapter: str | None = None) -> dict:
        """Per-replica expected-hit-rate estimate for a prompt: 1.0
        when the prompt's root chunk digest appears in the replica's
        published prefix digest, else the replica's observed hit rate
        as a prior (0.0 with no summary).  When the request names an
        ``adapter``, the estimate blends in adapter-bank residency
        (the replica's fleet summary publishes its resident adapter
        names): a replica that would have to LRU-load the adapter
        before serving averages its prefix estimate with 0.  This is
        the routing signal cluster-scale KV scheduling consumes;
        estimates are also recorded on
        ``router_expected_prefix_hit_rate{replica}``."""
        digest = self._root_chunk_digest(prompt)
        out = {}
        for rep in self.replicas:
            prefix = (rep.fleet or {}).get("prefix") or {}
            published = (prefix.get("roots") or []
                         if prefix.get("page_size") == self.page_size
                         else [])
            if digest is not None and digest in published:
                est = 1.0
            else:
                est = float(prefix.get("hit_rate") or 0.0)
            if adapter is not None:
                resident = ((rep.fleet or {}).get("adapters")
                            or {}).get("resident") or []
                est = (est + (1.0 if adapter in resident else 0.0)) / 2.0
            out[rep.address] = round(est, 6)
            _M_EXPECTED_HIT.labels(rep.address).set(est)
        return out

    def fleet(self) -> dict:
        """Aggregate cluster view over the last collected per-replica
        summaries — served by the router's own ``GET /debug/fleet``."""
        now = self._clock()
        replicas, alerts = {}, []
        pages = {"total": 0, "live": 0, "cached": 0, "free": 0}
        slots = {"active": 0, "max": 0, "free": 0}
        queue_depth, burn_max, summaries = 0, 0.0, 0
        digests: set = set()
        for rep in self.replicas:
            entry = rep.snapshot(now)
            fl = rep.fleet
            if fl:
                summaries += 1
                entry["summary"] = fl
                entry["summary_age_s"] = round(
                    max(0.0, now - rep.fleet_at), 3)
                pool = fl.get("pool") or {}
                for k in pages:
                    pages[k] += int(pool.get(k) or 0)
                for k in slots:
                    slots[k] += int((fl.get("slots") or {}).get(k) or 0)
                queue_depth += int((fl.get("queue") or {}).get("depth")
                                   or 0)
                burn_max = max(burn_max, float(
                    (fl.get("slo") or {}).get("max_burn_rate") or 0.0))
                for a in (fl.get("alerts") or {}).get("firing") or []:
                    alerts.append({"replica": rep.address, **a})
                prefix = fl.get("prefix") or {}
                digests.update(prefix.get("roots") or [])
                entry["expected_prefix_hit_rate"] = prefix.get(
                    "hit_rate")
            replicas[rep.address] = entry
        with self._lock:
            failovers = self.failovers
        return {"kind": "router", "replicas": replicas,
                "failovers": failovers,
                "cluster": {
                    "replicas": len(self.replicas),
                    "up": sum(1 for r in replicas.values() if r["up"]),
                    "summaries": summaries,
                    "pages": pages, "slots": slots,
                    "queue_depth": queue_depth,
                    "max_burn_rate": round(burn_max, 6),
                    "alerts_firing": alerts,
                    "prefix_digests": len(digests)}}

    def usage(self) -> dict:
        """Merged per-tenant usage table across the replicas' last
        collected fleet summaries — raw-merge discipline (counters
        sum, never averaged), the same rule as the latency-bucket
        merge.  A probe failure nulls the dead replica's summary, so
        a stale table never double-counts into the cluster view."""
        merged = _obs.merge_usage(
            (rep.fleet or {}).get("usage") for rep in self.replicas)
        merged["kind"] = "router"
        return merged

    # ------------------------------------------------------------ info
    def stats(self) -> dict:
        now = self._clock()
        reps = [r.snapshot(now) for r in self.replicas]
        with self._lock:
            failovers = self.failovers
        return {"replicas": reps,
                "up": sum(1 for r in reps if r["up"]),
                "total": len(reps),
                "failovers": failovers}

    def serve(self, host: str = "127.0.0.1", port: int = 0,
              start: bool = True) -> "RouterServer":
        server = RouterServer(self, host, port)
        if start:
            self.start_probing()
            server.start()
        return server


# ------------------------------------------------------------ HTTP proxy
class RouterServer(ThreadingHTTPServer):
    """HTTP front-end over a :class:`Router` — the same wire protocol
    as ``server.py``, so clients cannot tell a router from a replica:
    ``POST /v1/completions`` proxies to the picked replica (SSE relayed
    chunk-by-chunk, so a client disconnect at the router propagates to
    the replica as a cancel), ``/drain``/``/resume`` broadcast to every
    replica, ``/healthz`` reports per-replica circuit state."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 0):
        self.router = router
        self._serve_thread: threading.Thread | None = None
        super().__init__((host, port), _RouterHandler)

    @property
    def address(self) -> str:
        return f"{self.server_address[0]}:{self.server_address[1]}"

    def start(self) -> "RouterServer":
        self._serve_thread = threading.Thread(
            target=self.serve_forever, name=f"router:{self.address}",
            daemon=True)
        self._serve_thread.start()
        return self

    def stop(self):
        self.router.stop()
        self.shutdown()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5.0)
        self.server_close()


_ROUTER_DEBUG_INDEX = {
    "/debug/": "this index",
    "/debug/trace": "chrome-trace spans + counter tracks for the "
                    "router process",
    "/debug/fleet": "aggregate cluster view: per-replica summaries, "
                    "pooled page/slot/queue census, max SLO burn "
                    "rate, firing alerts",
    "/debug/profile": "fan out ?seconds=N to every replica and "
                      "aggregate the phase-attributed profile "
                      "snapshots per replica",
    "/debug/captures": "fan out to every replica and aggregate the "
                       "diagnostic-capture indexes per replica",
    "/debug/usage": "per-tenant usage table raw-merged across the "
                    "replicas' last collected summaries",
    "/debug/exemplars": "worst-K SLO-violation exemplars raw-merged "
                        "(worst-first re-rank, counters sum) across "
                        "every replica's bounded exemplar store",
    "/debug/requests/<id>": "per-request lifecycle waterfall fanned "
                            "out to every replica (the one that "
                            "served the request answers); "
                            "?format=chrome returns the found trace "
                            "verbatim for chrome://tracing",
}


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: RouterServer

    def log_message(self, fmt, *args):
        pass

    def _json(self, code: int, obj: dict, headers=()):
        body = json.dumps(obj).encode()
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

    def do_GET(self):
        router = self.server.router
        if self.path == "/healthz":
            st = router.stats()
            st["status"] = "ok" if st["up"] else "unavailable"
            self._json(200 if st["up"] else 503, st)
        elif self.path == "/metrics":
            text = _obs.default_registry().to_prometheus().encode()
            try:
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(text)))
                self.end_headers()
                self.wfile.write(text)
            except (BrokenPipeError, ConnectionResetError):
                pass
        elif self.path == "/debug/trace":
            self._json(200, {"traceEvents":
                             (_obs.tracer().chrome_events()
                              + _obs.chrome_counter_events())})
        elif self.path == "/debug/fleet":
            self._json(200, router.fleet())
        elif self.path.split("?", 1)[0] == "/debug/profile":
            self._fanout_profile()
        elif self.path.split("?", 1)[0] == "/debug/captures":
            self._json(200, {"kind": "router",
                             "replicas": self._fanout_get(
                                 "/debug/captures")})
        elif self.path == "/debug/usage":
            self._json(200, router.usage())
        elif self.path == "/debug/exemplars":
            self._merged_exemplars()
        elif self.path.split("?", 1)[0].startswith("/debug/requests/"):
            self._fanout_request()
        elif self.path in ("/debug", "/debug/"):
            self._json(200, {"endpoints": _ROUTER_DEBUG_INDEX})
        else:
            self._json(404, {"error": {"message": f"no route {self.path}",
                                       "code": 404}})

    def _fanout_get(self, path: str, timeout: float | None = None):
        """GET ``path`` on every replica, one entry per replica
        address; a failing replica degrades to an error record, same
        shape as the POST broadcast."""
        router = self.server.router
        results = {}
        for rep in router.replicas:
            try:
                results[rep.address] = ServingClient(
                    rep.address,
                    timeout=timeout or router.request_timeout_s
                ).request("GET", path)
            except Exception as e:
                results[rep.address] = {"error": repr(e)}
        return results

    def _merged_exemplars(self):
        """Fan ``/debug/exemplars`` out to every replica and raw-merge
        the worst-K tables: concatenate, re-rank worst-first, sum the
        offered/kept counters — never average (the usage-merge rule).
        A dead or forensics-off replica degrades to an error record in
        ``replicas`` and is skipped by the merge, so a stale table
        never pollutes the cluster view."""
        from ..observability.requestlog import merge_exemplars
        results = self._fanout_get("/debug/exemplars")
        merged = merge_exemplars(
            r.get("exemplars") if isinstance(r, dict) else None
            for r in results.values())
        self._json(200, {"kind": "router", "replicas": results,
                         "merged": merged})

    def _fanout_request(self):
        """Forward ``/debug/requests/<id>`` (query string included) to
        every replica.  Exactly one replica served the request, so at
        most one answers with a timeline; the rest 404 into error
        records.  JSON asks get the found waterfall plus the
        per-replica map; ``?format=chrome`` relays the found trace
        verbatim so the payload loads straight into chrome://tracing."""
        from urllib.parse import parse_qs, urlparse
        results = self._fanout_get(self.path)
        found = next((r for r in results.values()
                      if isinstance(r, dict) and "error" not in r), None)
        fmt = parse_qs(urlparse(self.path).query).get(
            "format", ["json"])[0]
        if fmt == "chrome":
            if found is None:
                self._json(404, {"error": {
                    "message": "no replica holds a timeline for "
                               + self.path.split("?", 1)[0],
                    "code": 404}})
                return
            self._json(200, found)
            return
        self._json(200 if found is not None else 404,
                   {"kind": "router", "found": found,
                    "replicas": results})

    def _fanout_profile(self):
        """``GET /debug/profile?seconds=N``: each replica blocks for
        the whole N-second window, so the fan-out runs on one thread
        per replica and joins — every replica samples the SAME window
        and the router handler's wall time stays ~N, not N x fleet."""
        from urllib.parse import parse_qs, urlparse
        q = parse_qs(urlparse(self.path).query)
        try:
            seconds = float(q.get("seconds", ["1.0"])[0])
        except ValueError:
            self._json(400, {"error": {"message":
                                       "seconds must be a number",
                                       "code": 400}})
            return
        router = self.server.router
        path = (f"/debug/profile?seconds={seconds:g}&format=json")
        timeout = max(router.request_timeout_s, seconds + 10.0)
        results = {}

        def one(rep):
            try:
                results[rep.address] = ServingClient(
                    rep.address, timeout=timeout).request("GET", path)
            except Exception as e:
                results[rep.address] = {"error": repr(e)}

        threads = [threading.Thread(target=one, args=(rep,),
                                    daemon=True)
                   for rep in router.replicas]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout + 5.0)
        self._json(200, {"kind": "router", "seconds": seconds,
                         "replicas": results})

    def do_POST(self):
        if self.path == "/v1/completions":
            self._proxy_completion()
        elif self.path in ("/drain", "/resume"):
            self._broadcast(self.path)
        else:
            self._json(404, {"error": {"message": f"no route {self.path}",
                                       "code": 404}})

    def _broadcast(self, path: str):
        results = {}
        for rep in self.server.router.replicas:
            try:
                results[rep.address] = ServingClient(
                    rep.address,
                    timeout=self.server.router.request_timeout_s
                ).request("POST", path, {})
            except Exception as e:
                results[rep.address] = {"error": repr(e)}
        self._json(200, {"replicas": results})

    def _proxy_completion(self):
        # join the client's trace (or start one) and hand OUR span id
        # downstream: client -> router -> replica becomes one trace
        parent = _obs.parse_traceparent(self.headers.get("traceparent"))
        span = _obs.tracer().start_span(
            "router.request", parent=parent,
            attributes={"proxy": True, "remote": parent is not None})
        with span:
            self._proxy_completion_traced(span)

    def _proxy_completion_traced(self, span):
        router = self.server.router
        try:
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n > 0 else b"{}"
            body = json.loads(raw.decode() or "{}")
            prompt = body.get("prompt")
            if prompt is None or isinstance(prompt, str):
                raise ValueError("'prompt' must be a list of token ids")
        except (ValueError, json.JSONDecodeError) as e:
            span.set_attribute("status", 400)
            return self._json(400, {"error": {"message": str(e),
                                              "code": 400}})

        upstream_headers = {
            "Content-Type": "application/json",
            "traceparent": _obs.format_traceparent(span.context)}
        # gateway tags ride through to the replica (priority class,
        # usage-meter billing tenant, LoRA adapter selection)
        for key in ("X-Priority", "X-Tenant", "X-Adapter"):
            if self.headers.get(key):
                upstream_headers[key] = self.headers[key]
        # the adapter influences routing too (affinity-keyed so a
        # tenant's adapter stays loaded on one replica); header wins
        # over the body field, matching the replica's precedence
        adapter = (self.headers.get("X-Adapter") or "").strip() \
            or (str(body.get("adapter")).strip()
                if body.get("adapter") else None) or None
        tried: list[Replica] = []
        last_exc: BaseException | None = None
        for attempt in range(router.max_retries + 1):
            try:
                rep = router.pick(prompt, exclude=tried, adapter=adapter)
            except NoReplicaAvailable as e:
                span.set_attribute("status", 503)
                return self._json(
                    503, {"error": {"message": str(last_exc or e),
                                    "type": "overloaded_error",
                                    "code": 503}},
                    headers=[("Retry-After", f"{router.cooldown_s:g}")])
            span.set_attribute("replica", rep.address)
            span.set_attribute("attempts", attempt + 1)
            host, _, port = rep.address.rpartition(":")
            conn = http.client.HTTPConnection(
                host, int(port), timeout=router.request_timeout_s)
            with router._lock:
                rep.inflight += 1
            try:
                conn.request("POST", "/v1/completions", raw,
                             upstream_headers)
                resp = conn.getresponse()
            except OSError as e:
                conn.close()
                with router._lock:
                    rep.inflight -= 1
                router._mark_failure(rep, e)
                _M_REQS.labels(rep.address, "error").inc()
                tried.append(rep)
                last_exc = e
                if attempt < router.max_retries:
                    _M_RETRIES.inc()
                    span.add_event("retry", replica=rep.address,
                                   error=repr(e))
                continue
            try:
                span.set_attribute("status", resp.status)
                self._relay(rep, resp, body=body, tried=tried + [rep],
                            headers=upstream_headers)
            finally:
                conn.close()
                with router._lock:
                    rep.inflight -= 1
            return
        span.set_attribute("status", 503)
        self._json(503, {"error": {"message": f"request failed on "
                                              f"{len(tried)} replica(s) "
                                              f"(last: {last_exc!r})",
                                   "type": "overloaded_error",
                                   "code": 503}},
                   headers=[("Retry-After", f"{router.cooldown_s:g}")])

    def _relay(self, rep: Replica, resp, *, body=None, tried=None,
               headers=None):
        """Stream the replica's response back verbatim.  Closing the
        upstream connection on OUR client's disconnect is what turns a
        router-side hangup into a replica-side cancel.

        When the UPSTREAM dies mid-SSE (read error, or EOF before
        ``[DONE]``) and the request is :meth:`Router.resumable`, the
        relay fails over: it re-POSTs ``prompt + delivered tokens`` to
        a healthy replica and keeps relaying that stream, so the
        downstream client receives one complete token sequence."""
        router = self.server.router
        streaming = "text/event-stream" in (
            resp.headers.get("Content-Type") or "")
        try:
            self.send_response(resp.status)
            for key in ("Content-Type", "Retry-After"):
                if resp.headers.get(key):
                    self.send_header(key, resp.headers[key])
            if streaming:
                self.send_header("Connection", "close")
                self.close_connection = True
                self.end_headers()
            else:
                payload = resp.read()
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
        except (BrokenPipeError, ConnectionResetError,
                ConnectionAbortedError):
            _M_REQS.labels(rep.address, "client_cancelled").inc()
            return
        if not streaming:
            router._mark_success(rep)
            outcome = "ok" if 200 <= resp.status < 300 \
                else f"http_{resp.status}"
            _M_REQS.labels(rep.address, outcome).inc()
            return
        self._relay_stream(rep, resp, body=body, tried=tried,
                           headers=headers)

    def _relay_stream(self, rep: Replica, resp, *, body, tried, headers):
        router = self.server.router
        body = body or {}
        can_resume = bool(body.get("prompt")) and router.resumable(body)
        max_tokens = int(body.get("max_tokens", 16))
        prompt = [int(t) for t in (body.get("prompt") or [])]
        delivered: list[int] = []
        tried = list(tried or [])
        failovers_left = router.max_retries
        cur_rep, cur_resp = rep, resp
        extra_conns: list = []      # failover connections we opened
        extra_reps: list = []       # ... and their inflight holds
        try:
            while True:
                done = False
                upstream_err: BaseException | None = None
                while True:
                    try:
                        line = cur_resp.readline()
                    except (OSError, http.client.HTTPException) as e:
                        upstream_err = e
                        break
                    if not line:
                        break           # upstream closed
                    s = line.strip()
                    if s.startswith(b"data:"):
                        data = s[len(b"data:"):].strip()
                        if data == b"[DONE]":
                            done = True
                        else:
                            try:
                                ev = json.loads(data.decode())
                                ch = ev["choices"][0]
                                delivered.extend(
                                    int(t) for t in (ch.get("token_ids")
                                                     or ()))
                            except (ValueError, KeyError, TypeError,
                                    IndexError):
                                pass
                    try:
                        self.wfile.write(line)
                        if line == b"\n":
                            self.wfile.flush()
                    except (OSError, ValueError):
                        # OUR client went away: stop, upstream conn
                        # close (in the caller) cancels the replica side
                        _M_REQS.labels(cur_rep.address,
                                       "client_cancelled").inc()
                        return
                    if done:
                        break
                if done and upstream_err is None:
                    router._mark_success(cur_rep)
                    _M_REQS.labels(cur_rep.address, "ok").inc()
                    return
                # upstream died mid-stream
                if not can_resume or failovers_left <= 0:
                    # cannot resume: keep the pre-failover behavior —
                    # the truncated stream simply ends (transport
                    # errors still feed the circuit)
                    if upstream_err is not None:
                        router._mark_failure(cur_rep, upstream_err)
                        _M_REQS.labels(cur_rep.address, "error").inc()
                    else:
                        router._mark_success(cur_rep)
                        _M_REQS.labels(cur_rep.address, "ok").inc()
                    return
                err = upstream_err or ConnectionError(
                    "upstream stream ended before [DONE]")
                router._mark_failure(cur_rep, err)
                _M_REQS.labels(cur_rep.address, "error").inc()
                tried.append(cur_rep)
                remaining = max_tokens - len(delivered)
                if remaining <= 0:
                    # every token made it out; synthesize the final
                    # frame the dead replica never sent
                    self._finish_stream()
                    return
                resume = dict(body, prompt=prompt + delivered,
                              max_tokens=remaining,
                              resume_from=len(delivered))
                raw = json.dumps(resume).encode()
                switched = False
                while failovers_left > 0 and not switched:
                    failovers_left -= 1
                    try:
                        nxt = router.pick(resume["prompt"],
                                          exclude=tried,
                                          adapter=resume.get("adapter"))
                    except NoReplicaAvailable:
                        break
                    host, _, port = nxt.address.rpartition(":")
                    conn = http.client.HTTPConnection(
                        host, int(port),
                        timeout=router.request_timeout_s)
                    with router._lock:
                        nxt.inflight += 1
                    extra_conns.append(conn)
                    extra_reps.append(nxt)
                    try:
                        conn.request("POST", "/v1/completions", raw,
                                     headers or {"Content-Type":
                                                 "application/json"})
                        r2 = conn.getresponse()
                    except OSError as e:
                        router._mark_failure(nxt, e)
                        _M_REQS.labels(nxt.address, "error").inc()
                        tried.append(nxt)
                        continue
                    if r2.status != 200 or "text/event-stream" not in (
                            r2.headers.get("Content-Type") or ""):
                        # the replica answered (alive) but refused the
                        # resume — give up, the stream stays truncated
                        _M_REQS.labels(
                            nxt.address, f"http_{r2.status}").inc()
                        return
                    switched = True
                if not switched:
                    return              # truncated — nothing healthy
                with router._lock:
                    router.failovers += 1
                _M_FAILOVERS.inc()
                _obs.flight("router", "failover",
                            from_=cur_rep.address, to=nxt.address,
                            delivered=len(delivered),
                            remaining=remaining)
                cur_rep, cur_resp = nxt, r2
        finally:
            for conn in extra_conns:
                try:
                    conn.close()
                except OSError:
                    pass
            with router._lock:
                for r in extra_reps:
                    r.inflight -= 1

    def _finish_stream(self):
        """Synthesized stream tail: the dead replica delivered every
        token but not the final frame."""
        final = {"object": "text_completion.chunk",
                 "choices": [{"index": 0, "text": "", "token_ids": [],
                              "finish_reason": "length"}]}
        try:
            self.wfile.write(b"data: " + json.dumps(final).encode()
                             + b"\n\ndata: [DONE]\n\n")
            self.wfile.flush()
        except (OSError, ValueError):
            pass
