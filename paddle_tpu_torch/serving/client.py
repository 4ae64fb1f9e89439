"""Blocking/streaming HTTP client for the serving front-end.

Ports ``paddle_tpu/serving/client.py`` by copy (pure Python,
with the reference's metric names, span names, JSON fields and
routes).

Stdlib-only (``http.client``) counterpart of ``server.py``'s wire
protocol, used by tests, ``chip_smoke.py``'s HTTP phases, and the
router's programmatic path::

    client = ServingClient("127.0.0.1:8000")
    out = client.completion([1, 2, 3], max_tokens=8)
    out["choices"][0]["token_ids"]

    for ev in client.completion([1, 2, 3], max_tokens=8, stream=True):
        ev["choices"][0]["token_ids"]   # one token per SSE event

Transport failures (connection refused/reset before a response) raise
``OSError`` subclasses — the router retries those on another replica.
An HTTP-level error (429 backpressure, 503 draining, 400 validation)
raises :class:`ServingHTTPError` carrying status, parsed body, and any
``Retry-After`` — the replica answered, so the router does NOT retry.

With ``retries > 0`` the client itself retries **429/503** answers
(backpressure / draining / SLO shedding — the retryable overload
family) with jittered exponential backoff, honoring the server's
``Retry-After`` as a lower bound on each sleep.  Attempts are bounded
and each attempt keeps the per-request ``timeout``; the default
``retries=0`` preserves fail-fast semantics for the router, which does
its own replica-level retrying.
"""
from __future__ import annotations

import http.client
import json
import random
import time

from ..observability import tracing as _tracing

__all__ = ["ServingClient", "ServingHTTPError"]


class ServingHTTPError(Exception):
    """Non-2xx HTTP response from a serving endpoint."""

    def __init__(self, status: int, body, retry_after: float | None = None):
        self.status = int(status)
        self.body = body
        self.retry_after = retry_after
        msg = body
        if isinstance(body, dict):
            msg = (body.get("error") or {}).get("message", body)
        super().__init__(f"HTTP {status}: {msg}")


def _parse_address(address) -> tuple[str, int]:
    if isinstance(address, (tuple, list)):
        return str(address[0]), int(address[1])
    addr = str(address)
    for scheme in ("http://", "https://"):
        if addr.startswith(scheme):
            addr = addr[len(scheme):]
    addr = addr.rstrip("/")
    host, _, port = addr.rpartition(":")
    if not host:
        raise ValueError(f"address must be host:port, got {address!r}")
    return host, int(port)


_RETRYABLE = (429, 503)         # backpressure / draining / shedding


class ServingClient:
    """One serving endpoint (a replica, or a router front-end).

    ``retries`` bounds how many times a 429/503 answer is retried
    (0 = fail fast); sleeps grow as jittered exponential backoff from
    ``backoff_s`` capped at ``backoff_max_s``, never below the server's
    ``Retry-After``.  ``rng`` pins the jitter for deterministic tests.
    """

    def __init__(self, address, timeout: float = 60.0, *,
                 retries: int = 0, backoff_s: float = 0.05,
                 backoff_max_s: float = 2.0, rng=None):
        self.host, self.port = _parse_address(address)
        self.address = f"{self.host}:{self.port}"
        self.timeout = float(timeout)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self._rng = rng if rng is not None else random.Random()

    def _connect(self) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)

    # --------------------------------------------------------- backoff
    def _retry_delay(self, attempt: int,
                     retry_after: float | None) -> float:
        """Jittered exponential backoff (50-100% of the exponential
        step), floored at the server's Retry-After when it sent one."""
        base = min(self.backoff_max_s, self.backoff_s * (2 ** attempt))
        delay = base * (0.5 + 0.5 * self._rng.random())
        if retry_after:
            delay = max(delay, float(retry_after))
        return delay

    def _with_retries(self, fn):
        """Run ``fn()`` with the 429/503 retry policy.  Each attempt is
        a fresh connection with the full per-attempt timeout; transport
        errors are never retried here (the router owns those)."""
        attempt = 0
        while True:
            try:
                return fn()
            except ServingHTTPError as e:
                if e.status not in _RETRYABLE or attempt >= self.retries:
                    raise
                time.sleep(self._retry_delay(attempt, e.retry_after))
                attempt += 1

    # ------------------------------------------------------ plain JSON
    def request(self, method: str, path: str, body: dict | None = None,
                headers: dict | None = None):
        """One JSON round trip; raises ServingHTTPError on non-2xx
        (retrying 429/503 first when ``retries > 0``)."""
        return self._with_retries(
            lambda: self._request_once(method, path, body, headers))

    def _request_once(self, method: str, path: str,
                      body: dict | None = None,
                      headers: dict | None = None):
        conn = self._connect()
        try:
            payload = None if body is None else json.dumps(body).encode()
            hdrs = {"Content-Type": "application/json"}
            if headers:
                hdrs.update(headers)
            conn.request(method, path, body=payload, headers=hdrs)
            resp = conn.getresponse()
            raw = resp.read()
            return self._decode(resp, raw)
        finally:
            conn.close()

    @staticmethod
    def _decode(resp, raw: bytes):
        try:
            parsed = json.loads(raw.decode() or "null")
        except (ValueError, UnicodeDecodeError):
            parsed = raw.decode(errors="replace")
        if not 200 <= resp.status < 300:
            ra = resp.headers.get("Retry-After")
            raise ServingHTTPError(resp.status, parsed,
                                   retry_after=float(ra) if ra else None)
        return parsed

    # ----------------------------------------------------- completions
    def completion(self, prompt, *, max_tokens: int = 16,
                   stream: bool = False, timeout: float | None = None,
                   tenant: str | None = None,
                   adapter: str | None = None, **gen_kw):
        """POST /v1/completions.  Blocking: the parsed response dict.
        ``stream=True``: a generator of parsed SSE events (one token
        per event; closing the generator drops the connection, which
        cancels the request server-side).  ``tenant`` tags the request
        for the server's usage meter (body field; the X-Tenant header
        overrides it at the server).  ``adapter`` selects a registered
        LoRA adapter by name (body field; X-Adapter overrides)."""
        body = {"prompt": [int(t) for t in prompt],
                "max_tokens": int(max_tokens), "stream": bool(stream)}
        if timeout is not None:
            body["timeout"] = float(timeout)
        if tenant is not None:
            body["tenant"] = str(tenant)
        if adapter is not None:
            body["adapter"] = str(adapter)
        body.update(gen_kw)
        # every completion opens a "client.completion" span (nesting
        # under the caller's current span, e.g. router.request) and
        # carries its context to the server as a traceparent header —
        # the client end of the distributed trace
        span = _tracing.tracer().start_span(
            "client.completion",
            attributes={"address": self.address, "stream": bool(stream)})
        try:
            hdrs = {_tracing.TRACEPARENT_HEADER:
                    _tracing.format_traceparent(span.context)}
        except BaseException:
            span.end()
            raise
        if not stream:
            try:
                return self.request("POST", "/v1/completions", body,
                                    headers=hdrs)
            finally:
                span.end()
        try:
            # the retry policy covers the connect + status check (a 429
            # raises before any event flows); once streaming, failures
            # are mid-stream and no longer retryable here
            return self._with_retries(
                lambda: self._stream_completion(body, hdrs, span))
        except BaseException:
            span.end()
            raise

    def _stream_completion(self, body: dict, headers: dict, span=None):
        conn = self._connect()
        try:
            hdrs = {"Content-Type": "application/json"}
            hdrs.update(headers)
            conn.request("POST", "/v1/completions",
                         body=json.dumps(body).encode(), headers=hdrs)
            resp = conn.getresponse()
            if resp.status != 200:
                self._decode(resp, resp.read())     # raises
        except BaseException:
            conn.close()
            raise
        return self._iter_sse(conn, resp, span)

    @staticmethod
    def _iter_sse(conn, resp, span=None):
        n = 0
        try:
            while True:
                line = resp.readline()
                if not line:            # server closed the stream
                    return
                line = line.strip()
                if not line.startswith(b"data:"):
                    continue
                data = line[len(b"data:"):].strip()
                if data == b"[DONE]":
                    return
                n += 1
                yield json.loads(data.decode())
        finally:
            conn.close()
            if span is not None:        # span covers the full stream
                span.set_attribute("events", n)
                span.end()

    def completion_tokens(self, prompt, **kw) -> list[int]:
        """Blocking completion, returning just the generated token ids."""
        out = self.completion(prompt, **kw)
        return list(out["choices"][0]["token_ids"])

    # ---------------------------------------------------------- batches
    def submit_batch(self, *, records=None, input_path: str | None = None,
                     **kw) -> dict:
        """``POST /v1/batches``: start an offline batch job from inline
        ``records`` or a server-side ``input_path`` JSONL file.  ``kw``
        passes through (window / max_tokens / tenant / adapter /
        output_path).  Returns the job's initial progress dict."""
        body = dict(kw)
        if records is not None:
            body["records"] = list(records)
        if input_path is not None:
            body["input_path"] = str(input_path)
        return self.request("POST", "/v1/batches", body)

    def batch_status(self, job_id: str) -> dict:
        """``GET /v1/batches/<id>`` — one job's progress."""
        return self.request("GET", f"/v1/batches/{job_id}")

    # ------------------------------------------------------- utilities
    def healthz(self) -> dict:
        return self.request("GET", "/healthz")

    def usage(self) -> dict:
        """``GET /debug/usage`` — the per-tenant usage table (replica)
        or the raw-merged cluster table (router)."""
        return self.request("GET", "/debug/usage")

    def metrics_text(self) -> str:
        conn = self._connect()
        try:
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status != 200:
                raise ServingHTTPError(resp.status,
                                       raw.decode(errors="replace"))
            return raw.decode()
        finally:
            conn.close()

    def drain(self, timeout: float | None = None) -> dict:
        body = {} if timeout is None else {"timeout": timeout}
        return self.request("POST", "/drain", body)

    def resume(self) -> dict:
        return self.request("POST", "/resume")
