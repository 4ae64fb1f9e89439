"""paddle_tpu_torch's HTTP front end against the JAX package's.

One JAX ``llama_tiny`` model's weights drive two servers: the
reference's ``serve(engine=...)`` over ``paddle_tpu.serving.
create_engine`` and the port's over its engine on the CPU (every kernel
wrapper runs its plain version).  Each engine has its own injected
clock, each server its own :class:`ServingClient`.  The same
``/v1/completions`` traffic, sent one request at a time, must give the
same tokens, finish reasons and usage blocks, blocking and streamed
(``queue_ms`` is timed by the wall clock and left out); the same
invalid bodies the same 400s; a full queue a 429 with ``Retry-After``;
a client disconnect a cancelled request whose pages free; a drain
finished streams, then 503; and a ``/metrics`` scrape the same counter
names, with equal values wherever a counter does not measure time.

Every server listens on port 0 and stops in its fixture's teardown;
every blocking call has a timeout and every poll a deadline.
"""
import http.client
import itertools
import threading
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu.serving import EngineWorker as JWorker
from paddle_tpu.serving import ServingClient as JClient
from paddle_tpu.serving import ServingServer as JServer
from paddle_tpu.serving import create_engine as j_create_engine
from paddle_tpu.serving import serve as j_serve
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import EngineWorker as TWorker
from paddle_tpu_torch.serving import ServingClient as TClient
from paddle_tpu_torch.serving import ServingHTTPError as THTTPError
from paddle_tpu_torch.serving import ServingServer as TServer
from paddle_tpu_torch.serving import create_engine as t_create_engine
from paddle_tpu_torch.serving import serve as t_serve
from paddle_tpu.serving import ServingHTTPError as JHTTPError

PAGE = 16
KW = dict(max_slots=4, page_size=PAGE, num_pages=64, max_model_len=128,
          enable_prefix_cache=True)
TIMEOUT = 30.0


class TickClock:
    """An injected engine clock: 1 ms per reading, independent of the
    wall clock and of the other engine's readings."""

    def __init__(self):
        self._n = itertools.count()

    def __call__(self):
        return next(self._n) * 1e-3


@pytest.fixture(scope="module")
def weights():
    paddle.seed(5)
    m = LlamaForCausalLM(llama_tiny())
    m.eval()
    return m, {k: np.asarray(v) for k, v in m.functional_state().items()}


def engines(weights, **kw):
    """(JAX engine, port engine) over the same weights, own clocks."""
    m, np_state = weights
    kw = {**KW, **kw}
    je = j_create_engine(m, clock=TickClock(), **kw)
    te = t_create_engine(TL.llama_tiny(), TC.state_from_numpy(
        np_state, device="cpu"), device="cpu", clock=TickClock(), **kw)
    return je, te


@pytest.fixture(scope="module")
def servers(weights):
    je, te = engines(weights)
    js, ts = j_serve(engine=je), t_serve(engine=te)
    yield js, ts
    js.stop(drain_timeout=10.0)
    ts.stop(drain_timeout=10.0)


@pytest.fixture(scope="module")
def clients(servers):
    js, ts = servers
    return JClient(js.address, timeout=TIMEOUT), \
        TClient(ts.address, timeout=TIMEOUT)


def _prompts():
    rng = np.random.RandomState(3)
    shared = rng.randint(1, 512, PAGE + 3).tolist()
    return [rng.randint(1, 512, 7).tolist(), shared,
            shared[:PAGE] + rng.randint(1, 512, 9).tolist()]


def _stream(client, prompt, **kw):
    toks, final, usage = [], None, None
    for ev in client.completion(prompt, stream=True, **kw):
        toks.extend(ev["choices"][0]["token_ids"])
        if ev["choices"][0]["finish_reason"] is not None:
            final, usage = ev["choices"][0]["finish_reason"], ev["usage"]
    return toks, final, usage


def _blocking(client, prompt, **kw):
    out = client.completion(prompt, **kw)
    ch = out["choices"][0]
    return ch["token_ids"], ch["finish_reason"], out["usage"]


def _untimed(usage):
    return {k: v for k, v in usage.items() if k != "queue_ms"}


def _scrape(client) -> dict:
    """Counter samples of a /metrics scrape: {(name, labels): value}."""
    counters, out = set(), {}
    for line in client.metrics_text().splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            if kind == "counter":
                counters.add(name)
        elif line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            name = key.split("{", 1)[0]
            if name in counters:
                out[(name, key[len(name):])] = float(value)
    return out


def _delta(before, after) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if k[0].startswith("serving_") and v != before.get(k, 0.0)}


@pytest.fixture(scope="module")
def traffic(clients):
    """The parity traffic, one request at a time on each server (so the
    batching, and with it every step counter, is the same on both):
    each prompt blocking, then streamed (a prefix-cache hit), then with
    its first token declared EOS."""
    out = []
    for client in clients:
        before = _scrape(client)
        got = []
        for i, prompt in enumerate(_prompts()):
            n = (6, 9, 12)[i]
            first = _blocking(client, prompt, max_tokens=n)
            got.append(first)
            got.append(_stream(client, prompt, max_tokens=n))
            got.append(_blocking(client, prompt, max_tokens=n,
                                 eos_token_id=first[0][0]))
        out.append((got, _delta(before, _scrape(client))))
    return out


def test_completions_match_reference_blocking_and_streamed(traffic):
    (jgot, _), (tgot, _) = traffic
    assert [g[:2] for g in tgot] == [g[:2] for g in jgot]
    assert [_untimed(g[2]) for g in tgot] == [_untimed(g[2]) for g in jgot]
    for toks, final, usage in tgot:
        assert usage["completion_tokens"] == len(toks)
        assert usage["queue_ms"] >= 0
    finals = {g[1] for g in tgot}
    assert finals == {"length", "stop"}
    # the streamed repeat of a prompt hits the prefix cache
    assert any(g[2]["prompt_tokens_cached"] for g in tgot)


# counters that measure time (seconds of a phase or of an HTTP handler)
# or a compile ledger (the port runs no jit) — everything else is a count
# of requests, tokens, steps, pages or routes, and must agree
TIMED = ("serving_step_phase_seconds_total",)


def test_metrics_after_the_same_traffic(traffic):
    (_, jd), (_, td) = traffic
    assert {k[0] for k in td} == {k[0] for k in jd}
    counts = {k: v for k, v in jd.items() if k[0] not in TIMED}
    assert {k: v for k, v in td.items() if k[0] not in TIMED} == counts
    assert td[("serving_http_requests_total",
               '{route="/v1/completions",code="200"}')] == 9
    tokens = sum(len(g[0]) for g in traffic[1][0])
    assert td[("serving_tokens_total", "")] == tokens


BAD_BODIES = [
    {"prompt": "text prompt", "max_tokens": 4},
    {"max_tokens": 4},
    {"prompt": [], "max_tokens": 4},
    {"prompt": [1, 2, 3], "max_tokens": 4, "timeout": -1},
    {"prompt": [1, 2, 3], "priority": "urgent"},
    {"prompt": [1, 2, 3], "tenant": 5},
    {"prompt": [1, 2, 3], "adapter": 7},
    {"prompt": [1, 2, 3], "max_tokens": 1000},
    {"prompt": [1, 2, 3], "adapter": "nope"},
    {"prompt": [1, 2, 3], "do_sample": True},
    [1, 2, 3],
]


def _raw_post(address, body: bytes):
    host, port = address.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=TIMEOUT)
    try:
        conn.request("POST", "/v1/completions", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_invalid_bodies_are_400_like_the_reference(servers, clients):
    answers = []
    for client, err in zip(clients, (JHTTPError, THTTPError)):
        got = []
        for body in BAD_BODIES:
            with pytest.raises(err) as ei:
                client.request("POST", "/v1/completions", body)
            got.append((ei.value.status, ei.value.body["error"]))
        with pytest.raises(err) as ei:
            client.request("GET", "/nope")
        got.append((ei.value.status, ei.value.body["error"]["type"]))
        answers.append(got)
    assert answers[1] == answers[0]
    assert {s for s, _ in answers[1][:-1]} == {400}
    assert answers[1][-1][0] == 404
    for srv in servers:
        assert _raw_post(srv.address, b"{not json")[0] == 400


def _backpressure(worker_cls, server_cls, client_cls, err, engine):
    """Queue full => an immediate 429 + Retry-After.  The worker thread
    is never started: the first request stays queued, the second is
    refused, and a drain then fails the queued one fast."""
    worker = worker_cls(engine, max_queue=1)
    srv = server_cls(worker, retry_after_s=2.5)
    accept = threading.Thread(target=srv.serve_forever, daemon=True)
    accept.start()
    client = client_cls(srv.address, timeout=TIMEOUT)
    first = {}
    t = threading.Thread(target=lambda: first.setdefault(
        "out", client.completion([1, 2, 3], max_tokens=2)), daemon=True)
    try:
        t.start()
        deadline = time.monotonic() + 10.0
        while not engine.scheduler.queue:
            assert time.monotonic() < deadline, "first request not queued"
            time.sleep(0.005)
        t0 = time.monotonic()
        with pytest.raises(err) as ei:
            client.completion([1, 2, 3], max_tokens=2)
        answered_s = time.monotonic() - t0
        assert worker.drain(timeout=10.0)
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    finally:
        srv.shutdown()
        accept.join(timeout=5.0)
        srv.server_close()
    return (ei.value.status, ei.value.retry_after,
            ei.value.body["error"]["type"], answered_s < 5.0,
            first["out"]["choices"][0]["finish_reason"])


def test_full_queue_is_429_with_retry_after(weights):
    je, te = engines(weights, max_slots=2, num_pages=32, max_model_len=64)
    want = _backpressure(JWorker, JServer, JClient, JHTTPError, je)
    got = _backpressure(TWorker, TServer, TClient, THTTPError, te)
    assert got == want == (429, 2.5, "overloaded_error", True, "cancelled")


def _disconnect(server, client, prompt):
    events = client.completion(prompt, max_tokens=100, stream=True)
    assert next(events)["choices"][0]["token_ids"]
    next(events)
    req = server.worker.requests[-1]
    events.close()                      # the client hangs up mid-stream
    deadline = time.monotonic() + 10.0
    while not req.is_finished():
        assert time.monotonic() < deadline, "disconnect did not cancel"
        time.sleep(0.01)
    while server.worker.stats()["active"]:
        assert time.monotonic() < deadline, "the slot was not freed"
        time.sleep(0.01)
    with server.worker.lock:
        pool = server.worker.engine.blocks.pool_accounting()
    return req.finish_reason, req.num_generated < 100, pool["live"], \
        pool["leak"]


def test_disconnect_cancels_and_frees_pages(servers, clients):
    prompt = _prompts()[0]
    got = [_disconnect(s, c, prompt) for s, c in zip(servers, clients)]
    assert got[1] == got[0] == ("cancelled", True, 0, 0)


def _drain(server, client, err, prompt):
    """Drain with one stream in flight.  The engine's step is held (its
    worker lock released while it waits) from the stream's admission
    until the drain has begun, so the stream is in flight when the drain
    starts however fast the model runs."""
    worker, engine = server.worker, server.worker.engine
    step = engine.step

    def held_step():
        out = step()
        deadline = time.monotonic() + TIMEOUT
        while (engine.scheduler.active_count
               and not engine.scheduler.draining
               and time.monotonic() < deadline):
            worker._wake.wait(0.01)
        return out

    out = {}

    def consume():
        out["stream"] = _stream(client, prompt, max_tokens=24)

    engine.step = held_step
    t = threading.Thread(target=consume, daemon=True)
    try:
        t.start()
        deadline = time.monotonic() + TIMEOUT
        while not engine.scheduler.active_count:
            assert time.monotonic() < deadline, "stream never admitted"
            time.sleep(0.005)
        drained = client.drain(timeout=TIMEOUT)
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
        status = client.healthz()["status"]
        with pytest.raises(err) as ei:
            client.completion(prompt, max_tokens=2)
    finally:
        del engine.step
        client.resume()
    after = client.completion(prompt, max_tokens=2)
    toks, final, usage = out["stream"]
    return (drained, toks, final, _untimed(usage), status,
            ei.value.status, after["choices"][0]["finish_reason"])


def test_drain_finishes_inflight_streams_then_503(servers, clients):
    prompt = _prompts()[0]
    got = [_drain(s, c, e, prompt) for s, c, e in
           zip(servers, clients, (JHTTPError, THTTPError))]
    assert got[1] == got[0]
    drained, toks, final, _, status, code, after = got[1]
    assert drained == {"drained": True} and len(toks) == 24
    assert (final, status, code, after) == ("length", "draining", 503,
                                            "length")
