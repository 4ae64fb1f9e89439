"""paddle_tpu_torch's multi-replica router against the JAX package's.

The router is pure HTTP, so both routers drive the same backends: port
servers on the CPU over one ``llama_tiny`` state dict.  The port's
:class:`Router` must compute the reference's prefix-affinity keys for
the same prompts, open and re-close its circuit breaker on the same
probe sequence under an injected clock, retry a transport failure on
another replica but never an HTTP answer, and — as a 2-replica proxy —
give the tokens of a single server, with a prefix hit rate no worse
than that server's.

Every server listens on port 0 and stops in its fixture's teardown;
every blocking call has a timeout.
"""
import socket

import numpy as np
import pytest
import torch

from paddle_tpu.serving import NoReplicaAvailable as JNoReplica
from paddle_tpu.serving import Router as JRouter
from paddle_tpu.serving import ServingHTTPError as JHTTPError
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import NoReplicaAvailable as TNoReplica
from paddle_tpu_torch.serving import Router as TRouter
from paddle_tpu_torch.serving import ServingClient
from paddle_tpu_torch.serving import ServingHTTPError as THTTPError
from paddle_tpu_torch.serving import serve

PAGE = 16
KW = dict(max_slots=4, page_size=PAGE, num_pages=128, max_model_len=128,
          enable_prefix_cache=True, device="cpu")
TIMEOUT = 30.0


@pytest.fixture(scope="module")
def state():
    cfg = TL.llama_tiny()
    return cfg, TC.init_state(cfg, torch.Generator().manual_seed(2),
                              device="cpu")


@pytest.fixture(scope="module")
def servers(state):
    """Four port servers over ONE state dict: one for the circuit and
    retry cases, a single server, and the pair behind the router."""
    cfg, st = state
    srvs = [serve(cfg, st, **KW) for _ in range(4)]
    yield srvs
    for s in srvs:
        s.stop(drain_timeout=10.0)


def _dead_address() -> str:
    """An address that refuses connections (bound, then closed)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def _prompts(n, seed=0):
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, 512, 2 * PAGE).tolist()
    return [shared + rng.randint(1, 512, int(rng.randint(3, 9))).tolist()
            for _ in range(n)]


def test_affinity_key_is_the_reference_key():
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 512, n).tolist()
               for n in (1, PAGE - 1, PAGE, PAGE + 1, 3 * PAGE + 5)]
    prompts.append(list(range(PAGE)) + [99])
    addrs = ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"]
    j, t = JRouter(addrs, page_size=PAGE), TRouter(addrs, page_size=PAGE)
    for p in prompts:
        for adapter in (None, "a1"):
            assert t._affinity_key(p, adapter) == \
                j._affinity_key(p, adapter)
        assert t.pick(p).address == j.pick(p).address
    assert t._affinity_key(list(range(PAGE - 1))) is None


def _circuit(router_cls, no_replica, live):
    now = [0.0]
    r = router_cls([live, _dead_address()], page_size=PAGE,
                   fail_threshold=2, cooldown_s=5.0, probe_timeout_s=2.0,
                   clock=lambda: now[0])
    live_rep, dead_rep = r.replicas
    seen = []

    def note():
        seen.append((live_rep.available(now[0]), live_rep.fails,
                     dead_rep.available(now[0]), dead_rep.fails,
                     r.stats()["up"]))

    r.probe_once()
    note()                                  # below the threshold
    r.probe_once()
    note()                                  # circuit open
    picks = {r.pick(list(range(2 * PAGE)) + [s]) is live_rep
             for s in range(8)}
    now[0] = 5.5                            # cooldown elapsed: readmitted
    note()
    r.probe_once()                          # still dead: opens again
    note()
    live_rep.fails = 1
    r.probe_once()                          # a live probe clears strikes
    note()
    with pytest.raises(no_replica):
        r.pick([1, 2, 3], exclude=[live_rep])
    return seen, picks


def test_circuit_break_and_readmit(servers):
    want = _circuit(JRouter, JNoReplica, servers[0].address)
    got = _circuit(TRouter, TNoReplica, servers[0].address)
    assert got == want
    assert got[1] == {True}
    assert [s[2] for s in got[0]] == [True, False, True, False, False]


def _retries(router_cls, http_error, server):
    dead = _dead_address()
    r = router_cls([dead, server.address], page_size=PAGE, max_retries=1,
                   request_timeout_s=TIMEOUT)
    dead_rep, live_rep = r.replicas
    live_rep.inflight = 1          # least-loaded sends the first try dead
    out = r.completion([1, 2, 3], max_tokens=4)
    toks = out["choices"][0]["token_ids"]
    streamed = []
    for ev in r.completion([1, 2, 3], max_tokens=4, stream=True):
        streamed.extend(ev["choices"][0]["token_ids"])
    failed_over = (dead_rep.fails >= 1, live_rep.inflight, r.failovers)
    # an HTTP answer (503 while draining) is never retried, and it is no
    # strike against the replica
    r2 = router_cls([server.address], page_size=PAGE,
                    request_timeout_s=TIMEOUT)
    ServingClient(server.address, timeout=TIMEOUT).drain(timeout=TIMEOUT)
    try:
        with pytest.raises(http_error) as ei:
            r2.completion([1, 2, 3], max_tokens=2)
    finally:
        ServingClient(server.address, timeout=TIMEOUT).resume()
    rep = r2.replicas[0]
    return toks, streamed, failed_over, ei.value.status, rep.fails, \
        rep.inflight


def test_retry_on_transport_failure_never_on_an_answer(servers):
    want = _retries(JRouter, JHTTPError, servers[0])
    got = _retries(TRouter, THTTPError, servers[0])
    assert got == want
    toks, streamed, (struck, inflight, _), status, fails, held = got
    assert len(toks) == 4 and streamed == toks
    assert struck and inflight == 1
    assert (status, fails, held) == (503, 0, 0)


def _hit_rate(srvs):
    hits = sum(s.worker.stats()["prefix_hits"] for s in srvs)
    miss = sum(s.worker.stats()["prefix_misses"] for s in srvs)
    return hits / (hits + miss)


def test_two_replica_proxy_gives_the_single_server_tokens(servers):
    single, pair = servers[1], servers[2:]
    prompts = _prompts(8)
    sc = ServingClient(single.address, timeout=TIMEOUT)
    want = [sc.completion_tokens(p, max_tokens=5) for p in prompts]
    single_rate = _hit_rate([single])
    router = TRouter([s.address for s in pair], page_size=PAGE,
                     request_timeout_s=TIMEOUT)
    proxy = router.serve()
    try:
        pc = ServingClient(proxy.address, timeout=TIMEOUT)
        got = [pc.completion_tokens(p, max_tokens=5) for p in prompts]
        streamed = []
        for ev in pc.completion(prompts[0], max_tokens=5, stream=True):
            streamed.extend(ev["choices"][0]["token_ids"])
        assert pc.healthz()["up"] == 2
    finally:
        proxy.stop()
    assert got == want and streamed == want[0]
    # prefix affinity: the shared-prefix family lands on one replica, so
    # the pair's hit rate is no worse than the single server's
    assert single_rate > 0.5
    assert _hit_rate(pair) >= single_rate - 1e-9
    assert sum(s.worker.stats()["prefix_hits"] > 0 for s in pair) == 1
