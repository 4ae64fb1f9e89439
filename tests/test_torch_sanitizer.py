"""paddle_tpu_torch's concurrency sanitizer against the JAX package's.

With ``FLAGS_sanitizer`` on in both packages, the same scripted lock
orders (run by one function, so every acquire site has the same file
and line on both sides) must give the same lockset findings: one ABBA
inversion, one Eraser-style race on an unguarded shared field, and
nothing for consistent orders, re-entry, a Condition wait or a field
guarded by one lock.  The reports render alike, the lock-wait graph
has the reference's shape, and with the flag off both factories hand
out plain ``threading`` primitives.
"""
import threading

import pytest

import paddle_tpu.sanitizer as jsan
from paddle_tpu.flags import FLAGS as JFLAGS
import paddle_tpu_torch.sanitizer as tsan
from paddle_tpu_torch.flags import FLAGS as TFLAGS


@pytest.fixture
def sanitized(monkeypatch):
    monkeypatch.setitem(JFLAGS, "FLAGS_sanitizer", True)
    monkeypatch.setitem(TFLAGS, "FLAGS_sanitizer", True)
    jsan.clear()
    tsan.clear()
    yield
    jsan.clear()
    tsan.clear()


def _in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive()


def _script(san):
    """Lock orders and shared accesses, each in its own thread."""
    a, b, c = (san.make_lock(f"script.{n}") for n in "abc")
    r = san.make_rlock("script.r")

    def a_then_b():
        with a:
            with b:
                pass

    def b_then_a():                   # the inversion: reported once
        with b:
            with a:
                pass

    def a_then_c():                   # consistent order: silent
        with a:
            with c:
                pass

    def reentrant():
        with r:
            with r:
                with c:
                    pass

    def condition_wait():
        cond = san.make_condition(r, name="script.cond")
        with cond:
            cond.wait(0.01)

    for fn in (a_then_b, b_then_a, a_then_c, a_then_c, reentrant,
               condition_wait, b_then_a):
        _in_thread(fn)

    class Box:
        unguarded = san.TrackedField(0)
        guarded = san.TrackedField(0)

    box = Box()
    g = san.make_lock("script.g")

    def write_both():
        box.unguarded = box.unguarded + 1
        with g:
            box.guarded = box.guarded + 1

    # two live threads (thread idents are reused once a thread ends),
    # the second writing only after the first is done
    turn = threading.Barrier(2, timeout=10.0)

    def first():
        write_both()
        turn.wait()

    def second():
        turn.wait()
        write_both()

    pair = [threading.Thread(target=first), threading.Thread(target=second)]
    for t in pair:
        t.start()
    for t in pair:
        t.join(timeout=10.0)
        assert not t.is_alive()
    graph = san.lock_wait_graph()
    return [f.to_dict() for f in san.findings()], san.render(), graph


def test_scripted_lock_orders_give_the_reference_findings(sanitized):
    jf, jtext, jgraph = _script(jsan)
    tf, ttext, tgraph = _script(tsan)
    assert tf == jf
    assert ttext == jtext
    assert sorted(f["rule"] for f in tf) == ["sanitizer-lock-order",
                                             "sanitizer-lockset"]
    assert all(f["path"] == "tests/test_torch_sanitizer.py" for f in tf)
    assert "script.a" in ttext and "Box.unguarded" in ttext
    assert set(tgraph) == set(jgraph) == {"threads", "locks",
                                          "wait_edges", "deadlocks"}
    assert tgraph["deadlocks"] == []


def test_flag_off_hands_out_plain_primitives(monkeypatch):
    monkeypatch.setitem(TFLAGS, "FLAGS_sanitizer", False)
    assert type(tsan.make_lock("x")) is type(threading.Lock())
    assert type(tsan.make_rlock("x")) is type(threading.RLock())
    assert not tsan.enabled()
    monkeypatch.setitem(TFLAGS, "FLAGS_sanitizer", True)
    assert isinstance(tsan.make_lock("x"), tsan.SanitizedLock)
    assert isinstance(tsan.make_rlock("x"), tsan.SanitizedRLock)
    assert tsan.RULES == jsan.RULES


def test_port_locks_come_from_the_factory(sanitized):
    """The registry's, the supervisor's and the adapter store's locks
    come from the sanitizer's factory, so a sanitized run sees them."""
    from paddle_tpu_torch.models import llama as TL
    from paddle_tpu_torch.observability.registry import MetricsRegistry
    from paddle_tpu_torch.serving.lora.store import AdapterStore
    from paddle_tpu_torch.serving.supervisor import EngineSupervisor

    class _Engine:
        faults = None

    reg = MetricsRegistry()
    assert isinstance(reg._lock, tsan.SanitizedLock)
    assert isinstance(reg._events_lock, tsan.SanitizedLock)
    ctr = reg.counter("sanitized_probe_total", "t")
    assert isinstance(ctr._lock, tsan.SanitizedLock)
    sup = EngineSupervisor(_Engine(), max_recoveries=1)
    assert isinstance(sup._lock, tsan.SanitizedLock)
    store = AdapterStore(TL.llama_tiny(), capacity=1, rank=2)
    assert isinstance(store._lock, tsan.SanitizedLock)
    assert tsan.findings() == []
