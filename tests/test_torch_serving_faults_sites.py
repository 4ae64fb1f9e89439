"""paddle_tpu_torch fault sites and escalation against the JAX engine.

The rest of ``tests/test_faults.py``'s tp=1 engine cases, on
``test_torch_serving_faults.py``'s engines and supervisor: the recovery
budget escalating to drain, a failed rebuild escalating, ``page_alloc``
back-pressure, ``slow_step`` on a fake clock, NaN logits quarantining
only their request (decode, and prefill whole or chunked), and the
faults in ``stats()`` — tokens, finish reasons, counters, the plan's
firings and the pool census equal the reference's.
"""
import pytest

from test_torch_serving_faults import P1, P2, _both, _drive, _same, _two
from test_torch_serving_preempt import tiny  # noqa: F401  (a fixture)


def test_budget_exhausted_escalates_to_drain(tiny):
    def script(eng, sup, gen_cls):
        req = eng.submit(P1, gen_cls(max_new_tokens=30))
        _drive(sup, [req], max_steps=200)
        return [req]
    j, t = _both(tiny, [("step_raise", dict(at=2, times=50))], script,
                 max_recoveries=2)
    _same(j, t)
    te, tsup, (req,) = t
    assert req.finish_reason == "error"
    assert "recovery budget exhausted" in req.error
    assert tsup.escalated and te.scheduler.draining
    assert tsup.stats()["recoveries"] == 2


def test_recover_failure_escalates(tiny):
    """If the rebuild itself dies the supervisor must drain, not crash
    the worker loop."""
    def script(eng, sup, gen_cls):
        req = eng.submit(P1, gen_cls(max_new_tokens=10))

        def broken_recover():
            raise RuntimeError("device gone for good")
        eng.recover = broken_recover
        _drive(sup, [req], max_steps=200)
        return [req]
    j, t = _both(tiny, [("step_raise", dict(at=3))], script)
    _same(j, t)
    assert t[2][0].finish_reason == "error" and t[1].escalated


def test_page_alloc_fault_backpressures_then_admits(tiny):
    def script(eng, sup, gen_cls):
        req = eng.submit(P1, gen_cls(max_new_tokens=4))
        eng.run_until_complete(max_steps=200)
        return [req]
    j, t = _both(tiny, [("page_alloc", dict(at=1))], script)
    ts = _same(j, t)
    assert t[2][0].finish_reason == "length"
    assert ts["faults_injected"] == {"page_alloc": 1}


def test_slow_step_sleeps_on_a_fake_clock(tiny, monkeypatch):
    import time as _time
    slept = []
    monkeypatch.setattr(_time, "sleep", slept.append)

    def script(eng, sup, gen_cls):
        req = eng.submit(P1, gen_cls(max_new_tokens=6))
        eng.run_until_complete(max_steps=200)
        return [req]
    # the second rule counts only the checks the first lets through
    j, t = _both(tiny, [("slow_step", dict(at=1, seconds=0.05)),
                  ("slow_step", dict(at=3))], script,
                 clock=lambda: 0.0)
    ts = _same(j, t)
    assert slept == [0.05, 0.05, 0.05, 0.05]     # both engines, both rules
    assert t[2][0].finish_reason == "length"
    assert ts["faults_injected"] == {"slow_step": 2}


def test_nan_slot_quarantined_healthy_slot_survives(tiny):
    """One NaN logits row fails ONLY the offending request; the healthy
    slot keeps decoding to completion."""
    def script(eng, sup, gen_cls):
        # sampling pinned to greedy (top_k=1): the per-request RNGs key
        # on request ids, which differ between the two packages
        reqs = [eng.submit(P, gen_cls(max_new_tokens=10, do_sample=True,
                                      top_k=1, seed=7)) for P in (P1, P2)]
        _drive(sup, reqs)
        return reqs
    j, t = _both(tiny, [("nan_logits", dict(at=1, slot=0, phase="decode"))],
                 script, emit_logits=True)
    ts = _same(j, t)
    bad, good = t[2]
    assert bad.finish_reason == "error" and "logits" in bad.error
    assert good.finish_reason == "length" and good.num_generated == 10
    assert ts["quarantines"] == 1 and ts["recoveries"] == 0


@pytest.mark.parametrize("chunk", [0, 4])
def test_nan_prefill_greedy_quarantined(chunk, tiny):
    """The greedy path detects NaN at prefill (whole or chunked): only
    the poisoned admission fails."""
    def script(eng, sup, gen_cls):
        reqs = [eng.submit(P1, gen_cls(max_new_tokens=6)),
                eng.submit(P2, gen_cls(max_new_tokens=6))]
        _drive(sup, reqs)
        return reqs
    j, t = _both(tiny, [("nan_logits", dict(at=1, slot=0, phase="prefill"))],
                 script, prefill_chunk=chunk)
    ts = _same(j, t)
    bad, good = t[2]
    assert bad.finish_reason == "error" and "non-finite" in bad.error
    assert good.finish_reason == "length" and good.num_generated == 6
    assert ts["quarantines"] == 1


def test_faults_surface_in_stats(tiny):
    j, t = _both(tiny, [("step_raise", dict(at=2))], _two(6))
    ts = _same(j, t)
    assert ts["faults_injected"] == {"step_raise": 1}
    assert ts["recoveries"] == 1
    assert t[0].faults.stats() == j[0].faults.stats()
