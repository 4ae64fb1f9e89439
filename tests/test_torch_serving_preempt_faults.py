"""paddle_tpu_torch preemption under spill faults and churn.

``spill_fail`` (the device -> host page copy of a preemption fails:
once, and on every attempt) and repeated preempt -> spill -> resume
churn, each on ``test_torch_serving_preempt.py``'s engines and held
against the JAX engine: tokens, per-request ledgers, counters, the
fault plan's firings and the pool census.
"""
import pytest

from test_torch_serving_preempt import (  # noqa: F401  (tiny: a fixture)
    LO, JGen, TGen, engines, overload, same, tiny)


@pytest.mark.parametrize("rule,preempted", [(dict(p=1.0), 0),
                                            (dict(at=1), 1)])
def test_spill_fail_matches_jax_engine(tiny, rule, preempted):
    """spill_fail on every attempt: no preemption lands, nothing stays
    parked, the victim finishes untouched; once: the next pass retries
    and succeeds."""
    je, te = engines(tiny, preempt=True,
                     faults=[("spill_fail", rule)])
    jreqs, treqs = overload(je, JGen), overload(te, TGen)
    ts = same(je, jreqs, te, treqs)
    assert ts["preemptions"] == preempted and ts["spill_aborts"] >= 1
    assert te.faults.injected == je.faults.injected
    assert all(r.finish_reason == "length" for r in treqs)
    if not preempted:
        assert ts["spilled_pages"] == 0 and ts["host_parked_pages"] == 0
        assert all(r.preemptions == 0 for r in treqs)


def test_churn_matches_jax_engine(tiny):
    """Three waves of priority-1 arrivals against two long residents:
    every request completes at full length, the ledgers reconcile."""
    def churn(eng, gen_cls):
        lows = [eng.submit(p, gen_cls(max_new_tokens=24)) for p in LO]
        highs = []
        for wave in range(3):
            for _ in range(4):
                eng.step()
            highs.append(eng.submit([9 + wave, 10, 11, 12],
                                    gen_cls(max_new_tokens=3), priority=1))
            for _ in range(8):
                eng.step()
        eng.run_until_complete(max_steps=800)
        return lows + highs

    je, te = engines(tiny, preempt=True)
    jreqs, treqs = churn(je, JGen), churn(te, TGen)
    ts = same(je, jreqs, te, treqs)
    assert ts["preemptions"] >= 2
    assert ts["preemptions"] == sum(r.preemptions for r in treqs)
    assert all(r.num_generated == r.gen.max_new_tokens for r in treqs)


def _resume_before_sync(eng, gen_cls):
    """A preemption with unsynced ring rows (sync_interval 8), then a
    cancel that frees a slot, so the victim resumes before the next
    sync."""
    a = eng.submit(LO[0], gen_cls(max_new_tokens=20))
    b = eng.submit(LO[1], gen_cls(max_new_tokens=20))
    for _ in range(3):
        eng.step()
    hi = eng.submit([5, 6, 7, 8, 9, 10], gen_cls(max_new_tokens=20),
                    priority=1)
    eng.step()                          # preempts a resident
    (b if a.preemptions else a).cancel()
    eng.run_until_complete(max_steps=400)
    return [a, b, hi]


def test_resume_before_sync_discards_stale_rows(tiny):
    """No JAX counterpart: the reference keeps a victim's unsynced ring
    rows and, when the victim is back in DECODE at the next sync, emits
    them again (tokens it already re-decodes after its resume).  The
    port drops them at preemption, so the victim's tokens are those of
    an uninterrupted run."""
    je, te = engines(tiny, preempt=True, sync_interval=8)
    jreqs, treqs = _resume_before_sync(je, JGen), \
        _resume_before_sync(te, TGen)
    _, ref = engines(tiny, preempt=False, sync_interval=8)
    want = [ref.submit(p, TGen(max_new_tokens=20)) for p in LO]
    ref.run_until_complete(max_steps=400)
    victim = next(i for i, r in enumerate(treqs) if r.preemptions)
    assert te.preemptions == je.preemptions == 1
    assert treqs[victim].finish_reason == "length"
    assert treqs[victim].output_tokens == want[victim].output_tokens
    assert jreqs[victim].output_tokens != want[victim].output_tokens
    assert te.blocks.pool_accounting()["leak"] == 0
