"""paddle_tpu_torch speculative decoding against the JAX engine, with
deferred host syncs and churn.

The sync_interval 4 half of ``test_torch_serving_spec.py``'s matrix
(spec_k {0, 2, 4} x prefix cache), a deadline eviction while a request
speculates, and a second wave of admissions through one speculative
engine (``decode_traces == 2``, ``verify_traces == 1``), each held
against the JAX engine on the same weights.
"""
import numpy as np
import pytest

from test_torch_serving_spec import (  # noqa: F401  (tiny, plain: fixtures)
    JGen, PROMPTS, SPEC_STATS, STATS, TGen, _engines, _run, _same,
    check_spec_cell, plain, tiny)


@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("spec_k", [0, 2, 4])
def test_spec_matches_jax_engine_deferred_sync(tiny, plain, spec_k, cache):
    check_spec_cell(tiny, plain, spec_k, cache, sync_interval=4)


def _drive_deadline(eng, gen_cls):
    """A 40-token request on a 4-second deadline speculates until the
    deadline evicts it mid-decode; the other request finishes."""
    clock = eng._clock
    victim = eng.submit(np.array(PROMPTS[0], np.int32),
                        gen_cls(max_new_tokens=40), deadline=4.0)
    other = eng.submit(np.array([9, 3, 9, 3, 9, 3, 9, 3], np.int32),
                       gen_cls(max_new_tokens=12))
    steps = 0
    while eng.scheduler.has_work():
        clock.t += 1.0                  # the deadline hits mid-decode
        eng.step()
        steps += 1
        assert steps < 200
    return [victim, other]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_eviction_mid_speculation(tiny):
    je, te = _engines(tiny, spec_k=3, max_slots=2, clock=_Clock)
    jreqs = _drive_deadline(je, JGen)
    treqs = _drive_deadline(te, TGen)
    _same(je, jreqs, te, treqs, STATS + SPEC_STATS)
    assert treqs[0].finish_reason == "deadline"
    assert treqs[1].finish_reason == "length"
    assert te.blocks.pool_accounting()["leak"] == 0
    assert te.blocks.pages_in_use == 0


def test_verify_traces_stable_across_churn(tiny):
    """A second wave of admissions through the same speculative engine
    builds nothing new."""
    je, te = _engines(tiny, spec_k=3)
    for eng, gen_cls in ((je, JGen), (te, TGen)):
        _run(eng, gen_cls)
        eng.submit(np.array(PROMPTS[1], np.int32), gen_cls(max_new_tokens=6))
        eng.run_until_complete(max_steps=300)
    ts = _same(je, [], te, [], STATS + SPEC_STATS)
    assert ts["decode_traces"] == 2 and ts["verify_traces"] == 1
