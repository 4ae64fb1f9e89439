"""paddle_tpu_torch's tensor-parallel engine with speculative decoding,
preemption and fault recovery, at tp=2, against the JAX engine at the
same mesh.

Mirrors the tp=2 cases of ``tests/test_serving_spec.py`` (spec_k 4 with
the prefix cache: the verify step runs the same paged layers on every
rank, ``decode_traces`` 2 and ``verify_traces`` 1) and
``tests/test_overload.py::test_preempt_parity_tp2`` (preempt -> spill
-> resume: ``read_page`` gathers every rank's heads of a page to the
host tier and ``write_page`` scatters them back, so 2 pages spill, 2
restore and none leaks), plus one supervisor recovery at tp=2 (a
poisoned step rebuilds the runner on the same workers, which rebuild
their shards, and replays both requests).  Tokens, finish reasons and
counters equal the JAX engine's; every rank's ring equals rank 0's after
every step, the rebuilt runner's too.
"""
import numpy as np
import pytest

from paddle_tpu.serving import EngineSupervisor as JSupervisor
from paddle_tpu.serving import FaultPlan as JFaultPlan
from paddle_tpu.serving import GenerationConfig as JGen
from paddle_tpu_torch.serving import EngineSupervisor, FaultPlan
from paddle_tpu_torch.serving import GenerationConfig as TGen

from torch_serving_tp import (cpu_ranks, pair, rank_states_equal,
                              same_requests, same_stats, tp_model)

# repetitive prompts (the n-gram drafter fires), one novel prompt, one
# sharing a page-aligned prefix (test_serving_spec.py's)
PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6], [9, 3, 9, 3, 9, 3, 9, 3, 9, 3],
           [11, 12, 13, 14], [5, 6, 7, 5, 6, 7, 5, 9]]
N_NEW = [12, 10, 8, 12]
SPEC_STATS = ("spec_k", "verify_traces", "spec_proposed", "spec_accepted",
              "spec_rejected", "spec_verify_steps", "spec_committed_tokens")


@pytest.fixture(scope="module", autouse=True)
def ranks():
    with cpu_ranks(2):
        yield


@pytest.fixture(scope="module")
def model():
    return tp_model()


def test_spec_greedy_parity_tp2(model):
    je, te = pair(model, max_slots=4, page_size=8, max_model_len=64,
                  mesh=2, spec_k=4, enable_prefix_cache=True)
    out = []
    for eng, gen in ((je, JGen), (te, TGen)):
        reqs = [eng.submit(np.array(p, np.int32), gen(max_new_tokens=n))
                for p, n in zip(PROMPTS, N_NEW)]
        eng.run_until_complete(max_steps=500)
        out.append(reqs)
    same_requests(*out)
    st = te.stats()
    assert st["decode_traces"] == 2 and st["verify_traces"] == 1
    assert st["spec_proposed"] > 0 and st["spec_verify_steps"] > 0
    same_stats(je, te)
    same_stats(je, te, SPEC_STATS)


def _overload(eng, gen_cls):
    """Two low-priority residents decode 4 steps, then a priority-1
    request arrives with both slots taken."""
    lo = [eng.submit([1, 2, 3, 4, 5, 6], gen_cls(max_new_tokens=8)),
          eng.submit([3, 4, 5, 6, 7, 8], gen_cls(max_new_tokens=8))]
    for _ in range(4):
        eng.step()
    hi = eng.submit([5, 6, 7, 8, 9, 10], gen_cls(max_new_tokens=8),
                    priority=1)
    eng.run_until_complete(max_steps=600)
    return lo + [hi]


def test_preempt_parity_tp2(model):
    # test_overload.py's engine: pages of 4 tokens
    je, te = pair(model, max_slots=2, page_size=4, max_model_len=128,
                  sync_interval=1, mesh=2, preempt=True)
    same_requests(_overload(je, JGen), _overload(te, TGen))
    assert te.tp == 2 and te.preemptions == 1
    assert te.blocks.spilled_pages == 2 and te.blocks.restored_pages == 2
    assert te.blocks.spill_bytes == je.blocks.spill_bytes > 0
    assert te.blocks.pool_accounting()["leak"] == 0
    assert te.decode_traces == 1
    same_stats(je, te)


def test_supervisor_recovery_tp2(model):
    """A ``step_raise`` at decode step 5 under the supervisor: one runner
    rebuild on the same workers, both requests replayed, the JAX
    engine's tokens, replays and counters."""
    plans = []
    for cls in (JFaultPlan, FaultPlan):
        plan = cls(seed=0)
        plan.add("step_raise", at=5)
        plans.append(plan)
    kw = dict(max_slots=2, page_size=8, max_model_len=64, num_pages=16,
              mesh=2, enable_prefix_cache=True)
    from paddle_tpu.serving import create_engine as j_create_engine
    from paddle_tpu_torch.serving import create_engine as t_create_engine
    from torch_serving_tp import checked, port_state
    jm, np_state, tcfg = model
    je = j_create_engine(jm, faults=plans[0], **kw)
    te = checked(t_create_engine(tcfg, port_state(np_state), device="cpu",
                                 faults=plans[1], **kw))
    workers = te.runner._mesh.pids
    out = []
    for eng, sup_cls, gen in ((je, JSupervisor, JGen),
                              (te, EngineSupervisor, TGen)):
        sup = sup_cls(eng, max_recoveries=3)
        reqs = [eng.submit([1, 2, 3, 4, 5, 6, 7, 8], gen(max_new_tokens=10)),
                eng.submit([1, 2, 3, 4, 5, 6, 9, 10],
                           gen(max_new_tokens=10))]
        for _ in range(500):
            if all(r.is_finished() for r in reqs):
                break
            sup.step()
        out.append((reqs, sup))
    same_requests(out[0][0], out[1][0])
    assert [r.replays for r in out[1][0]] == [r.replays for r in out[0][0]]
    st = te.stats()
    assert st["recoveries"] == 1 and st["replayed_requests"] == 2
    assert st["faults_injected"] == {"step_raise": 1}
    assert te.runner._mesh.pids == workers      # rebuilt without a spawn
    assert rank_states_equal(te) == 2
    same_stats(je, te, ("recoveries", "quarantines", "replayed_requests",
                        "faults_injected", "decode_steps", "host_syncs",
                        "pages_in_use", "pages_allocated", "prefix_hits",
                        "cached_tokens", "decode_traces"))
    assert te.blocks.pool_accounting()["leak"] == 0
