"""paddle_tpu_torch's tensor-parallel engine recovering from a failure of
rank 0's own shard in the middle of a step, against the JAX engine at
the same mesh.

Rank 0 sends each runner call to the workers before it runs its own
shard, so a rank-0 error inside a step leaves the workers in (or past)
collectives that rank 0 never enters: the group is out of step.  The
mesh must then count as failed, so that the supervisor's runner rebuild
starts new workers instead of pairing the new shards' scatter with the
old step's all-reduces.  The tokens, replays and counters must be the
JAX engine's with a ``step_raise`` at the same decode step (that one
raises before dispatch: both rebuild and replay from the same host
state).
"""
import pytest

from paddle_tpu.serving import EngineSupervisor as JSupervisor
from paddle_tpu.serving import FaultPlan as JFaultPlan
from paddle_tpu.serving import GenerationConfig as JGen
from paddle_tpu_torch.serving import EngineSupervisor
from paddle_tpu_torch.serving import GenerationConfig as TGen

from torch_serving_tp import (cpu_ranks, rank_states_equal, same_requests,
                              same_stats, tp_model)


@pytest.fixture(scope="module", autouse=True)
def ranks():
    with cpu_ranks(2):
        yield


@pytest.fixture(scope="module")
def model():
    return tp_model()


def test_supervisor_recovers_from_a_rank0_error_inside_a_step(model):
    """Rank 0 raises inside its decode step after layer 0, while the
    workers run the whole step and wait in layer 1's all-reduce: the
    mesh is marked failed, the supervisor's rebuild gets new workers,
    and the tokens and counters are the JAX engine's with a
    ``step_raise`` at the same step.  Each rank's host timers then count
    the new mesh's calls alike."""
    from paddle_tpu.serving import create_engine as j_create_engine
    from paddle_tpu_torch.serving import create_engine as t_create_engine
    from paddle_tpu_torch.serving.parallel import runner as TR
    from torch_serving_tp import checked, port_state
    at = 5
    jplan = JFaultPlan(seed=0)
    jplan.add("step_raise", at=at)
    kw = dict(max_slots=2, page_size=8, max_model_len=64, num_pages=16,
              mesh=2, enable_prefix_cache=True)
    jm, np_state, tcfg = model
    je = j_create_engine(jm, faults=jplan, **kw)
    te = checked(t_create_engine(tcfg, port_state(np_state), device="cpu",
                                 **kw))
    first = te.runner._mesh
    workers = first.pids
    layer = TR._decode_layer_paged
    seen = [0]

    def raise_in_layer_1(*args):
        if args[-2] == 1:                       # li: layer 0 is done
            seen[0] += 1
            if seen[0] == at + 1:               # decode step ``at``
                raise RuntimeError("rank 0 failed between layers")
        return layer(*args)

    TR._decode_layer_paged = raise_in_layer_1
    out = []
    try:
        for eng, sup_cls, gen in ((je, JSupervisor, JGen),
                                  (te, EngineSupervisor, TGen)):
            sup = sup_cls(eng, max_recoveries=3)
            reqs = [eng.submit([1, 2, 3, 4, 5, 6, 7, 8],
                               gen(max_new_tokens=10)),
                    eng.submit([1, 2, 3, 4, 5, 6, 9, 10],
                               gen(max_new_tokens=10))]
            for _ in range(500):
                if all(r.is_finished() for r in reqs):
                    break
                sup.step()
            out.append(reqs)
    finally:
        TR._decode_layer_paged = layer
    same_requests(*out)
    assert [r.replays for r in out[1]] == [r.replays for r in out[0]]
    assert first.failed is not None and first.failed.rank == 0
    assert "rank 0 failed between layers" in str(first.failed)
    mesh = te.runner._mesh
    assert mesh is not first and mesh.failed is None
    assert not set(mesh.pids) & set(workers)    # new workers
    st = te.stats()
    assert st["recoveries"] == 1 and st["replayed_requests"] == 2
    assert rank_states_equal(te) == 2
    same_stats(je, te, ("recoveries", "quarantines", "replayed_requests",
                        "decode_steps", "host_syncs", "pages_in_use",
                        "pages_allocated", "prefix_hits", "cached_tokens",
                        "decode_traces"))
    assert te.blocks.pool_accounting()["leak"] == 0
    host = mesh.host_stats()
    assert [h["pid"] for h in host[1:]] == mesh.pids
    assert host[0]["calls"]["decode_step"][0] > 0
    for call, (n, _s) in host[0]["calls"].items():
        assert host[1]["calls"][call][0] == n, call
