"""paddle_tpu_torch's tensor-parallel serving engine against the JAX
engine at the same mesh: greedy parity and the mesh's parsing.

Mirrors ``tests/test_serving_tp.py`` at tp=2: its one-shot parity, its
continuous-batching parity and its prefix-cache copy-on-write case
(the tp=4 scenarios are in ``test_torch_serving_tp_cache.py``).  Each
scenario runs the JAX engine on the 8 virtual CPU devices at ``mesh=tp`` and the port's engine
at the same ``mesh`` over gloo ranks (``device="cpu"``), on the same
numpy weights: the tokens, finish reasons and counters are equal, one
decode trace serves the engine, and every rank's ring equals rank 0's
after every step.  ``mesh=1`` starts no process and makes no collective
call.
"""
import multiprocessing

import numpy as np
import pytest

import jax

from paddle_tpu.serving import create_engine as j_create_engine
from paddle_tpu.serving import GenerationConfig as JGen
from paddle_tpu.serving import parse_mesh as j_parse_mesh
from paddle_tpu.serving.parallel import validate_tp as j_validate_tp
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.serving import create_engine as t_create_engine
from paddle_tpu_torch.serving import GenerationConfig as TGen
from paddle_tpu_torch.serving.parallel import (mesh_devices, parse_mesh,
                                               validate_tp)
from paddle_tpu_torch.serving.parallel import runner as TR
from paddle_tpu_torch.serving.parallel import worker as W

from torch_serving_tp import (STATS, all_reduces, checked, cpu_ranks, greedy,
                              one_shot, pair, port_state, same_requests,
                              same_stats, tp_model)


@pytest.fixture(scope="module", autouse=True)
def ranks():
    with cpu_ranks(2):
        yield


@pytest.fixture(scope="module")
def model():
    return tp_model()


def _children():
    """This process's worker processes, started or starting."""
    return {p.pid for p in multiprocessing.active_children()}


def test_mesh_one_starts_no_process(model):
    """tp=1 is the single-device runner: it starts no worker, sends no
    message and makes no collective call (this file's tp=2 mesh is
    coming up beside it)."""
    _, np_state, tcfg = model
    before = _children()
    calls = all_reduces()
    sent = W._live.sends if W._live is not None else 0
    eng = t_create_engine(tcfg, port_state(np_state), device="cpu", mesh=1,
                          max_slots=2, page_size=8, max_model_len=64)
    greedy(eng, [np.arange(1, 9, dtype=np.int32)], [4], TGen)
    assert type(eng.runner) is TR.ModelRunner and eng.tp == 1
    assert _children() <= before
    assert all_reduces() == calls
    assert (W._live.sends if W._live is not None else 0) == sent
    assert eng.stats()["mesh_tp"] == 1


def test_mesh_spellings_serve(model):
    """``"tp=2"``, ``(2,)`` and ``FLAGS_serving_mesh_tp=2`` (``mesh=2``:
    the other scenarios) serve at tp=2 on one mesh of workers, to the
    tp=1 engine's tokens and counters; a decode step makes 2 x L
    all-reduces."""
    _, np_state, tcfg = model
    kw = dict(max_slots=2, page_size=8, max_model_len=64)
    prompts = [np.arange(1, 12, dtype=np.int32),
               np.arange(30, 35, dtype=np.int32)]
    one = t_create_engine(tcfg, port_state(np_state), device="cpu", **kw)
    want = greedy(one, prompts, [6, 6], TGen)
    meshes = set()
    for spelling in ("tp=2", (2,), None):
        if spelling is None:
            set_flags({"FLAGS_serving_mesh_tp": 2})
        try:
            te = checked(t_create_engine(tcfg, port_state(np_state),
                                         device="cpu", mesh=spelling, **kw))
        finally:
            set_flags({"FLAGS_serving_mesh_tp": 1})
        assert te.tp == 2 and type(te.runner) is W.MeshRunner
        meshes.add(id(te.runner._mesh))
        calls = all_reduces()
        steps = te.decode_steps
        same_requests(want, greedy(te, prompts, [6, 6], TGen))
        prefill_calls = 2 * 2 * tcfg.num_hidden_layers   # two prompts
        assert all_reduces() - calls == (
            prefill_calls + 2 * tcfg.num_hidden_layers
            * (te.decode_steps - steps))
        same_stats(one, te, [k for k in STATS if k != "mesh_tp"])
    assert len(meshes) == 1          # the workers served every engine


def test_mesh_continuous_batching_parity_no_retrace(model):
    """Staggered arrivals through 2 slots at sync_interval 3 on a tp=2
    mesh: the JAX engine's tokens under the same arrival schedule, one
    decode trace, the same host syncs."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 128, int(n)).astype(np.int32)
               for n in (5, 12, 7, 15, 3, 10)]
    n_new = [4, 7, 3, 6, 5, 4]

    def drive(eng, gen_cls):
        reqs, pending, steps = [], list(zip(prompts, n_new)), 0
        while pending or eng.scheduler.has_work():
            if pending:
                p, n = pending.pop(0)
                reqs.append(eng.submit(p, gen_cls(max_new_tokens=n)))
            eng.step()
            steps += 1
            assert steps < 500
        return reqs

    je, te = pair(model, max_slots=2, page_size=8, max_model_len=64,
                   sync_interval=3, mesh=2)
    same_requests(drive(je, JGen), drive(te, TGen))
    assert te.decode_traces == je.decode_traces == 1
    assert te.host_syncs == je.host_syncs
    same_stats(je, te)


def test_mesh_one_shot_greedy_parity(model):
    """Greedy parity at tp=2 against the JAX engine at the same mesh,
    every rank in step (tp=4: ``test_torch_serving_tp_cache.py``)."""
    one_shot(model, 2)


def test_mesh_prefix_cache_cow_divergence(model):
    """Prefix caching at tp=2: two prompts sharing a 19-token prefix that
    diverge in the last prompt token chain-hit 2 full pages and copy the
    shared tail (the CoW copy runs on every rank's heads), to the JAX
    engine's tokens and counters."""
    a = np.arange(1, 21).astype(np.int32)
    b = a.copy()
    b[19] = 99
    je, te = pair(model, max_slots=2, page_size=8, max_model_len=64,
                   mesh=2, enable_prefix_cache=True)
    same_requests(greedy(je, [a, b], [6, 6], JGen),
                  greedy(te, [a, b], [6, 6], TGen))
    st = te.stats()
    assert st["prefix_hits"] == 2 and st["cow_copies"] == 1
    assert st["cached_tokens"] == 19
    assert te.decode_traces == 1
    same_stats(je, te)


def test_mesh_spec_parsing_and_validation(model):
    """``parse_mesh`` and ``validate_tp`` accept and refuse what the
    reference's do; a mesh larger than the card count is refused naming
    it; a tp that does not divide is refused before any worker starts."""
    for spec in (None, 4, "4", "tp=2", (8,), [2], " TP=4 "):
        assert parse_mesh(spec) == j_parse_mesh(spec)
    for bad, match in (("dp=2", "mesh"), ((2, 4), "mesh"), (0, ">= 1"),
                       ("x", "mesh")):
        for parse in (parse_mesh, j_parse_mesh):
            with pytest.raises(ValueError, match=match):
                parse(bad)
    jm, np_state, tcfg = model
    for tp in (1, 2, 3, 4, 8, 16):
        try:
            j_validate_tp(jm.config, tp)
            want = None
        except ValueError as e:
            want = str(e)
        if want is None:
            validate_tp(tcfg, tp)
        else:
            with pytest.raises(ValueError, match="must divide") as got:
                validate_tp(tcfg, tp)
            assert str(got.value) == want
    live = W._live
    with pytest.raises(ValueError, match="divide"):
        t_create_engine(tcfg, port_state(np_state), device="cpu", mesh=3,
                        max_slots=2, page_size=8, max_model_len=32)
    assert W._live is live
    with pytest.raises(ValueError, match="needs 3 CUDA devices"):
        mesh_devices(3, "cuda")
    assert [str(d) for d in mesh_devices(3, "cpu")] == ["cpu"] * 3
    assert jax.device_count() >= 8
