"""The port's serving shards against the reference runner's placed state,
and the worker mesh's failure paths.

``models/convert.py:shard_serving_state`` (what rank 0 scatters to each
rank) must give, per rank, the addressable shard of the reference
``ModelRunner(tp=2)``'s placed leaf on that device: dense weights,
int8 and int4 :class:`QuantizedWeight` values, scales and logical K, and
the LoRA bank rows (``shard_serving_adapter`` against the reference's
placed bank after ``load_adapter``).  The refusals (fused weights,
leaves that are not arrays, quantized rows tp does not divide) match
the reference's, and are made on rank 0 before any worker enters a
collective: the mesh serves on afterwards.  Then the failures: a
worker's exception reaches rank 0 with that rank's traceback, and a
worker that dies fails rank 0's next call, naming the rank, without a
hang; every worker process is stopped at the end.
"""
import multiprocessing
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import quant_matmul as JQM
from paddle_tpu.serving import ModelRunner as JRunner
from paddle_tpu.serving import random_adapter as j_random_adapter
from paddle_tpu.serving.quantize import quantize_state as j_quantize_state
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.ops.pallas import quant_matmul as TQM
from paddle_tpu_torch.serving import GenerationConfig as TGen
from paddle_tpu_torch.serving import create_engine as t_create_engine
from paddle_tpu_torch.serving import quantize_state
from paddle_tpu_torch.serving.parallel import runner as TR
from paddle_tpu_torch.serving.parallel import worker as W

from torch_serving_tp import cpu_ranks, greedy, port_state, tp_model

RUNNER_KW = dict(max_slots=2, page_size=8, table_width=4, num_pages=8,
                 dump_page=8)


@pytest.fixture(scope="module", autouse=True)
def ranks():
    with cpu_ranks(2):
        yield


@pytest.fixture(scope="module")
def model():
    return tp_model()


def _np(t):
    return t.float().numpy() if t.dtype != torch.int8 else t.numpy()


def _shards(arr):
    """The reference's placed shards of ``arr``, in device order."""
    return [np.asarray(s.data) for s in
            sorted(arr.addressable_shards, key=lambda s: s.device.id)]


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_shards_equal_the_reference_placement(model, quant):
    jm, np_state, _ = model
    jstate = {k: jnp.asarray(v) for k, v in np_state.items()}
    tstate = port_state(np_state)
    if quant:
        jstate = j_quantize_state(jstate, kind=quant)
        tstate = quantize_state(tstate, kind=quant)
    jr = JRunner(jm.config, jstate, tp=2, **RUNNER_KW)
    ranks = [TC.shard_serving_state(tstate, 2, r) for r in range(2)]
    for key, placed in jr.state.items():
        if isinstance(placed, JQM.QuantizedWeight):
            for part in ("q", "scale"):
                for r, want in enumerate(_shards(getattr(placed, part))):
                    got = getattr(ranks[r][key], part)
                    np.testing.assert_array_equal(_np(got), want, key)
            assert all(ranks[r][key].k == placed.k for r in range(2)), key
            assert ranks[0][key].kind == placed.kind
            continue
        for r, want in enumerate(_shards(placed)):
            np.testing.assert_array_equal(_np(ranks[r][key]), want, key)
    # tp=1 is the state itself
    one = TC.shard_serving_state(tstate, 1, 0)
    assert all(one[k] is tstate[k] for k in tstate)


def test_adapter_rows_equal_the_reference_bank(model):
    jm, np_state, tcfg = model
    jr = JRunner(jm.config, {k: jnp.asarray(v) for k, v in np_state.items()},
                 tp=2, lora_slots=2, lora_rank=4, **RUNNER_KW)
    w = j_random_adapter(jm.config, 4, seed=7)
    a = {k: v[0] for k, v in w.items()}
    b = {k: v[1] for k, v in w.items()}
    jr.load_adapter(1, a, b, 2.0)
    ta, tb = TC.adapter_from_numpy(w), None
    ta, tb = {k: v[0] for k, v in ta.items()}, {k: v[1] for k, v in ta.items()}
    for r in range(2):
        ra, rb = TC.shard_serving_adapter(ta, tb, 2, r)
        for half, got in (("a", ra), ("b", rb)):
            for key, placed in jr.lora[half].items():
                want = _shards(placed)[r][:, 1]
                np.testing.assert_array_equal(got[key].numpy(), want,
                                              f"{half}.{key}")


def test_unshardable_states_are_refused_before_any_collective(model):
    """The reference's refusals, on rank 0 before a message goes out: the
    mesh serves the next engine."""
    jm, np_state, tcfg = model
    tstate = port_state(np_state)
    kw = dict(max_slots=2, page_size=8, max_model_len=32, mesh=2)
    fused = dict(tstate)
    fused["llama.layers.0.self_attn.qkv_fused.weight"] = torch.zeros(64, 192)
    leaf = dict(tstate)
    leaf["llama.layers.0.self_attn.q_proj.weight"] = object()
    q8 = quantize_state(tstate, kind="int8")
    key = "llama.layers.0.mlp.down_proj.weight"
    odd = dict(q8)
    odd[key] = TQM.QuantizedWeight(torch.cat([q8[key].q, q8[key].q[:1]]),
                                   q8[key].scale, kind="int8",
                                   k=q8[key].k + 1)
    jstate = {k: jnp.asarray(v) for k, v in np_state.items()}
    jq8 = j_quantize_state(jstate, kind="int8")
    jodd = dict(jq8)
    jodd[key] = JQM.QuantizedWeight(
        jnp.concatenate([jq8[key].q, jq8[key].q[:1]]), jq8[key].scale,
        kind="int8", k=jq8[key].k + 1)
    cases = (
        (fused, {**jstate, "llama.layers.0.self_attn.qkv_fused.weight":
                 np.zeros((64, 192), np.float32)}, "fused"),
        (leaf, {**jstate, "llama.layers.0.self_attn.q_proj.weight":
                object()}, "not an array"),
        (odd, jodd, "not divisible by tp"))
    for tbad, jbad, match in cases:
        with pytest.raises(ValueError, match=match):
            JRunner(jm.config, jbad, tp=2, **RUNNER_KW)
        with pytest.raises(ValueError, match=match):
            t_create_engine(tcfg, tbad, device="cpu", **kw)
    eng = t_create_engine(tcfg, tstate, device="cpu", **kw)
    one = t_create_engine(tcfg, tstate, device="cpu", max_slots=2,
                          page_size=8, max_model_len=32)
    prompt = [np.arange(3, 9, dtype=np.int32)]
    assert [r.output_tokens for r in greedy(eng, prompt, [4], TGen)] == \
        [r.output_tokens for r in greedy(one, prompt, [4], TGen)]


def test_mesh_runner_forwards_every_device_call():
    for name in W.CALLS:
        assert getattr(W.MeshRunner, name) is not \
            getattr(TR.ModelRunner, name), name


def test_wire_keeps_tensor_bits():
    g = torch.Generator().manual_seed(0)
    x = {"bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
         "i8": torch.randint(-127, 127, (4,), dtype=torch.int8,
                             generator=g),
         "f32": (torch.randn(2, generator=g), 7, "s")}
    back = W._unpack(W._pack(x))
    assert torch.equal(back["bf16"], x["bf16"])
    assert back["bf16"].dtype == torch.bfloat16
    assert torch.equal(back["i8"], x["i8"])
    assert torch.equal(back["f32"][0], x["f32"][0])
    assert back["f32"][1:] == (7, "s")


def test_worker_exception_reaches_rank0_with_its_traceback(model):
    _, np_state, tcfg = model
    eng = t_create_engine(tcfg, port_state(np_state), device="cpu", mesh=2,
                          max_slots=2, page_size=8, max_model_len=32)
    mesh = eng.runner._mesh
    seq = mesh.send(eng.runner._rid, "no_such_call", reply=True)
    with pytest.raises(W.WorkerError, match=r"rank 1: raised:\n"
                       r"Traceback(.|\n)*AttributeError(.|\n)*no_such_call"
                       ) as err:
        mesh.replies(seq)
    assert err.value.rank == 1
    # a failed mesh stays failed: the engine's next call raises at once
    with pytest.raises(W.WorkerError, match="failed earlier"):
        eng.runner.push_slot(0, np.zeros(4, np.int32), 0, 0, 0)


def test_dead_worker_fails_the_next_call_without_a_hang(model):
    """A killed worker fails rank 0's next call, naming its rank, well
    within the mesh's timeout; closing the engine stops every process."""
    _, np_state, tcfg = model
    eng = t_create_engine(tcfg, port_state(np_state), device="cpu", mesh=2,
                          max_slots=2, page_size=8, max_model_len=32)
    mesh = eng.runner._mesh
    assert mesh.failed is None           # a new mesh after the last test
    req = eng.submit(np.arange(1, 7, dtype=np.int32), TGen(max_new_tokens=8))
    eng.step()
    eng.step()
    proc = mesh._procs[0]
    proc.kill()
    proc.join()
    t0 = time.monotonic()
    with pytest.raises(W.WorkerError, match=r"rank 1: died \(exit code"):
        for _ in range(8):
            eng.step()
    assert time.monotonic() - t0 < W.TIMEOUT_S
    assert not req.is_finished() or req.finish_reason == "error"
    pids = set(mesh.pids)
    eng.close()
    assert W._live is None
    assert not pids & {p.pid for p in multiprocessing.active_children()}
