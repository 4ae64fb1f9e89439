"""paddle_tpu_torch's tensor-parallel engine with quantized weights, at
tp=2, against the JAX engine at the same mesh.

Mirrors the tp=2 cases of ``tests/test_serving_quant.py``: dense and
int8 weights (int8 with int8 KV pages), and int8 at tp=2 equal to int8
at tp=1 (int4 and the LoRA modes: ``test_torch_serving_tp_lora.py``).
The quantized shards split K4's columns (q/k/v, gate, up) or its rows
(o, down; int4 splits its packed rows).  Tokens, finish reasons and
counters equal the JAX engine's; every rank's ring equals rank 0's after
every step.
"""
import numpy as np
import pytest

from paddle_tpu.serving import GenerationConfig as JGen
from paddle_tpu_torch.serving import GenerationConfig as TGen
from paddle_tpu_torch.serving import create_engine as t_create_engine

from torch_serving_tp import (checked, cpu_ranks, greedy, pair, port_state,
                              same_requests, same_stats, tp_model)


@pytest.fixture(scope="module", autouse=True)
def ranks():
    with cpu_ranks(2):
        yield


@pytest.fixture(scope="module")
def model():
    return tp_model()


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(1, 128, int(n)).astype(np.int32)
            for n in (4, 9, 14)]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_tp2_quant_matches_jax(model, quant):
    """Quantized weights (and int8 KV pages) compose with tp: the port's
    tp=2 engine gives the JAX tp=2 engine's tokens and counters, and its
    mesh report shows the int8 pages."""
    kw = dict(max_slots=4, page_size=8, max_model_len=64, mesh=2,
              quant=quant, kv_quant=bool(quant))
    je, te = pair(model, **kw)
    n_new = [8, 6, 8]
    same_requests(greedy(je, _prompts(), n_new, JGen),
                  greedy(te, _prompts(), n_new, TGen))
    assert te.decode_traces == 1
    assert te.runner.mesh_info()["kv_quant"] is bool(quant)
    same_stats(je, te)
    if quant == "int8":
        # the tolerance is dense-vs-quant, never tp-vs-tp: tp=2 int8 is
        # token-exact with tp=1 int8
        _, np_state, tcfg = model
        one = t_create_engine(tcfg, port_state(np_state), device="cpu",
                              **{**kw, "mesh": 1})
        two = checked(t_create_engine(tcfg, port_state(np_state),
                                      device="cpu", **kw))
        same_requests(greedy(one, _prompts(), n_new, TGen),
                      greedy(two, _prompts(), n_new, TGen))
