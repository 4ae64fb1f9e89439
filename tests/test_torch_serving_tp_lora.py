"""paddle_tpu_torch's tensor-parallel engine with int4 weights and with
LoRA adapters, at tp=2, against the JAX engine at the same mesh.

Mirrors the tp=2 cases of ``tests/test_serving_quant.py`` (int4 weights
with int8 KV pages: the row-sharded o and down split int4's packed K/2
rows, each shard's K stays even) and ``tests/test_serving_lora.py`` (two
adapters mixed with dense requests in one batch; the reference holds an
adapter to the merged checkpoint at tp=2, here the JAX engine with the
same adapter bank at tp=2 is the reference).  Each rank's adapter bank
holds its rows of A (o, down) or B (the rest), and the partial deltas
join the layer's two all-reduces.  Tokens, finish reasons and counters
equal the JAX engine's; every rank's ring equals rank 0's after every
step.
"""
import numpy as np
import pytest

from paddle_tpu.serving import AdapterStore as JStore
from paddle_tpu.serving import GenerationConfig as JGen
from paddle_tpu.serving import create_engine as j_create_engine
from paddle_tpu.serving import random_adapter as j_random_adapter
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.serving import AdapterStore
from paddle_tpu_torch.serving import GenerationConfig as TGen
from paddle_tpu_torch.serving import create_engine as t_create_engine

from torch_serving_tp import (checked, cpu_ranks, greedy, pair, port_state,
                              rank_states_equal, same_requests, same_stats,
                              tp_model)

RANK, ALPHA = 4, 8.0


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


def test_tp2_int4_matches_jax(model):
    """int4 weights with int8 KV pages at tp=2: the JAX engine's tokens
    and counters."""
    je, te = pair(model, max_slots=4, page_size=8, max_model_len=64,
                  mesh=2, quant="int4", kv_quant=True)
    n_new = [8, 6, 8]
    same_requests(greedy(je, _prompts(), n_new, JGen),
                  greedy(te, _prompts(), n_new, TGen))
    assert te.decode_traces == 1
    assert te.runner.mesh_info()["kv_quant"] is True
    same_stats(je, te)


def _stores(model):
    jm, _, tcfg = model
    adapters = {"alpha": j_random_adapter(jm.config, RANK, seed=7),
                "beta": j_random_adapter(jm.config, RANK, seed=8)}
    jstore, tstore = JStore(jm.config, capacity=2), \
        AdapterStore(tcfg, capacity=2)
    for name, w in adapters.items():
        jstore.register(name, w, alpha=ALPHA)
        tstore.register(name, TC.adapter_from_numpy(w), alpha=ALPHA)
    return jstore, tstore


def test_tp2_lora_mixed_batch_matches_jax(model):
    """Two adapters and dense requests in one tp=2 batch (one decode-step
    build; the decode step's deltas run K5 on each rank's bank rows):
    the JAX engine's tokens and counters."""
    jm, np_state, tcfg = model
    jstore, tstore = _stores(model)
    kw = dict(max_slots=4, page_size=8, max_model_len=64, mesh=2)
    je = j_create_engine(jm, lora=jstore, **kw)
    te = checked(t_create_engine(tcfg, port_state(np_state), device="cpu",
                                 lora=tstore, **kw))
    prompts = _prompts() + [np.arange(1, 5, dtype=np.int32)]
    names = ["alpha", None, "beta", "alpha"]
    out = []
    for eng, gen in ((je, JGen), (te, TGen)):
        reqs = [eng.submit(p, gen(max_new_tokens=6), adapter=a)
                for p, a in zip(prompts, names)]
        eng.run_until_complete(max_steps=300)
        out.append(reqs)
    same_requests(*out)
    assert te.decode_traces == 1
    assert rank_states_equal(te) == 2
    same_stats(je, te)
    assert te.lora_snapshot()["bank_bytes_device"] > 0
    info = te.runner.mesh_info()["devices"]
    assert info[0]["lora_bank_bytes"] == info[1]["lora_bank_bytes"] > 0
