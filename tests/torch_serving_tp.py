"""Shared pieces of the port's tensor-parallel serving tests (not a test
module).

The model is the reference's own tp test model (``tests/test_serving_tp.py:
tp_model``: 8 q heads over 8 kv heads, FFN width 128, so tp 2, 4 and 8
divide; head_dim 8).  The JAX engine runs on the 8 virtual CPU devices
of ``tests/conftest.py``; the port's ranks are gloo processes on the CPU
(``device="cpu"``), started once per test file by :func:`cpu_ranks` and
stopped at its end.  Every rank and the test process run one torch
thread: the ranks' processes would otherwise share the cores many times
over, and all of them round their replicated parts alike.

:func:`checked` wraps an engine's ``step`` so that after every step each
rank's ring, positions and next tokens are compared with rank 0's: a
rank that fed another token back would write its heads of the KV for a
different token, and the output would go wrong silently.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving.parallel import worker as W

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_attention_heads=8, num_key_value_heads=8)

# counters both engines keep, compared after every scenario
STATS = ("decode_steps", "host_syncs", "pages_in_use", "pages_allocated",
         "prefix_hits", "prefix_misses", "prefix_evictions", "cow_copies",
         "cached_tokens", "cached_pages", "prefill_chunks",
         "max_prefill_gap", "decode_traces", "prefill_buckets",
         "cached_prefill_buckets", "logit_fetches", "preemptions",
         "spilled_pages", "restored_pages", "spill_bytes",
         "host_parked_pages", "mesh_tp", "quant", "kv_quant")


def tp_model():
    """(the JAX model, its numpy state, the port's config)."""
    paddle.seed(23)
    cfg = llama_tiny(**CFG)
    model = LlamaForCausalLM(cfg)
    model.eval()
    np_state = {k: np.asarray(v) for k, v in model.functional_state().items()}
    return model, np_state, TL.llama_tiny(**CFG)


def port_state(np_state):
    return TC.state_from_numpy(np_state, device="cpu")


@contextlib.contextmanager
def cpu_ranks(tp=None):
    """One torch thread here and in every rank; the live mesh stopped at
    the end.  ``tp``: start that mesh at once, in a thread, so that its
    workers come up while the first JAX engine compiles (the first
    engine at that tp waits for it in ``worker.get_mesh``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    start = None
    if tp is not None:
        start = threading.Thread(target=W.get_mesh, args=(tp, "cpu"),
                                 daemon=True)
        start.start()
    try:
        yield
    finally:
        if start is not None:
            start.join()
        W.shutdown_meshes()
        torch.set_num_threads(threads)


def rank_states_equal(engine):
    """Every rank's ring, pos and tok equal rank 0's."""
    states = engine.runner.rank_states()
    for r, s in enumerate(states[1:], 1):
        for key in ("ring", "pos", "tok"):
            assert np.array_equal(s[key], states[0][key]), (
                f"rank {r}'s {key} differs from rank 0's")
    return len(states)


def checked(engine):
    """``engine`` with its ``step`` followed by :func:`rank_states_equal`
    (at tp > 1)."""
    if engine.tp == 1:
        return engine
    step = engine.step

    def step_and_check():
        out = step()
        rank_states_equal(engine)
        return out

    engine.step = step_and_check
    return engine


def all_reduces():
    return obs.metric_value("collective_calls_total", {"op": "all_reduce"})


def same_requests(jreqs, treqs):
    for j, t in zip(jreqs, treqs):
        assert t.output_tokens == j.output_tokens
        assert t.finish_reason == j.finish_reason


def same_stats(je, te, keys=STATS):
    js, ts = je.stats(), te.stats()
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}


def greedy(eng, prompts, n_new, gen_cls):
    """Submit every prompt at once and run the engine dry."""
    reqs = [eng.submit(p, gen_cls(max_new_tokens=n))
            for p, n in zip(prompts, n_new)]
    eng.run_until_complete(max_steps=500)
    return reqs


def pair(model, **kw):
    """The JAX engine and the port's (checked), on the same weights and
    options."""
    from paddle_tpu.serving import create_engine as j_create_engine
    from paddle_tpu_torch.serving import create_engine as t_create_engine
    jm, np_state, tcfg = model
    je = j_create_engine(jm, **kw)
    te = checked(t_create_engine(tcfg, port_state(np_state), device="cpu",
                                 **kw))
    return je, te


def one_shot(model, tp):
    """``test_serving_tp.py``'s one-shot greedy scenario at ``tp``."""
    from paddle_tpu.serving import GenerationConfig as JGen
    from paddle_tpu_torch.serving import GenerationConfig as TGen
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 128, int(n)).astype(np.int32)
               for n in (4, 9, 14)]
    n_new = [8, 6, 8]
    je, te = pair(model, max_slots=4, page_size=8, max_model_len=64,
                  mesh=tp)
    same_requests(greedy(je, prompts, n_new, JGen),
                  greedy(te, prompts, n_new, TGen))
    assert te.decode_traces == 1
    assert te.stats()["mesh_tp"] == tp
    assert te.stats()["pages_in_use"] == 0
    assert rank_states_equal(te) == tp
    same_stats(je, te)
    return te
