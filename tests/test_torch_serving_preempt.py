"""paddle_tpu_torch preempt -> spill -> resume against the JAX engine.

Mirrors the tp=1 preemption cases of ``tests/test_overload.py``,
``tests/test_serving_quant.py`` and ``tests/test_serving_lora.py``: two
low-priority residents decode, a priority-1 request arrives with both
slots taken, the lowest-class most-recently-admitted resident spills its
exclusive KV pages to the host tier and resumes later.  One JAX
``llama_tiny`` model's weights drive both engines (the port's on the
CPU, every kernel's plain version); the port must give the JAX engine's
tokens, finish reasons, preemption / spill / restore counters (bytes
included), per-request ledgers and pool census — and the tokens of an
uninterrupted run.  Cache off and on and a chunked resume are modes of
one test (deferred host syncs, int8 KV pages and LoRA adapters:
``test_torch_serving_preempt_modes.py``; ``spill_fail`` and repeated
churn: ``test_torch_serving_preempt_faults.py``); ``preempt=False``
(strict FCFS) and the flag's default of True are cases of their own,
and the scheduler's victim choice is held against the reference's.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu.serving import AdapterStore as JStore
from paddle_tpu.serving import BlockManager as JBlockManager
from paddle_tpu.serving import FaultPlan as JFaultPlan
from paddle_tpu.serving import GenerationConfig as JGen
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu.serving import random_adapter as j_random_adapter
from paddle_tpu.serving.engine import Engine as JEngine
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import AdapterStore, BlockManager, \
    FaultPlan, Request, RequestState, Scheduler
from paddle_tpu_torch.serving import GenerationConfig as TGen
from paddle_tpu_torch.serving import create_engine as t_create_engine

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=128)
LO = ([1, 2, 3, 4, 5, 6], [3, 4, 5, 6, 7, 8])
HI = [5, 6, 7, 8, 9, 10]
RANK, ALPHA = 4, 8.0
STATS = ("preemptions", "spill_aborts", "spilled_pages", "restored_pages",
         "spill_bytes", "host_parked_pages", "decode_steps", "host_syncs",
         "pages_in_use", "pages_allocated", "prefix_hits", "prefix_misses",
         "prefix_evictions", "cow_copies", "cached_tokens", "cached_pages",
         "prefill_chunks", "max_prefill_gap", "decode_traces",
         "prefill_buckets", "cached_prefill_buckets", "quarantines",
         "faults_injected")
LEDGER = ("preemptions", "spilled_pages", "spill_bytes", "restored_pages",
          "restore_bytes", "prefill_cached_tokens",
          "prefill_computed_tokens", "prefill_chunks", "num_cached_tokens",
          "finish_reason")


@pytest.fixture(scope="module")
def tiny():
    paddle.seed(0)
    jcfg = llama_tiny(**CFG)
    model = LlamaForCausalLM(jcfg)
    model.eval()
    jstate = {k: (v._data if isinstance(v, Tensor) else v)
              for k, v in model.functional_state().items()}
    np_adapters = {"alpha": j_random_adapter(jcfg, RANK, seed=7)}
    return {"jcfg": jcfg, "jstate": jstate,
            "np_state": {k: np.asarray(v) for k, v in jstate.items()},
            "np_adapters": np_adapters,
            "adapters": {k: TC.adapter_from_numpy(v)
                         for k, v in np_adapters.items()}}


def _stores(s):
    jstore = JStore(s["jcfg"], capacity=2)
    tstore = AdapterStore(TL.llama_tiny(**CFG), capacity=2)
    for name in s["adapters"]:
        jstore.register(name, s["np_adapters"][name], alpha=ALPHA)
        tstore.register(name, s["adapters"][name], alpha=ALPHA)
    return jstore, tstore


def engines(s, lora=False, faults=None, **kw):
    """(JAX engine, port engine) over the same weights; ``faults`` is a
    ``(site, rule)`` list each engine builds its own plan from."""
    kw = {"max_slots": 2, "page_size": 4, "max_model_len": 128,
          "sync_interval": 1, **kw}
    jkw, tkw = dict(kw), dict(kw)
    if lora:
        jkw["lora"], tkw["lora"] = _stores(s)
    if faults is not None:
        jkw["faults"], tkw["faults"] = JFaultPlan(seed=0), FaultPlan(seed=0)
        for site, rule in faults:
            jkw["faults"].add(site, **rule)
            tkw["faults"].add(site, **rule)
    return (JEngine(config=s["jcfg"], state=dict(s["jstate"]), **jkw),
            t_create_engine(TL.llama_tiny(**CFG),
                            TC.state_from_numpy(s["np_state"],
                                                device="cpu"),
                            device="cpu", **tkw))


def overload(eng, gen_cls, adapter=None, n_new=8):
    """Two low-priority residents decode 4 steps, then a priority-1
    request arrives with both slots taken."""
    lo = [eng.submit(p, gen_cls(max_new_tokens=n_new), adapter=adapter)
          for p in LO]
    for _ in range(4):
        eng.step()
    hi = eng.submit(HI, gen_cls(max_new_tokens=n_new), priority=1)
    eng.run_until_complete(max_steps=600)
    return lo + [hi]


def same(je, jreqs, te, treqs, keys=STATS):
    """Tokens, per-request ledgers, ``stats()`` keys and the census."""
    assert [r.output_tokens for r in treqs] == \
        [r.output_tokens for r in jreqs]
    assert [[getattr(r, k) for k in LEDGER] for r in treqs] == \
        [[getattr(r, k) for k in LEDGER] for r in jreqs]
    js, ts = je.stats(), te.stats()
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert te.blocks.pool_accounting() == je.blocks.pool_accounting()
    assert ts["pages_in_use"] == 0
    assert te.blocks.pool_accounting()["leak"] == 0
    return ts


MODES = {
    "cache_off": dict(enable_prefix_cache=False),
    "cache_on": dict(enable_prefix_cache=True),
    "chunked_resume": dict(enable_prefix_cache=False, prefill_chunk=4),
}


def check_preempt_mode(tiny, kw):
    """The overload scenario on both engines in one mode, and the
    port against an uninterrupted run."""
    adapter = "alpha" if kw.get("lora") else None
    je, te = engines(tiny, preempt=True, **kw)
    jreqs = overload(je, JGen, adapter)
    treqs = overload(te, TGen, adapter)
    ts = same(je, jreqs, te, treqs)
    assert ts["preemptions"] == 1 and te.preempt
    assert sorted(r.preemptions for r in treqs) == [0, 0, 1]
    assert all(r.finish_reason == "length" for r in treqs)
    assert ts["spilled_pages"] >= 1 or kw["enable_prefix_cache"]
    assert ts["restored_pages"] >= 1 or kw["enable_prefix_cache"]
    assert ts["decode_traces"] == 1
    # greedy parity with an uninterrupted run (3 slots: nobody waits)
    _, ref = engines(tiny, max_slots=3, preempt=False, **kw)
    want = overload(ref, TGen, adapter)
    assert ref.preemptions == 0
    assert [r.output_tokens for r in treqs] == \
        [r.output_tokens for r in want]
    if adapter is not None:
        assert te.lora.snapshot()["pinned"] == {}


# deferred syncs, int8 KV pages and LoRA adapters:
# test_torch_serving_preempt_modes.py
@pytest.mark.parametrize("mode", list(MODES))
def test_preempt_spill_resume_matches_jax_engine(tiny, mode):
    check_preempt_mode(tiny, MODES[mode])


def test_preempt_false_is_strict_fcfs(tiny):
    je, te = engines(tiny, preempt=False)
    jreqs, treqs = overload(je, JGen), overload(te, TGen)
    ts = same(je, jreqs, te, treqs)
    assert ts["preemptions"] == 0
    assert all(r.preemptions == 0 for r in treqs)
    # the priority-1 request waited for a resident to finish
    assert treqs[2].first_token_at >= min(r.finished_at for r in treqs[:2])


def test_preempt_flag_defaults_true_on_both(tiny):
    """With no ``preempt`` argument both engines follow
    FLAGS_serving_preempt (True) and preempt under priority traffic."""
    from paddle_tpu.flags import FLAGS as JFLAGS
    assert JFLAGS["FLAGS_serving_preempt"] is True
    assert FLAGS["FLAGS_serving_preempt"] is True
    je, te = engines(tiny)
    assert je.preempt is True and te.preempt is True
    jreqs, treqs = overload(je, JGen), overload(te, TGen)
    assert same(je, jreqs, te, treqs)["preemptions"] == 1


# ------------------------------------------------- scheduler victim choice
def _sched_case(sched_cls, bm_cls, req_cls, gen_cls, callback_ok):
    """Three DECODE residents (classes -1, -1, 0; the second admitted
    last) and a priority-1 head: which slot the scheduler hands to the
    preempt callback, and what it does with the answer."""
    sched = sched_cls(bm_cls(num_pages=12, page_size=4), 3)
    asked = []
    sched._preempt = lambda slot: asked.append(slot) or callback_ok
    reqs = [req_cls(np.arange(1, 5), gen_cls(max_new_tokens=8),
                    priority=p) for p in (-1, -1, 0)]
    for i, r in enumerate(reqs):
        sched.submit(r)
        sched.schedule(now=float(i if i != 1 else 5))
        r.state = type(r.state).DECODE
    head = req_cls(np.arange(1, 5), gen_cls(max_new_tokens=8), priority=1)
    sched.submit(head)
    admitted = sched.schedule(now=9.0)
    return (asked, [r.preemptions for r in reqs],
            [r.state.value for r in reqs], [s for s, _ in admitted],
            len(sched.queue))


@pytest.mark.parametrize("callback_ok", [True, False])
def test_victim_choice_matches_reference(callback_ok):
    want = _sched_case(JScheduler, JBlockManager, JRequest, JGen,
                       callback_ok)
    got = _sched_case(Scheduler, BlockManager, Request, TGen, callback_ok)
    assert got == want
    assert got[0][0] == 1           # lowest class, most recently admitted
    if not callback_ok:
        assert got[1] == [0, 0, 0] and got[3] == []


def test_preempt_never_targets_equal_or_higher_class():
    sched = Scheduler(BlockManager(num_pages=64, page_size=4), 1)
    asked = []
    sched._preempt = lambda slot: asked.append(slot) or True
    a = Request(np.arange(1, 5), TGen(max_new_tokens=2), priority=1)
    sched.submit(a)
    sched.schedule(now=0.0)
    a.state = RequestState.DECODE
    sched.submit(Request(np.arange(1, 5), TGen(max_new_tokens=2),
                         priority=1))
    assert sched.schedule(now=1.0) == [] and asked == []


def _fair_share_victim(sched_cls, bm_cls, req_cls, gen_cls, usage):
    """Three low-class residents; the most recently admitted one is of
    tenant "b", the two before it of tenant "a".  A priority-1 arrival
    asks for one victim."""
    sched = sched_cls(bm_cls(num_pages=12, page_size=4), 3)
    sched.usage = usage
    asked = []
    sched._preempt = lambda slot: asked.append(slot) or True
    for i, tenant in enumerate(("a", "a", "b")):
        r = req_cls(np.arange(1, 5), gen_cls(max_new_tokens=8),
                    tenant=tenant)
        sched.submit(r)
        sched.schedule(now=float(i))
        r.state = type(r.state).DECODE
    sched.submit(req_cls(np.arange(1, 5), gen_cls(max_new_tokens=8),
                         priority=1))
    sched.schedule(now=9.0)
    return asked


def test_fair_share_flag_names_the_usage_slice(monkeypatch):
    """FLAGS_serving_fair_share reads the usage meter: within the lowest
    class the heaviest-page-second tenant's resident is preempted first,
    on both packages; without a meter the flag changes nothing."""
    from paddle_tpu.flags import FLAGS as JFLAGS
    monkeypatch.setitem(FLAGS, "FLAGS_serving_fair_share", True)
    monkeypatch.setitem(JFLAGS, "FLAGS_serving_fair_share", True)
    heavy_a = type("Meter", (), {"heaviest_tenant": lambda self: "a"})()
    for usage, want in ((None, [2]), (heavy_a, [1])):
        got = [_fair_share_victim(Scheduler, BlockManager, Request, TGen,
                                  usage),
               _fair_share_victim(JScheduler, JBlockManager, JRequest,
                                  JGen, usage)]
        assert got == [want, want]
