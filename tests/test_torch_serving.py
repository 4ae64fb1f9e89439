"""paddle_tpu_torch serving engine against the JAX engine.

One JAX ``llama_tiny`` model's weights drive both engines (the port's
with ``device="cpu"``: every kernel wrapper runs its plain version).
Greedy tokens must match token for token under staggered submits over 3
slots, ``sync_interval`` 1 and 4, prefix caching on/off (with a
copy-on-write tail divergence), chunked prefill, a cancel mid-decode, a
do_sample request pinned to greedy by ``top_k=1`` and a priority-1
arrival (preempting a resident when ``preempt=True``) — and the engines'
counters must agree.  The host half is also held differentially:
``BlockManager`` op sequences and ``_pick_token`` sampling.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu.serving import block_manager as JBM
from paddle_tpu.serving import create_engine as j_create_engine
from paddle_tpu.serving.engine import Engine as JEngine
from paddle_tpu.serving.request import GenerationConfig as JGen
from paddle_tpu.serving.request import Request as JRequest
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import block_manager as TBM
from paddle_tpu_torch.serving import create_engine as t_create_engine
from paddle_tpu_torch.serving.engine import Engine as TEngine
from paddle_tpu_torch.serving.request import GenerationConfig as TGen
from paddle_tpu_torch.serving.request import Request as TRequest

STATS = ("decode_steps", "host_syncs", "pages_in_use", "pages_allocated",
         "prefix_hits", "prefix_misses", "cow_copies", "cached_tokens",
         "cached_pages", "prefill_chunks", "max_prefill_gap",
         "decode_traces", "prefill_buckets", "cached_prefill_buckets",
         "logit_fetches", "preemptions", "spilled_pages", "restored_pages",
         "spill_bytes", "host_parked_pages")


@pytest.fixture(scope="module")
def model():
    paddle.seed(0)
    m = LlamaForCausalLM(llama_tiny())
    np_state = {k: np.asarray(v) for k, v in m.functional_state().items()}
    return m, np_state


def _prompts():
    """Lengths 5..16 (page 8: two prefill buckets).  p0/p2/p4 share an
    8-token page; p2 diverges from p0's cached 3-token tail after 2
    tokens (copy-on-write), p4 extends p0 entirely."""
    rng = np.random.RandomState(0)
    shared = rng.randint(0, 512, 8).tolist()
    return [shared + [11, 12, 13],
            rng.randint(0, 512, 5).tolist(),
            shared + [11, 12, 99, 98],
            rng.randint(0, 512, 16).tolist(),
            shared + [11, 12, 13, 14, 15, 16, 17],
            rng.randint(0, 512, 9).tolist()]


# submits per engine step: (step, prompt index, max_new_tokens, sample,
# priority) — prompt 5 outranks the queue it joins
SCHEDULE = [(0, 0, 9, False, 0), (0, 1, 6, False, 0), (1, 2, 8, True, 0),
            (3, 3, 7, False, 0), (4, 4, 12, False, 0), (6, 5, 5, False, 1)]
CANCEL = (9, 4)          # cancel prompt 4's request at step 9

MODES = {
    "sync1": dict(sync_interval=1, emit_logits=True, preempt=False),
    "sync4": dict(sync_interval=4, emit_logits=True, preempt=False),
    "cache_sync1": dict(enable_prefix_cache=True, emit_logits=True,
                        preempt=False),
    "cache_sync4_chunked": dict(enable_prefix_cache=True, sync_interval=4,
                                prefill_chunk=8, preempt=False),
    # the priority-1 arrival preempts a resident (spill to the host
    # tier, resume later) in both engines
    "cache_sync1_preempt": dict(enable_prefix_cache=True, emit_logits=True,
                                preempt=True),
}


def _drive(engine, gen_cls):
    prompts = _prompts()
    reqs = {}
    step = 0
    while step <= max(s for s, *_ in SCHEDULE) or \
            engine.scheduler.has_work():
        for at, i, n, sample, priority in SCHEDULE:
            if at == step:
                gen = gen_cls(max_new_tokens=n, do_sample=sample and
                              engine.emit_logits, top_k=1)
                reqs[i] = engine.submit(prompts[i], gen, priority=priority)
        if step == CANCEL[0]:
            reqs[CANCEL[1]].cancel()
        engine.step()
        step += 1
        assert step < 200
    return [reqs[i] for i in sorted(reqs)]


def _first_token_order(reqs):
    done = [r for r in reqs if r.first_token_at is not None]
    return [r.arrival_seq for r in sorted(done,
                                          key=lambda r: r.first_token_at)]


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax_engine(model, mode):
    jmodel, np_state = model
    kw = dict(max_slots=3, page_size=8, max_model_len=96, **MODES[mode])
    je = j_create_engine(jmodel, **kw)
    te = t_create_engine(TL.llama_tiny(),
                         TC.state_from_numpy(np_state, device="cpu"),
                         device="cpu", **kw)
    jreqs, treqs = _drive(je, JGen), _drive(te, TGen)
    for j, t in zip(jreqs, treqs):
        assert t.output_tokens == j.output_tokens
        assert t.finish_reason == j.finish_reason
        assert t.num_cached_tokens == j.num_cached_tokens
    # the same admission order (priority first, then FCFS)
    assert _first_token_order(treqs) == _first_token_order(jreqs)
    assert treqs[4].finish_reason == "cancelled"
    assert len(treqs[4].output_tokens) < 12
    js, ts = je.stats(), te.stats()
    assert {k: ts[k] for k in STATS} == {k: js[k] for k in STATS}
    assert ts["pages_in_use"] == 0 and ts["decode_traces"] == 1
    assert te.blocks.pool_accounting() == je.blocks.pool_accounting()
    if mode == "cache_sync1":
        assert ts["prefix_hits"] > 0 and ts["cow_copies"] > 0
    if "chunked" in mode:
        # chunked admissions publish their pages only after the last
        # chunk, so cache_sync1's prefix and CoW hits miss here
        assert ts["prefill_chunks"] > 0
    assert ts["preemptions"] == js["preemptions"]
    assert (ts["preemptions"] > 0) == kw["preempt"]


def _block_ops(bm_cls):
    """One op sequence with prefix sharing, CoW, deferred publish, the
    committed-token ledger, the host spill tier and a cache flush."""
    bm = bm_cls(24, 4, enable_prefix_cache=True, host_pages=3)
    log = []
    a = list(range(1, 11))                   # 2 full chunks + tail of 2
    log.append(bm.allocate_seq(1, a, 6))
    log.append(bm.allocate_seq(2, a[:8] + [1, 77], 3))   # CoW on the tail
    log.append(bm.seq_meta(2))
    bm.defer_publish = 4
    log.append(bm.allocate_seq(3, list(range(50, 63)), 2))
    log.append(bm.allocate_seq(4, list(range(50, 63)), 2))  # no match yet
    bm.publish_seq(3, list(range(50, 63)))
    log.append(bm.append(1, 3))
    log.append(bm.rollback(1, 1))
    toks = np.array(a + [5, 6, 7], np.int32)
    for page, digest in bm.spill_plan(1, toks):
        bm.host_put(digest, np.zeros((2, 4)), np.ones((2, 4)))
    bm.release_preempted(1, toks)
    log.append(bm.allocate_seq(5, list(range(50, 63)), 1))  # chain hit
    bm.free_seq(2)
    log.append(bm.pool_accounting())
    log.append(bm.flush_prefix_cache())
    log.append(bm.replay_plan(5, list(range(50, 63))))
    log.append(bm.allocate_seq(6, list(range(90, 200)), 0))  # backpressure
    for sid in (3, 4, 5):
        bm.free_seq(sid)
    log.append(bm.prefix_digest())
    log.append(bm.pool_bytes(num_layers=2, num_kv_heads=4, head_dim=8,
                             dtype_itemsize=2, tp=2))
    log.append((bm.seq_footprint(5), bm.committed_pages(5)))
    log.append((bm.pool_accounting(), bm.pages_in_use, bm.cached_pages,
                bm.prefix_hits, bm.prefix_misses, bm.cow_copies,
                bm.cached_tokens, bm.pages_allocated, bm.spilled_pages,
                bm.fragmentation(5)))
    return log


def test_block_manager_differential():
    assert _block_ops(TBM.BlockManager) == _block_ops(JBM.BlockManager)


@pytest.mark.parametrize("gen", [
    dict(), dict(do_sample=True, seed=3),
    dict(do_sample=True, temperature=0.7, top_k=5, seed=1),
    dict(do_sample=True, top_p=0.8, seed=2)])
def test_pick_token_matches_jax(gen):
    rng = np.random.RandomState(9)
    logits = (rng.randn(64) * 3).astype(np.float32)
    picks = []
    for engine_cls, req_cls, gen_cls in ((JEngine, JRequest, JGen),
                                         (TEngine, TRequest, TGen)):
        req = req_cls([1, 2, 3], gen_cls(**gen))
        req.id = 42                  # the per-request RNG keys on the id
        fake = types.SimpleNamespace(_rngs={})
        picks.append([engine_cls._pick_token(fake, req, logits)
                      for _ in range(5)])
    assert picks[0] == picks[1]


# every engine option is ported, tensor parallelism included: a mesh
# whose tp does not divide the heads (llama_tiny: 4 q over 2 kv heads)
# is refused first, before any mode that rides with it is built (the
# tp=2 engine: tests/test_torch_serving_tp*.py)
@pytest.mark.parametrize("kw", [dict(mesh=3), dict(quant="int8", mesh=3),
                                dict(lora=object(), mesh=3),
                                dict(usage=object(), mesh=3),
                                dict(requestlog=object(), mesh=3),
                                dict(slo=object(), mesh=3)])
def test_later_slice_options_raise(kw):
    state = TC.init_state(TL.llama_tiny(num_hidden_layers=1),
                          torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="tp=3 must divide"):
        t_create_engine(TL.llama_tiny(num_hidden_layers=1), state,
                        device="cpu", **kw)
