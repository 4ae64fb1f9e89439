"""paddle_tpu_torch speculative decoding against the JAX engine, at tp=1.

Mirrors the tp=1 cases of ``tests/test_serving_spec.py``: one JAX
``llama_tiny`` model's weights drive both engines (the port's with
``device="cpu"``, every kernel's plain version), and for spec_k
{0, 2, 4} x prefix cache x sync_interval {1, 4} the port must give the
JAX engine's greedy tokens, finish reasons, speculation counters and
pool census — and the plain greedy tokens, which the verify program
may only reach in fewer steps (sync_interval 4, the eviction
mid-speculation and the churn case: ``test_torch_serving_spec_sync.py``).
Also: a finish inside a verify row, the runner's verify step refused at
spec_k 0 and the flag default, the verify batch's KV writes, and the
drafter and its bookkeeping against the reference's on the same seeded
histories.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu.serving import GenerationConfig as JGen
from paddle_tpu.serving import NgramProposer as JNgram
from paddle_tpu.serving import SpecStats as JSpecStats
from paddle_tpu.serving import create_engine as j_create_engine
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import GenerationConfig as TGen
from paddle_tpu_torch.serving import NgramProposer as TNgram
from paddle_tpu_torch.serving import RequestState
from paddle_tpu_torch.serving import SpecStats as TSpecStats
from paddle_tpu_torch.serving import create_engine as t_create_engine

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_attention_heads=8, num_key_value_heads=8)
# repetitive prompts (the n-gram drafter fires), one novel prompt (it
# degrades to plain decode), one sharing a page-aligned prefix
PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6],
           [9, 3, 9, 3, 9, 3, 9, 3, 9, 3],
           [11, 12, 13, 14],
           [5, 6, 7, 5, 6, 7, 5, 9]]
N_NEW = [12, 10, 8, 12]
STATS = ("spec_k", "verify_traces", "decode_traces", "decode_steps",
         "host_syncs", "pages_in_use", "pages_allocated", "prefix_hits",
         "prefix_misses", "cow_copies", "cached_tokens", "cached_pages",
         "prefill_buckets", "cached_prefill_buckets")
SPEC_STATS = ("spec_proposed", "spec_accepted", "spec_rejected",
              "spec_verify_steps", "spec_committed_tokens",
              "spec_acceptance_rate")


@pytest.fixture(scope="module")
def tiny():
    paddle.seed(31)
    model = LlamaForCausalLM(llama_tiny(**CFG))
    model.eval()
    np_state = {k: np.asarray(v._data if isinstance(v, Tensor) else v)
                for k, v in model.functional_state().items()}
    return model, np_state


def _engines(tiny, clock=None, **kw):
    """(JAX engine, port engine) over the same weights; ``clock`` is a
    factory, so each engine gets a clock of its own."""
    model, np_state = tiny
    kw = {"max_slots": 4, "page_size": 8, "max_model_len": 64, **kw}
    if clock is not None:
        return (j_create_engine(model, clock=clock(), **kw),
                t_create_engine(TL.llama_tiny(**CFG),
                                TC.state_from_numpy(np_state, device="cpu"),
                                device="cpu", clock=clock(), **kw))
    return (j_create_engine(model, **kw),
            t_create_engine(TL.llama_tiny(**CFG),
                            TC.state_from_numpy(np_state, device="cpu"),
                            device="cpu", **kw))


def _run(eng, gen_cls):
    reqs = [eng.submit(np.array(p, np.int32), gen_cls(max_new_tokens=n))
            for p, n in zip(PROMPTS, N_NEW)]
    eng.run_until_complete(max_steps=500)
    return reqs


def _same(je, jreqs, te, treqs, keys=STATS):
    assert [r.output_tokens for r in treqs] == \
        [r.output_tokens for r in jreqs]
    assert [r.finish_reason for r in treqs] == \
        [r.finish_reason for r in jreqs]
    js, ts = je.stats(), te.stats()
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert te.blocks.pool_accounting() == je.blocks.pool_accounting()
    assert [(r.spec_proposed_tokens, r.spec_accepted_tokens)
            for r in treqs] == [(r.spec_proposed_tokens,
                                 r.spec_accepted_tokens) for r in jreqs]
    return ts


@pytest.fixture(scope="module")
def plain(tiny):
    """The canonical greedy tokens: spec off, cache off, per-step sync."""
    _, te = _engines(tiny)
    return [r.output_tokens for r in _run(te, TGen)]


def check_spec_cell(tiny, plain, spec_k, cache, sync_interval):
    """One cell of the speculation matrix: the port against the JAX
    engine, and both against the plain greedy tokens."""
    je, te = _engines(tiny, spec_k=spec_k, enable_prefix_cache=cache,
                      sync_interval=sync_interval)
    jreqs, treqs = _run(je, JGen), _run(te, TGen)
    ts = _same(je, jreqs, te, treqs,
               STATS + (SPEC_STATS if spec_k else ()))
    assert [r.output_tokens for r in treqs] == plain
    assert all(r.state == RequestState.DONE for r in treqs)
    assert ts["pages_in_use"] == 0
    assert te.blocks.pool_accounting()["leak"] == 0
    if spec_k:
        assert ts["decode_traces"] == 2 and ts["verify_traces"] == 1
        # repetitive prompts must speculate: a drafter that never fires
        # would pass parity vacuously
        assert ts["spec_proposed"] > 0 and ts["spec_verify_steps"] > 0
        assert ts["spec_accepted"] + ts["spec_rejected"] \
            == ts["spec_proposed"]
        # fewer device steps than tokens: verify rows commit > 1 token
        assert ts["decode_steps"] < sum(N_NEW)
    else:
        assert ts["decode_traces"] == 1 and ts["verify_traces"] == 0


# sync_interval 4 (deferred host sync): test_torch_serving_spec_sync.py
@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("spec_k", [0, 2, 4])
def test_spec_matches_jax_engine(tiny, plain, spec_k, cache):
    check_spec_cell(tiny, plain, spec_k, cache, sync_interval=1)


def test_finish_inside_verify_row(tiny, plain):
    """A request whose last tokens commit inside one verify row stops
    exactly at max_new_tokens, and every page frees."""
    je, te = _engines(tiny, spec_k=4)
    jreqs, treqs = _run(je, JGen), _run(te, TGen)
    _same(je, jreqs, te, treqs, STATS + SPEC_STATS)
    assert [len(r.output_tokens) for r in treqs] == N_NEW
    assert [r.output_tokens for r in treqs] == plain
    assert te.blocks.pages_in_use == 0


def test_verify_step_needs_spec_k(tiny):
    _, te = _engines(tiny)
    with pytest.raises(RuntimeError, match="spec_k=0"):
        te.runner.verify_step(np.zeros((4, 1), np.int32),
                              np.zeros((4,), np.int32))


def test_spec_k_flag_and_validation(tiny, monkeypatch):
    from paddle_tpu_torch.flags import FLAGS
    monkeypatch.setitem(FLAGS, "FLAGS_serving_spec_k", 3)
    _, te = _engines(tiny)
    assert te.spec_k == 3 and te.stats()["spec_k"] == 3
    assert tuple(te.runner._ring_dev.shape) == (1, 4, 4)
    with pytest.raises(ValueError, match="spec_k"):
        _engines(tiny, spec_k=-1)


# ------------------------------------------- drafter and bookkeeping units
def _histories(seed):
    """Seeded token histories over a small vocabulary (repeats happen)."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 6, rng.randint(1, 40)).tolist()
            for _ in range(12)]


@pytest.mark.parametrize("k,max_n,min_n", [(4, 3, 1), (2, 2, 2), (5, 4, 1)])
def test_ngram_proposer_matches_reference(k, max_n, min_n):
    props = []
    for cls in (JNgram, TNgram):
        p = cls(k, max_n=max_n, min_n=min_n)
        out = []
        rng = np.random.RandomState(k + max_n)
        for rid, hist in enumerate(_histories(7)):
            p.register(rid, hist[:len(hist) // 2])
            for tok in hist[len(hist) // 2:]:
                out.append(p.propose(rid, int(rng.randint(0, 6))))
                p.extend(rid, tok)
            out.append((p.propose(rid), p.history_len(rid)))
            if rid % 3 == 0:
                p.drop(rid)
                out.append(p.propose(rid))
        props.append(out)
    assert props[0] == props[1]
    assert any(props[1])


def test_ngram_proposer_validation():
    for cls in (JNgram, TNgram):
        with pytest.raises(ValueError, match="k must be"):
            cls(0)
        with pytest.raises(ValueError, match="min_n"):
            cls(2, max_n=1, min_n=3)


def test_spec_stats_matches_reference():
    rng = np.random.RandomState(3)
    events = [(int(p), int(rng.randint(0, p + 1)))
              for p in rng.randint(0, 5, 40)]
    snaps = []
    for cls in (JSpecStats, TSpecStats):
        s = cls()
        for i, (proposed, accepted) in enumerate(events):
            if i % 4 == 0:
                s.record_step()
            s.record(proposed, accepted)
        snaps.append(s.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[1]["spec_committed_tokens"] == \
        sum(a + 1 for _, a in events)


def test_verify_batch_writes_distinct_offsets(tiny):
    """The verify step's flattened batch: each slot's k+1 rows write k+1
    distinct (page, offset) pairs, across a page boundary, and no two
    live slots share one — shown on the pools the step leaves behind."""
    _, te = _engines(tiny, spec_k=3, max_slots=2)
    r = te.runner
    kpool0 = r.kpool.clone()
    # slot 0 at pos 6 on pages (2, 5): rows at 6, 7 | 8, 9 -> page 5
    row = np.full((r.table_width,), r.dump_page, np.int32)
    row[:2] = (2, 5)
    r.push_slot(0, row, 6, 7, 1)
    r.verify_step(np.array([[1, 2, 3], [0, 0, 0]], np.int32),
                  np.array([3, 0], np.int32))
    changed = (r.kpool != kpool0).any(dim=-1).any(dim=0)  # [P, kvh, ps]
    cells = {(int(p), int(o)) for p, _, o in changed.nonzero()}
    assert {(2, 6), (2, 7), (5, 0), (5, 1)} <= cells
    assert all(p in (2, 5, r.dump_page) for p, _ in cells)
    assert int(r._pos_dev[1]) == 0          # the idle slot stays parked
    assert int(r._pos_dev[0]) > 6
