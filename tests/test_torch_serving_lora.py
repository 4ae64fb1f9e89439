"""paddle_tpu_torch multi-LoRA serving against the JAX engine, at tp=1.

Mirrors ``tests/test_serving_lora.py``: the ``AdapterStore`` units
(loud validation, LRU parking, pinned rows, the census) and the tp=1
engine cases — an adapter against the merged checkpoint ``W + (alpha/r)
A^T B``, a mixed batch in one decode-step build, composition with int8
weights, an armed but unused store changing nothing, prefix sharing
under one adapter.  Each engine case holds the port's greedy tokens
token for token against the JAX engine (float32, CPU, the same weights
and adapters; the port runs every kernel's plain version).

One case has no JAX counterpart: the reference's prefix cache keys its
chain by tokens alone, so a request under one adapter reuses KV pages
prefilled under another and decodes wrong tokens.  The port keys the
chain by adapter; :func:`test_prefix_is_not_shared_across_adapters`
holds it to the merged-checkpoint ground truth.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu.serving import AdapterStore as JStore
from paddle_tpu.serving import GenerationConfig as JGen
from paddle_tpu.serving import random_adapter as j_random_adapter
from paddle_tpu.serving.engine import Engine as JEngine
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import AdapterStore, GenerationConfig, \
    merge_adapter, random_adapter
from paddle_tpu_torch.serving.engine import Engine
from paddle_tpu_torch.serving.lora.store import lora_key_dims

PAGE = 8
RANK = 4
ALPHA = 8.0
CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=128)
PROMPT = [1, 2, 3, 4]


@pytest.fixture(scope="module")
def setup():
    paddle.seed(11)
    jcfg = llama_tiny(**CFG)
    model = LlamaForCausalLM(jcfg)
    model.eval()
    jstate = {k: (v._data if isinstance(v, Tensor) else v)
              for k, v in model.functional_state().items()}
    np_state = {k: np.asarray(v) for k, v in jstate.items()}
    np_adapters = {"alpha": j_random_adapter(jcfg, RANK, seed=7),
                   "beta": j_random_adapter(jcfg, RANK, seed=8)}
    return {"jcfg": jcfg, "jstate": jstate, "np_state": np_state,
            "cfg": TL.llama_tiny(**CFG),
            "np_adapters": np_adapters,
            "adapters": {k: TC.adapter_from_numpy(v)
                         for k, v in np_adapters.items()}}


def _store(s, capacity=2):
    store = AdapterStore(s["cfg"], capacity=capacity)
    for name, w in s["adapters"].items():
        store.register(name, w, alpha=ALPHA)
    return store


def _jstore(s, capacity=2):
    store = JStore(s["jcfg"], capacity=capacity)
    for name, w in s["np_adapters"].items():
        store.register(name, w, alpha=ALPHA)
    return store


def _engine(s, state=None, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("page_size", PAGE)
    state = TC.state_from_numpy(s["np_state"], device="cpu") \
        if state is None else state
    return Engine(config=s["cfg"], state=state, device="cpu", **kw)


def _jengine(s, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("page_size", PAGE)
    return JEngine(config=s["jcfg"], state=dict(s["jstate"]), **kw)


def _run(eng, prompt, n=8, adapter=None, gen=GenerationConfig):
    req = eng.submit(list(prompt), gen(max_new_tokens=n), adapter=adapter)
    eng.run_until_complete(max_steps=600)
    assert req.finish_reason == "length"
    return list(req.output_tokens)


@pytest.fixture(scope="module")
def jax_tokens(setup):
    """The JAX engine's greedy tokens on PROMPT under each adapter and
    none, through one bank-armed engine."""
    eng = _jengine(setup, lora=_jstore(setup))
    out = {a: _run(eng, PROMPT, adapter=a, gen=JGen)
           for a in ("alpha", "beta", None)}
    assert out["alpha"] != out[None] != out["beta"] != out["alpha"]
    return out


# ===================================================== AdapterStore units
class TestAdapterStore:
    def test_random_adapter_matches_reference(self, setup):
        mine = random_adapter(setup["cfg"], RANK, seed=7)
        for key, (a, b) in setup["np_adapters"]["alpha"].items():
            np.testing.assert_array_equal(mine[key][0].numpy(), a)
            np.testing.assert_array_equal(mine[key][1].numpy(), b)

    def test_register_rejects_missing_and_extra_keys(self, setup):
        store = AdapterStore(setup["cfg"])
        broken = dict(setup["adapters"]["alpha"])
        broken["bogus"] = broken.pop("down")
        with pytest.raises(ValueError, match="missing.*down"):
            store.register("x", broken)

    def test_register_rejects_wrong_layer_count(self, setup):
        store = AdapterStore(setup["cfg"])
        broken = {k: (a[:1], b) for k, (a, b)
                  in setup["adapters"]["alpha"].items()}
        with pytest.raises(ValueError, match="A shape"):
            store.register("x", broken)

    def test_register_rejects_rank_mismatch(self, setup):
        store = AdapterStore(setup["cfg"])
        store.register("a4", setup["adapters"]["alpha"], alpha=ALPHA)
        with pytest.raises(ValueError, match="rank 2 != store rank 4"):
            store.register("a2", random_adapter(setup["cfg"], 2, seed=3))

    def test_register_rejects_bad_alpha_and_name(self, setup):
        store = AdapterStore(setup["cfg"])
        with pytest.raises(ValueError, match="alpha"):
            store.register("x", setup["adapters"]["alpha"], alpha=0.0)
        with pytest.raises(ValueError, match="non-empty"):
            store.register("  ", setup["adapters"]["alpha"])

    def test_register_rejects_non_floating(self, setup):
        cfg = setup["cfg"]
        L = cfg.num_hidden_layers
        ints = {k: (np.ones((L, RANK, ind), np.int32),
                    np.ones((L, RANK, outd), np.int32))
                for k, (ind, outd) in lora_key_dims(cfg).items()}
        with pytest.raises(ValueError, match="floating"):
            AdapterStore(cfg).register("x", ints)

    def test_acquire_unknown_is_keyerror(self, setup):
        with pytest.raises(KeyError, match="unknown adapter"):
            _store(setup).acquire("nope")

    def test_lru_eviction_parks_and_restores(self, setup):
        store = _store(setup, capacity=1)
        assert store.acquire("alpha") == 1
        store.release("alpha")
        assert store.acquire("beta") == 1
        snap = store.snapshot()
        assert snap["resident"] == ["beta"]
        assert snap["parked"] == ["alpha"]
        assert snap["loads"] == 2 and snap["evictions"] == 1
        store.release("beta")
        assert store.acquire("alpha") == 1
        assert store.loads == 3

    def test_pinned_rows_never_evict(self, setup):
        store = _store(setup, capacity=1)
        store.acquire("alpha")
        with pytest.raises(RuntimeError, match="pinned"):
            store.acquire("beta")
        store.release("alpha")
        assert store.acquire("beta") == 1

    def test_release_without_acquire_raises(self, setup):
        store = _store(setup)
        with pytest.raises(RuntimeError, match="without a matching"):
            store.release("alpha")
        store.release(None)

    def test_snapshot_and_bank_bytes(self, setup):
        cfg = setup["cfg"]
        store = _store(setup, capacity=3)
        store.acquire("alpha")
        snap = store.snapshot()
        want = _jstore(setup, capacity=3)
        want.acquire("alpha")
        assert snap == want.snapshot()
        per_row = sum(i + o for i, o in lora_key_dims(cfg).values())
        assert snap["bank_bytes"] == (
            cfg.num_hidden_layers * 4 * RANK * per_row * 4 + 4 * 4)


# ================================================== engine greedy parity
def test_adapter_matches_merged_checkpoint(setup, jax_tokens):
    store = _store(setup)
    eng = _engine(setup, lora=store)
    got = {a: _run(eng, PROMPT, adapter=a) for a in ("alpha", "beta", None)}
    assert got == jax_tokens
    # the ground truth: a dense engine over the merged checkpoint
    base = TC.state_from_numpy(setup["np_state"], device="cpu")
    for name, w in setup["adapters"].items():
        merged = merge_adapter(base, setup["cfg"], w, alpha=ALPHA)
        assert _run(_engine(setup, merged), PROMPT) == got[name]
    assert eng.decode_traces == 1
    assert store.loads >= 2
    assert eng.lora_snapshot()["bank_bytes_device"] > 0


def test_mixed_batch_one_trace(setup, jax_tokens):
    eng = _engine(setup, lora=_store(setup))
    reqs = [eng.submit(PROMPT, GenerationConfig(max_new_tokens=8),
                       adapter=ad) for ad in ("alpha", "beta", None)]
    eng.run_until_complete(max_steps=600)
    assert [list(r.output_tokens) for r in reqs] == \
        [jax_tokens["alpha"], jax_tokens["beta"], jax_tokens[None]]
    assert eng.decode_traces == 1
    assert eng.stats()["lora"]["pinned"] == {}


def test_composes_with_int8_weights(setup):
    jeng = _jengine(setup, quant="int8", lora=_jstore(setup))
    want = [_run(jeng, PROMPT, gen=JGen),
            _run(jeng, PROMPT, adapter="alpha", gen=JGen)]
    eng = _engine(setup, quant="int8", lora=_store(setup))
    got = [_run(eng, PROMPT), _run(eng, PROMPT, adapter="alpha")]
    assert got == want
    assert got[1] != got[0]
    assert eng.decode_traces == 1


def test_armed_but_unused_store_changes_nothing(setup, jax_tokens):
    store = _store(setup)
    eng = _engine(setup, lora=store)
    assert _run(eng, PROMPT) == jax_tokens[None]
    assert _run(_engine(setup), PROMPT) == jax_tokens[None]
    assert eng.decode_traces == 1
    assert store.loads == 0 and store.snapshot()["resident"] == []


def test_parity_with_prefix_cache(setup, jax_tokens):
    """A second identical prompt under the same adapter rides the first
    one's cached pages (the JAX engine's tokens, same reuse)."""
    prompt = list(range(1, 1 + 2 * PAGE))
    jeng = _jengine(setup, lora=_jstore(setup), enable_prefix_cache=True)
    want = [_run(jeng, prompt, adapter="alpha", gen=JGen) for _ in range(2)]
    eng = _engine(setup, lora=_store(setup), enable_prefix_cache=True)
    got = [_run(eng, prompt, adapter="alpha") for _ in range(2)]
    assert got == want and got[0] == got[1]
    assert eng.stats()["prefix_hits"] == jeng.stats()["prefix_hits"] > 0
    assert _run(eng, PROMPT, adapter="alpha") == jax_tokens["alpha"]
    assert eng.decode_traces == 1


def test_prefix_is_not_shared_across_adapters(setup):
    """A 24-token prompt under "alpha", then the same prompt under
    "beta" (and dense): each must decode its merged checkpoint's tokens
    — no page of alpha's chain may serve beta."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, CFG["vocab_size"], 3 * PAGE).tolist()
    base = TC.state_from_numpy(setup["np_state"], device="cpu")
    truth = {None: _run(_engine(setup, base), prompt)}
    for name, w in setup["adapters"].items():
        merged = merge_adapter(base, setup["cfg"], w, alpha=ALPHA)
        truth[name] = _run(_engine(setup, merged), prompt)
    eng = _engine(setup, lora=_store(setup), enable_prefix_cache=True)
    got = {a: _run(eng, prompt, adapter=a) for a in ("alpha", "beta", None)}
    assert got == truth
    # a repeat under each adapter does share its own chain
    hits = eng.stats()["prefix_hits"]
    assert _run(eng, prompt, adapter="beta") == truth["beta"]
    assert eng.stats()["prefix_hits"] > hits
    assert eng.blocks.pool_accounting()["leak"] == 0


def test_submit_checks(setup):
    with pytest.raises(ValueError, match="without lora"):
        _engine(setup).submit(PROMPT, adapter="alpha")
    eng = _engine(setup, lora=_store(setup, capacity=1))
    with pytest.raises(KeyError, match="unknown adapter"):
        eng.submit(PROMPT, adapter="gamma")
    eng.submit(PROMPT, GenerationConfig(max_new_tokens=2), adapter="alpha")
    with pytest.raises(RuntimeError, match="pinned"):
        eng.submit(PROMPT, adapter="beta")
    eng.run_until_complete()
    assert eng.lora.snapshot()["pinned"] == {}
    with pytest.raises(ValueError, match="rank"):
        _engine(setup, lora=AdapterStore(setup["cfg"]))
    assert isinstance(eng.runner.lora["scale"], torch.Tensor)
