"""paddle_tpu_torch quantized serving against the JAX engine, at tp=1.

Mirrors the tp=1 cases of ``tests/test_serving_quant.py``:
``quantize_state`` (bit-identical to the reference's, converting only
the projection matmuls, honouring ``skip``, idempotent, rejecting a bad
kind or an odd K for int4), the runner matrix (dense / int8 / int4 with
int8 KV pages, one decode-step build), the page math of
``quant_snapshot`` and the loud rejection of malformed quantized states.

The port engine's greedy tokens are held token for token against the
JAX engine in float32 on one ``llama_tiny`` model, for int8 weights x
int8 KV pages off/on x prefix cache off/on, plus one chunked prefill
case (int4: ``test_torch_serving_quant_int4.py``).  On the CPU the
port runs every kernel's plain version; both engines quantize the same
weights to the same bits.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu.ops.pallas import quant_matmul as JQM
from paddle_tpu.serving import GenerationConfig as JGen
from paddle_tpu.serving import create_engine as j_create_engine
from paddle_tpu.serving.quantize import quantize_state as j_quantize_state
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.ops.pallas import quant_matmul as TQM
from paddle_tpu_torch.serving import GenerationConfig as TGen
from paddle_tpu_torch.serving import create_engine as t_create_engine
from paddle_tpu_torch.serving import quantize_state
from paddle_tpu_torch.serving.parallel.runner import ModelRunner

PROJ = (".q_proj.weight", ".k_proj.weight", ".v_proj.weight",
        ".o_proj.weight", ".gate_proj.weight", ".up_proj.weight",
        ".down_proj.weight")
CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_attention_heads=8, num_key_value_heads=8)


@pytest.fixture(scope="module")
def tiny():
    paddle.seed(11)
    model = LlamaForCausalLM(llama_tiny(**CFG))
    model.eval()
    np_state = {k: np.asarray(v._data if isinstance(v, Tensor) else v)
                for k, v in model.functional_state().items()}
    return model, np_state


def _tstate(np_state):
    return TC.state_from_numpy(np_state, device="cpu")


# ------------------------------------------------------- quantize_state
class TestQuantizeState:
    @pytest.mark.parametrize("kind", ["int8", "int4"])
    def test_bit_identical_to_reference(self, tiny, kind):
        _, np_state = tiny
        want = j_quantize_state({k: jnp.asarray(v)
                                 for k, v in np_state.items()}, kind=kind)
        got = quantize_state(_tstate(np_state), kind=kind)
        assert set(got) == set(want)
        for name, w in want.items():
            if isinstance(w, JQM.QuantizedWeight):
                g = got[name]
                assert isinstance(g, TQM.QuantizedWeight), name
                assert (g.kind, g.k) == (w.kind, w.k)
                np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
                np.testing.assert_array_equal(
                    g.scale.numpy().view(np.int32),
                    np.asarray(w.scale).view(np.int32))
            else:
                np.testing.assert_array_equal(got[name].numpy(),
                                              np.asarray(w))

    def test_converts_matmuls_only(self, tiny):
        state = _tstate(tiny[1])
        qstate = quantize_state(state, kind="int8")
        assert set(qstate) == set(state)
        for name, v in qstate.items():
            if name.endswith(PROJ):
                assert isinstance(v, TQM.QuantizedWeight), name
                assert v.q.dtype == torch.int8
                assert v.k == state[name].shape[0]
            else:
                assert not isinstance(v, TQM.QuantizedWeight), name
                assert v.dtype == state[name].dtype

    def test_int4_packs_half_the_rows(self, tiny):
        state = _tstate(tiny[1])
        name = "llama.layers.0.mlp.down_proj.weight"
        w = quantize_state(state, kind="int4")[name]
        assert w.kind == "int4"
        assert w.q.shape[0] == state[name].shape[0] // 2

    def test_skip_keeps_named_projections_dense(self, tiny):
        qstate = quantize_state(_tstate(tiny[1]), kind="int8",
                                skip=("mlp.down_proj.weight",))
        for name, v in qstate.items():
            if name.endswith("mlp.down_proj.weight"):
                assert not isinstance(v, TQM.QuantizedWeight), name
            elif name.endswith("self_attn.q_proj.weight"):
                assert isinstance(v, TQM.QuantizedWeight), name

    def test_idempotent(self, tiny):
        once = quantize_state(_tstate(tiny[1]), kind="int8")
        twice = quantize_state(once, kind="int8")
        for name in once:
            if isinstance(once[name], TQM.QuantizedWeight):
                assert twice[name] is once[name], name

    def test_bad_kind_rejected(self, tiny):
        with pytest.raises(ValueError, match="int8.*int4"):
            quantize_state(_tstate(tiny[1]), kind="fp8")

    def test_int4_odd_k_rejected(self):
        state = {"llama.layers.0.mlp.down_proj.weight": torch.ones(63, 32)}
        with pytest.raises(ValueError, match="even K"):
            quantize_state(state, kind="int4")


# ----------------------------------------------------- engine vs engine
def _prompts():
    """One 16-token prefill bucket; with the prefix cache on, prompts
    1-2 share prompt 0's first page and prefill an 8-token suffix
    bucket (few buckets: the JAX engine compiles one program each)."""
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 128, 8).astype(np.int32)
    return [np.concatenate([shared, rng.integers(1, 128, n)
                            .astype(np.int32)]) for n in (3, 6, 5)] + [
        rng.integers(1, 128, 12).astype(np.int32)]


N_NEW = [6, 5, 6, 4]


def _run(engine, gen_cls):
    reqs = [engine.submit(p, gen_cls(max_new_tokens=n))
            for p, n in zip(_prompts(), N_NEW)]
    engine.run_until_complete(max_steps=500)
    assert all(r.finish_reason == "length" for r in reqs)
    return [list(r.output_tokens) for r in reqs], reqs


def _modes(quant):
    """kv_quant off/on x prefix cache off/on for one weight kind (the
    int4 half runs in ``test_torch_serving_quant_int4.py``: each JAX
    engine compiles its own programs, and one file holds ~15 s)."""
    return {f"{quant}-kv{int(kv)}-cache{int(c)}": dict(
        quant=quant, kv_quant=kv, enable_prefix_cache=c)
        for kv in (False, True) for c in (False, True)}


MODES = _modes("int8")
MODES["int8-kv1-cache1-chunked"] = dict(quant="int8", kv_quant=True,
                                        enable_prefix_cache=True,
                                        prefill_chunk=8)


def check_engine_matches_jax_engine(tiny, kw):
    """Port vs JAX engine on the same weights, traffic and settings:
    tokens, prefix-cache reuse, one decode-step build, no leaked page."""
    model, np_state = tiny
    kw = dict(max_slots=3, page_size=8, max_model_len=64, **kw)
    want, jreqs = _run(j_create_engine(model, preempt=False, **kw), JGen)
    engine = t_create_engine(TL.llama_tiny(**CFG), _tstate(np_state),
                             device="cpu", **kw)
    got, treqs = _run(engine, TGen)
    assert got == want
    assert [r.num_cached_tokens for r in treqs] == \
        [r.num_cached_tokens for r in jreqs]
    stats = engine.stats()
    assert stats["decode_traces"] == 1 and stats["pages_in_use"] == 0
    assert engine.blocks.pool_accounting()["leak"] == 0
    if kw.get("prefill_chunk"):
        # chunked admissions publish their pages after the last chunk,
        # so admissions of one step do not share them
        assert stats["prefill_chunks"] > 0
    elif kw["enable_prefix_cache"]:
        assert stats["prefix_hits"] > 0


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax_engine(tiny, mode):
    check_engine_matches_jax_engine(tiny, MODES[mode])


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_runner_matrix_tp1(tiny, quant):
    """Every weight kind constructs and serves a short greedy request
    with one decode-step build (int8 KV pages whenever quantized); the
    tokens themselves are held against the JAX engine above."""
    engine = t_create_engine(TL.llama_tiny(**CFG), _tstate(tiny[1]),
                             device="cpu", max_slots=2, page_size=8,
                             max_model_len=64, quant=quant,
                             kv_quant=bool(quant))
    req = engine.submit(np.arange(1, 7, dtype=np.int32),
                        TGen(max_new_tokens=4))
    engine.run_until_complete()
    assert len(req.output_tokens) == 4
    assert engine.decode_traces == 1
    assert engine.stats()["quant"] == (quant or "")
    assert engine.stats()["kv_quant"] is bool(quant)


def test_quant_snapshot_page_math(tiny):
    """page_bytes follows the (hd + 4) / (4 hd) quant/dense ratio, as in
    the reference; the pools themselves are int8 + f32 scales."""
    model, np_state = tiny
    engine = t_create_engine(TL.llama_tiny(**CFG), _tstate(np_state),
                             device="cpu", max_slots=2, page_size=8,
                             max_model_len=64, quant="int8", kv_quant=True)
    req = engine.submit(np.arange(1, 9, dtype=np.int32),
                        TGen(max_new_tokens=4))
    engine.run_until_complete()
    assert len(req.output_tokens) == 4
    snap = engine.quant_snapshot()
    hd = model.config.head_dim
    assert snap["weight_kind"] == "int8" and snap["kv_quant"] is True
    assert snap["page_bytes"] * 4 * hd == \
        snap["dense_page_bytes"] * (hd + 4)
    assert engine.runner.kpool.dtype == torch.int8
    assert engine.runner.kscale.dtype == torch.float32
    assert tuple(engine.runner.kscale.shape) == \
        tuple(engine.runner.kpool.shape[:-1])


# -------------------------------------------- malformed-state rejection
class TestMalformedStateRejection:
    """A broken quantized state fails at construction with a pointed
    message, not as a shape error inside the first step."""

    def _runner(self, state):
        return ModelRunner(TL.llama_tiny(**CFG), state, device="cpu",
                           max_slots=2, page_size=8, table_width=8,
                           num_pages=16, dump_page=16)

    def _qstate(self, tiny):
        return quantize_state(_tstate(tiny[1]), kind="int8")

    def test_missing_scale(self, tiny):
        state = self._qstate(tiny)
        key = "llama.layers.0.self_attn.q_proj.weight"
        w = state[key]
        state[key] = TQM.QuantizedWeight(w.q, None, kind="int8", k=w.k)
        with pytest.raises(ValueError, match="missing scale"):
            self._runner(state)

    def test_scale_shape_mismatch(self, tiny):
        state = self._qstate(tiny)
        key = "llama.layers.0.mlp.gate_proj.weight"
        w = state[key]
        state[key] = TQM.QuantizedWeight(w.q, w.scale[:-1], kind="int8",
                                         k=w.k)
        with pytest.raises(ValueError, match="scale shape"):
            self._runner(state)

    def test_bad_kind(self, tiny):
        state = self._qstate(tiny)
        key = "llama.layers.0.mlp.up_proj.weight"
        w = state[key]
        state[key] = TQM.QuantizedWeight(w.q, w.scale, kind="fp8", k=w.k)
        with pytest.raises(ValueError, match="unsupported quant kind"):
            self._runner(state)

    def test_wrong_row_count_for_k(self, tiny):
        state = self._qstate(tiny)
        key = "llama.layers.0.self_attn.o_proj.weight"
        w = state[key]
        state[key] = TQM.QuantizedWeight(w.q[:-1], w.scale, kind="int8",
                                         k=w.k)
        with pytest.raises(ValueError, match="rows"):
            self._runner(state)

    def test_engine_rejects_unknown_quant_flag(self, tiny):
        with pytest.raises(ValueError, match="int8.*int4"):
            t_create_engine(TL.llama_tiny(**CFG), _tstate(tiny[1]),
                            device="cpu", quant="fp8", max_slots=2,
                            page_size=8, max_model_len=64)


def test_state_from_numpy_carries_quantized_leaves(tiny):
    """A reference QuantizedWeight crosses over as (q, scale, kind, k)
    and serves the same tokens as the port's own quantization."""
    model, np_state = tiny
    jq = j_quantize_state({k: jnp.asarray(v) for k, v in np_state.items()},
                          kind="int4")
    carried = TC.state_from_numpy(
        {k: ((np.asarray(v.q), np.asarray(v.scale), v.kind, v.k)
             if isinstance(v, JQM.QuantizedWeight) else np.asarray(v))
         for k, v in jq.items()}, device="cpu")
    w = carried["llama.layers.1.mlp.up_proj.weight"]
    assert isinstance(w, TQM.QuantizedWeight) and w.kind == "int4"
    outs = []
    for state in (carried, _tstate(np_state)):
        engine = t_create_engine(TL.llama_tiny(**CFG), state, device="cpu",
                                 max_slots=2, page_size=8, max_model_len=64,
                                 quant="int4")
        req = engine.submit(np.arange(3, 12, dtype=np.int32),
                            TGen(max_new_tokens=5))
        engine.run_until_complete()
        outs.append(req.output_tokens)
    assert outs[0] == outs[1]
