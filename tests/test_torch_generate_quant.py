"""paddle_tpu_torch ``generate(weight_quant=...)`` and the generation
``quantize_state`` against the JAX package, on the CPU.

The fixture model and prompts are ``tests/test_torch_generate.py``'s (2
layers, hidden 64, GQA 4/2, vocab 97, float32).  On the CPU the port's
weight-only matmul runs its plain version; greedy tokens must be
identical, dense and paged, int8 and int4.  The port's ``quantize_state``
must give the reference's int8/int4 values and scales bit for bit,
fused q/k/v and gate/up leaves included (both quantize in float32 with
IEEE division and round half to even).
"""
import gc

import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import generation as JG
from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.ops.pallas import quant_matmul as TQM

CFG = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
           vocab_size=97, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=64)
LENGTHS = np.array([10, 4, 7])


@pytest.fixture(scope="module")
def model():
    paddle.seed(0)
    m = LlamaForCausalLM(llama_tiny(**CFG))
    m.eval()
    np_state = {k: np.asarray(v) for k, v in m.functional_state().items()}
    return m, TC.state_from_numpy(np_state, device="cpu"), \
        TL.llama_tiny(**CFG)


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(1).integers(0, 97, (3, 10))


def _both(model, ids, new=8, **kw):
    jm, state, cfg = model
    want = JG.generate(jm, paddle.to_tensor(ids), max_new_tokens=new,
                       lengths=paddle.to_tensor(LENGTHS), **kw).numpy()
    got = TG.generate(state, cfg, ids, max_new_tokens=new, device="cpu",
                      lengths=LENGTHS, **kw)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_weight_quant_matches_jax(model, ids, quant, cache):
    want, got = _both(model, ids, weight_quant=quant, cache=cache,
                      page_size=4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_quantize_state_bit_identical(model, algo):
    jm, state, _ = model
    jstate = {k: jnp.asarray(v)
              for k, v in jm.functional_state().items()}
    want = JG.quantize_state(jstate, algo)
    got = TG.quantize_state(state, algo)
    assert sorted(got) == sorted(want)
    fused = [k for k in got if k.endswith(("qkv_fused.weight",
                                           "gateup_fused.weight"))]
    assert len(fused) == 2 * CFG["num_hidden_layers"]
    for key, w in want.items():
        if not hasattr(w, "scale"):
            assert got[key] is state[key]
            continue
        g = got[key]
        assert isinstance(g, TQM.QuantizedWeight)
        assert (g.kind, g.k) == (w.kind, w.k), key
        np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))


def test_weight_quant_converts_once(model, ids):
    _, state, cfg = model
    TG.generate(state, cfg, ids, max_new_tokens=2, weight_quant="int8",
                device="cpu")
    first = TG._WQ_CACHE["leaves"]
    TG.generate(state, cfg, ids, max_new_tokens=2, weight_quant="int8",
                device="cpu")
    assert TG._WQ_CACHE["leaves"] is first
    TG.generate(state, cfg, ids, max_new_tokens=2, weight_quant="int4",
                device="cpu")
    assert TG._WQ_CACHE["leaves"] is not first


def test_weight_quant_cache_dies_with_state(model, ids):
    """The conversion cache holds no source tensor: it is dropped when
    the caller's state is, and a rebound weight converts again."""
    _, state, cfg = model
    own = {k: v.clone() for k, v in state.items()}
    want = TG.generate(own, cfg, ids, max_new_tokens=3, weight_quant="int8",
                       device="cpu")
    leaves = TG._WQ_CACHE["leaves"]
    assert all(v is not own[k] for k, v in leaves.items() if k in own)
    rebound = dict(own, **{"lm_head.weight": own["lm_head.weight"].clone()})
    got = TG.generate(rebound, cfg, ids, max_new_tokens=3,
                      weight_quant="int8", device="cpu")
    assert TG._WQ_CACHE["leaves"] is not leaves
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    del own, rebound, leaves
    gc.collect()
    assert TG._WQ_CACHE == {}
