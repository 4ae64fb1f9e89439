"""paddle_tpu_torch beam search (``generate(num_beams=K)``) against the JAX
package, on the CPU, token for token.

The fixture model is ``tests/test_torch_generate.py``'s (2 layers,
hidden 64, GQA 4/2, vocab 97, float32), carried over with
``state_from_numpy``.  Beam candidates are merged with a stable
descending sort so that equal scores resolve as ``jax.lax.top_k``
resolves them (the lower index first).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import generation as JG
from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.models import llama as TL

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
    return np.random.default_rng(2).integers(0, 97, (3, 10))


def _beam(model, ids, **kw):
    jm, state, cfg = model
    want = np.asarray(JG.generate(
        jm, paddle.to_tensor(ids), lengths=paddle.to_tensor(LENGTHS),
        **kw).numpy())
    got = TG.generate(state, cfg, ids, lengths=LENGTHS, device="cpu", **kw)
    return want, got.numpy()


@pytest.mark.parametrize("beams", [3, 4])
def test_beam_matches_jax(model, ids, beams):
    want, got = _beam(model, ids, max_new_tokens=8, num_beams=beams)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("beams", [3, 4])
def test_beam_with_eos_matches_jax(model, ids, beams):
    # an eos the beams meet: take one from the plain beam output
    plain, _ = _beam(model, ids, max_new_tokens=8, num_beams=beams)
    eos = int(plain[1, 10 + 2])
    want, got = _beam(model, ids, max_new_tokens=8, num_beams=beams,
                      eos_token_id=eos, pad_token_id=0)
    np.testing.assert_array_equal(got, want)


def test_one_new_token_is_the_top_beam(model, ids):
    want, got = _beam(model, ids, max_new_tokens=1, num_beams=4)
    np.testing.assert_array_equal(got, want)
    greedy = TG.generate(model[1], model[2], ids, lengths=LENGTHS,
                         max_new_tokens=1, device="cpu").numpy()
    np.testing.assert_array_equal(got, greedy)


def test_top_k_breaks_ties_like_jax():
    import jax
    import jax.numpy as jnp
    x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 2.0],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 4)
    got_v, got_i = TG._top_k(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
