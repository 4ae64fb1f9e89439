"""paddle_tpu_torch ``generate`` with the decode-attention switch on and
off, against the JAX package with its K7 kernel in interpret mode and
off, on the CPU, token for token.

The reference's kernel takes head_dim 64, 128 or 256 only
(``decode_attention.py:168``), so this model has head_dim 64 (hidden
256, 4 heads, GQA 4/2): with ``_INTERPRET`` on, the interpret-mode
Pallas kernel really runs inside the reference's jitted decode loop,
and the cache is padded to 128 on both sides.  float32; a few new
tokens (the interpreted kernel takes seconds per call).
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import generation as JG
from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu.ops.pallas import decode_attention as JDA
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.ops.pallas import decode_attention as TDA

CFG = dict(num_hidden_layers=2, hidden_size=256, intermediate_size=256,
           vocab_size=97, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=64)


@pytest.fixture(scope="module")
def model():
    paddle.seed(0)
    m = LlamaForCausalLM(llama_tiny(**CFG))
    m.eval()
    np_state = {k: np.asarray(v) for k, v in m.functional_state().items()}
    return m, TC.state_from_numpy(np_state, device="cpu"), \
        TL.llama_tiny(**CFG)


@pytest.mark.parametrize("on", [True, False])
def test_generate_with_k7_on_and_off_matches_jax(model, monkeypatch, on):
    jm, state, cfg = model
    assert cfg.head_dim == 64
    monkeypatch.setattr(JDA, "_INTERPRET", on)
    monkeypatch.setattr(TDA, "PALLAS_DECODE", on)
    JG._FN_CACHE.clear()          # _INTERPRET is read at trace time
    ids = np.random.default_rng(1).integers(0, 97, (2, 9))
    lengths = np.array([9, 5])
    want = JG.generate(jm, paddle.to_tensor(ids), max_new_tokens=3,
                       lengths=paddle.to_tensor(lengths)).numpy()
    JG._FN_CACHE.clear()
    got = TG.generate(state, cfg, ids, max_new_tokens=3, lengths=lengths,
                      device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert TG._cache_len(9, 3) == (128 if on else 12)
