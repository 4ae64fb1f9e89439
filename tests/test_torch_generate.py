"""paddle_tpu_torch one-shot ``generate`` against the JAX package, on the
CPU, token for token.

One reference ``LlamaForCausalLM`` (built as ``tests/test_generation.py``
builds its fixture: 2 layers, hidden 64, GQA 4/2, vocab 97) is carried
into the port with ``state_from_numpy``; the same numpy prompts go
through the reference's ``generate`` (JAX on the CPU) and the port's
with ``device="cpu"`` (every kernel wrapper runs its plain version).
float32 throughout: greedy tokens must be identical.

Sampling cannot match ``jax.random``'s bits.  Over 4096 draws from one
row of 16 logits (0.5 * randn, fixed seeds) the SET of tokens the port
draws must equal the set the reference's ``_sample`` draws over 4096
rows: at these logits every token that survives the filter has a
probability of at least 0.07, so the chance that either side misses one
is below 16 * 0.93^4096 (< 1e-120).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import generation as JG
from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.models import llama as TL

CFG = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
           vocab_size=97, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=64)
PROMPT = 10
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
    return np.random.default_rng(1).integers(0, 97, (3, PROMPT))


def _both(model, ids, new=8, **kw):
    jm, state, cfg = model
    jkw = {k: (paddle.to_tensor(v) if k == "lengths" else v)
           for k, v in kw.items()}
    want = np.asarray(JG.generate(jm, paddle.to_tensor(ids),
                                  max_new_tokens=new, **jkw).numpy())
    got = TG.generate(state, cfg, ids, max_new_tokens=new, device="cpu",
                      **kw)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    return want, got.numpy()


@pytest.mark.parametrize("case", ["full", "ragged"])
def test_greedy_dense_matches_jax(model, ids, case):
    kw = {} if case == "full" else {"lengths": LENGTHS}
    want, got = _both(model, ids, **kw)
    assert got.shape == (3, PROMPT + 8)
    np.testing.assert_array_equal(got, want)


def test_eos_and_pad_match_jax(model, ids):
    # an eos the greedy decode reaches mid-way: rows finish at different
    # steps and emit pad after it
    plain, _ = _both(model, ids, lengths=LENGTHS)
    eos = int(plain[0, PROMPT + 2])
    want, got = _both(model, ids, lengths=LENGTHS, eos_token_id=eos,
                      pad_token_id=3)
    np.testing.assert_array_equal(got, want)
    assert (got[0, PROMPT + 3:] == 3).all()


@pytest.mark.parametrize("page_size", [4, 128])
def test_paged_matches_jax(model, ids, page_size):
    want, got = _both(model, ids, lengths=LENGTHS, cache="paged",
                      page_size=page_size)
    np.testing.assert_array_equal(got, want)


def test_error_paths_match_jax(model, ids):
    jm, state, cfg = model
    cases = [(ValueError, "weight_quant", dict(weight_quant="int2")),
             (ValueError, "num_beams", dict(num_beams=2, do_sample=True)),
             (NotImplementedError, "dense cache",
              dict(num_beams=2, cache="paged"))]
    for exc, match, kw in cases:
        with pytest.raises(exc, match=match):
            JG.generate(jm, paddle.to_tensor(ids), max_new_tokens=2, **kw)
        with pytest.raises(exc, match=match):
            TG.generate(state, cfg, ids, max_new_tokens=2, device="cpu",
                        **kw)


def test_state_on_another_device_raises(model, ids):
    _, state, cfg = model
    with pytest.raises(ValueError, match="lies on"):
        TG.generate(state, cfg, ids, max_new_tokens=2, device="meta")


# ---------------------------------------------------------------- sampling
V, DRAWS = 16, 4096
SAMPLE_CASES = {"top_k": dict(top_k=5), "top_p": dict(top_p=0.7),
                "temperature_top_k": dict(temperature=0.6, top_k=9)}


@pytest.fixture(scope="module")
def logits():
    return (0.5 * np.random.default_rng(7).standard_normal(V)).astype(
        np.float32)


@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_sampled_set_matches_jax(logits, case):
    gen = dict(do_sample=True, **SAMPLE_CASES[case])
    rows = np.tile(logits, (DRAWS, 1))
    want = np.asarray(JG._sample(jnp.asarray(rows), jax.random.key(11),
                                 JG.GenerationConfig(**gen)))
    tgen = TG.GenerationConfig(**gen)
    got = TG._sample(torch.from_numpy(rows),
                     torch.Generator().manual_seed(11), tgen).numpy()
    support = np.flatnonzero(np.isfinite(TG._filter_logits(
        torch.from_numpy(logits), tgen).numpy()))
    assert set(got) == set(want) == set(support)
    assert 1 < len(support) < V


def test_top_k_one_is_greedy(logits):
    rows = torch.from_numpy(np.tile(logits, (64, 1)))
    gen = TG.GenerationConfig(do_sample=True, top_k=1, temperature=0.7)
    got = TG._sample(rows, torch.Generator().manual_seed(0), gen)
    assert (got == int(np.argmax(logits))).all()


def test_greedy_takes_the_first_index_of_a_tie():
    row = torch.tensor([[0.5, 2.0, -1.0, 2.0]])
    assert TG._sample(row, None, TG.GenerationConfig()).tolist() == [1]
    assert np.asarray(JG._sample(jnp.asarray(row.numpy()), None,
                                 JG.GenerationConfig())).tolist() == [1]


def test_sampled_generate_is_seeded(model, ids):
    _, state, cfg = model
    kw = dict(max_new_tokens=6, do_sample=True, top_k=8, top_p=0.9,
              device="cpu")
    a = TG.generate(state, cfg, ids, seed=5, **kw)
    b = TG.generate(state, cfg, ids, seed=5, **kw)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    greedy = TG.generate(state, cfg, ids, max_new_tokens=6, device="cpu")
    top1 = TG.generate(state, cfg, ids, max_new_tokens=6, do_sample=True,
                       top_k=1, seed=5, device="cpu")
    torch.testing.assert_close(top1, greedy, atol=0, rtol=0)
