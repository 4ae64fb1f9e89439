"""paddle_tpu_torch Llama layer math against the JAX package.

One JAX ``llama_tiny`` model's ``functional_state()`` is carried into
the port with ``state_from_numpy``; the same numpy activations go
through the JAX layer functions and the port's (on the CPU: every kernel
wrapper runs its plain version).  float32 throughout; tolerance 1e-5
absolute (the frameworks sum in different orders; one layer's outputs
are O(1)).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

import paddle_tpu as paddle
from paddle_tpu.models import generation as JG
from paddle_tpu.models import llama as JL
from paddle_tpu.models.llama_hybrid import _rms as j_rms
from paddle_tpu.ops.pallas import paged_attention as JPA
from paddle_tpu.serving.parallel import runner as JR
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving.parallel import runner as TR

ATOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    paddle.seed(0)
    model = JL.LlamaForCausalLM(JL.llama_tiny())
    np_state = {k: np.asarray(v) for k, v in model.functional_state().items()}
    jstate = {k: jnp.asarray(v) for k, v in np_state.items()}
    tstate = TC.state_from_numpy(np_state, device="cpu")
    return JL.llama_tiny(), TL.llama_tiny(), jstate, tstate


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


def test_configs_match():
    for name in ("llama_tiny", "llama3_8b"):
        j, t = getattr(JL, name)(), getattr(TL, name)()
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.head_dim == t.head_dim


def test_rms_rope_rotate_match():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 32).astype(np.float32)
    w = rng.randn(32).astype(np.float32)
    _close(TL._rms(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           j_rms(jnp.asarray(x), jnp.asarray(w), 1e-6))
    # bf16: the f32 normalise is cast to bf16 BEFORE the weight multiply
    xb, wb = x.astype(ml_dtypes.bfloat16), w.astype(ml_dtypes.bfloat16)
    tb = TL._rms(TC._to_tensor(xb), TC._to_tensor(wb), 1e-6)
    jb = np.asarray(j_rms(jnp.asarray(xb), jnp.asarray(wb), 1e-6))
    assert tb.dtype == torch.bfloat16
    np.testing.assert_array_equal(tb.float().numpy(), jb.astype(np.float32))
    for theta in (10000.0, 500000.0):
        tc, ts = TL._rope_tables(64, 32, theta)
        jc, js = JL._rope_tables(64, 32, theta)
        _close(tc, jc, 1e-6)
        _close(ts, js, 1e-6)
    _close(TL._rotate_half(torch.from_numpy(x)),
           JL._rotate_half(jnp.asarray(x)), 0)


def test_state_from_numpy_keeps_bf16_bits():
    rng = np.random.RandomState(1)
    a = rng.randn(7, 5).astype(ml_dtypes.bfloat16)
    t = TC.state_from_numpy({"w": a}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
    t32 = TC.state_from_numpy({"w": a}, device="cpu",
                              dtype=torch.float32)["w"]
    np.testing.assert_array_equal(t32.numpy(), a.astype(np.float32))


def test_init_state_mirrors_reference_keys(weights):
    jcfg, tcfg, jstate, _ = weights
    state = TC.init_state(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert sorted(state) == sorted(jstate)
    for k, v in state.items():
        assert tuple(v.shape) == tuple(jstate[k].shape), k
        assert v.dtype == torch.float32
    again = TC.init_state(tcfg, torch.Generator().manual_seed(0),
                          device="cpu", dtype=torch.bfloat16)
    assert again["lm_head.weight"].dtype == torch.bfloat16
    torch.testing.assert_close(again["lm_head.weight"].float(),
                               state["lm_head.weight"], atol=1e-2, rtol=1e-2)


def test_prefill_layer_matches_jax(weights):
    jcfg, tcfg, jstate, tstate = weights
    rng = np.random.RandomState(2)
    b, s = 2, 24
    x = rng.randn(b, s, tcfg.hidden_size).astype(np.float32)
    mask = np.arange(s)[None, :] < np.array([[24], [13]])
    jc, js = JL._rope_tables(s, tcfg.head_dim, tcfg.rope_theta)
    tc, ts = TL._rope_tables(s, tcfg.head_dim, tcfg.rope_theta)
    for i in range(tcfg.num_hidden_layers):
        jo = jax.jit(lambda w, x, m: JG._prefill_layer(
            w, x, jc, js, m, jcfg))(JG._layer_weights(jstate, i),
                                    jnp.asarray(x), jnp.asarray(mask))
        to = TG._prefill_layer(TG._layer_weights(tstate, i),
                               torch.from_numpy(x), tc, ts,
                               torch.from_numpy(mask), tcfg)
        for t, j in zip(to, jo):
            _close(t, j)


def _paged_setup(tcfg, rng, b=3, ps=8, w=4):
    kvh, hd = tcfg.num_key_value_heads, tcfg.head_dim
    n_pool = b * w + 1
    kpool = rng.randn(n_pool, kvh, ps, hd).astype(np.float32)
    vpool = rng.randn(n_pool, kvh, ps, hd).astype(np.float32)
    table = rng.permutation(b * w).reshape(b, w).astype(np.int32)
    table[2, 2:] = n_pool - 1                   # dump-padded row
    pos = np.array([0, 31, 9], np.int32)        # first token, full, ragged
    return kpool, vpool, table, pos


def test_decode_layer_paged_matches_jax(weights):
    jcfg, tcfg, jstate, tstate = weights
    rng = np.random.RandomState(3)
    kpool, vpool, table, pos = _paged_setup(tcfg, rng)
    x = rng.randn(3, tcfg.hidden_size).astype(np.float32)
    jc, js = JL._rope_tables(32, tcfg.head_dim, tcfg.rope_theta)
    tc, ts = TL._rope_tables(32, tcfg.head_dim, tcfg.rope_theta)
    jcos, jsin = JG._rope_at(jc, js, jnp.asarray(pos))
    tcos, tsin = TG._rope_at(tc, ts, torch.from_numpy(pos).long())
    jo, jk, jv = jax.jit(lambda *a: JG._decode_layer_paged(*a, jcfg))(
        JG._layer_weights(jstate, 0), jnp.asarray(x), jnp.asarray(kpool),
        jnp.asarray(vpool), jnp.asarray(table), jcos, jsin,
        jnp.asarray(pos))
    tk, tv = torch.from_numpy(kpool.copy()), torch.from_numpy(vpool.copy())
    to = TG._decode_layer_paged(
        TG._layer_weights(tstate, 0), torch.from_numpy(x), tk, tv,
        torch.from_numpy(table), tcos, tsin, torch.from_numpy(pos), tcfg)
    _close(to, jo)
    _close(tk, jk)          # this token's K/V written in place
    _close(tv, jv)
    assert not np.allclose(tk.numpy(), kpool)


def test_prefill_layer_cached_matches_jax(weights):
    jcfg, tcfg, jstate, tstate = weights
    rng = np.random.RandomState(4)
    kpool, vpool, table, _ = _paged_setup(tcfg, rng)
    row = table[1]
    cached, s, suffix = 11, 8, 6          # 6 real suffix tokens, 2 padding
    w_ps = row.size * kpool.shape[2]
    x = rng.randn(1, s, tcfg.hidden_size).astype(np.float32)
    j = np.arange(s)
    mask = np.concatenate(
        [np.broadcast_to(np.arange(w_ps)[None] < cached, (s, w_ps)),
         (j[None] <= j[:, None]) & (j[None] < suffix)], axis=1)[None, None]
    jc, js = JL._rope_tables(w_ps, tcfg.head_dim, tcfg.rope_theta)
    tc, ts = TL._rope_tables(w_ps, tcfg.head_dim, tcfg.rope_theta)
    kpre = _jax_gather(kpool, row)
    vpre = _jax_gather(vpool, row)
    jo = jax.jit(lambda *a: JR._prefill_layer_cached(*a, jcfg))(
        JG._layer_weights(jstate, 1), jnp.asarray(x), jnp.asarray(kpre),
        jnp.asarray(vpre), jc[cached:cached + s], js[cached:cached + s],
        jnp.asarray(mask))
    to = TR._prefill_layer_cached(
        TG._layer_weights(tstate, 1), torch.from_numpy(x),
        torch.from_numpy(kpre), torch.from_numpy(vpre),
        tc[cached:cached + s], ts[cached:cached + s],
        torch.from_numpy(mask), tcfg)
    for t, jj in zip(to, jo):
        _close(t, jj)


def _jax_gather(pool, row):
    return np.array(JPA.gather_kv_pages(jnp.asarray(pool),
                                        jnp.asarray(row)))[None]


def test_quantized_weight_not_ported():
    """Named when the K4 GEMV was not ported yet and ``_mm`` raised on a
    quantized weight.  Now ``_mm`` on a legacy ``(int8, scale)`` pair and
    on int8 / int4 ``QuantizedWeight``s must match the reference's
    ``_mm`` (float32, 1e-5)."""
    from paddle_tpu.ops.pallas import quant_matmul as JQM
    from paddle_tpu_torch.ops.pallas import quant_matmul as TQM
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    q8 = rng.integers(-127, 128, (64, 128)).astype(np.int8)
    q4 = rng.integers(-8, 8, (64, 128)).astype(np.int8)
    s = (rng.random(128) * 0.02 + 1e-3).astype(np.float32)
    jp4 = np.asarray(JQM.pack_int4(jnp.asarray(q4)))
    cases = [
        ((jnp.asarray(q8), jnp.asarray(s)),
         (torch.from_numpy(q8), torch.from_numpy(s))),
        (JQM.QuantizedWeight(jnp.asarray(q8), jnp.asarray(s)),
         TQM.QuantizedWeight(torch.from_numpy(q8), torch.from_numpy(s))),
        (JQM.QuantizedWeight(jnp.asarray(jp4), jnp.asarray(s), "int4", 64),
         TQM.QuantizedWeight(torch.from_numpy(jp4), torch.from_numpy(s),
                             "int4", 64))]
    for jw, tw in cases:
        want = np.asarray(JG._mm(jnp.asarray(x), jw))
        got = TG._mm(torch.from_numpy(x), tw).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
