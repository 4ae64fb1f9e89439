"""paddle_tpu_torch masked flash forward (K8 forward port) and the sdpa
dispatch, against the JAX package.

The same numpy inputs (from a seed) go through the JAX masked kernel in
interpret mode (through ``_pallas_sdpa_masked``, which pads to its
block multiples), the JAX ``sdpa`` (on the CPU: its XLA path with the
dense mask) and the port's ``sdpa`` / ``flash_mha_masked`` (on CPU
tensors: the plain version).  float32 throughout; tolerance 1e-5
absolute — the paths differ only in summation order and in online vs.
one-pass softmax.  The CUDA kernel is held against the same plain
version on the card (chip_smoke.py and tests/test_torch_cuda_kernels.py).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu.ops.pallas import flash_mask as JFM
from paddle_tpu_torch.ops.pallas import flash_attention as TFA
from paddle_tpu_torch.ops.pallas import flash_mask as TFM

ATOL = 1e-5


@pytest.fixture
def interpret():
    JFM._INTERPRET, saved = True, JFM._INTERPRET
    yield
    JFM._INTERPRET = saved


def _qkv(seed, b, sq, sk, h, kvh, d=64):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, sq, h, d) * 0.5).astype(np.float32)
    k = (rng.randn(b, sk, kvh, d) * 0.5).astype(np.float32)
    v = rng.randn(b, sk, kvh, d).astype(np.float32)
    return q, k, v


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


# (name, b, sq, sk, h, kvh, causal, real key lengths per batch)
PADDING_CASES = [
    ("causal", 2, 160, 160, 4, 4, True, (160, 97)),
    ("noncausal", 2, 160, 160, 4, 4, False, (131, 160)),
    ("gqa", 2, 144, 144, 4, 2, True, (144, 70)),
    ("sq_lt_sk", 1, 100, 230, 4, 2, True, (201,)),
    ("sq_gt_sk", 1, 200, 130, 2, 1, True, (130,)),   # rows with no key
    ("empty_batch", 2, 160, 160, 4, 4, False, (160, 0)),
]


@pytest.mark.parametrize("case", PADDING_CASES, ids=[c[0] for c in PADDING_CASES])
def test_key_padding_matches_jax(interpret, case):
    _, b, sq, sk, h, kvh, causal, real = case
    q, k, v = _qkv(sum(map(ord, case[0])), b, sq, sk, h, kvh)
    keep = np.arange(sk)[None, :] < np.asarray(real)[:, None]
    (jq, jk, jv, jkeep), (tq, tk, tv, tkeep) = _both(q, k, v, keep)
    j_kernel = np.asarray(JFA._pallas_sdpa_masked(
        jq, jk, jv, JFM.padding_mask_to_intervals(jkeep, sq), causal))
    j_sdpa = np.asarray(JFA.sdpa(jq, jk, jv, attn_mask=jkeep[:, None, None],
                                 is_causal=causal))
    t_out = TFA.sdpa(tq, tk, tv, attn_mask=tkeep[:, None, None],
                     is_causal=causal).numpy()
    np.testing.assert_allclose(t_out, j_kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_out, j_sdpa, atol=ATOL, rtol=0)
    if case[0] in ("sq_gt_sk", "empty_batch"):
        # fully masked rows are zeros, in every path
        dead = np.abs(t_out).sum(axis=(2, 3)) == 0
        assert dead.any()
        np.testing.assert_array_equal(j_kernel[dead], 0)


def test_segment_nvec4_matches_jax_kernel(interpret):
    b, s, h = 1, 192, 2
    q, k, v = _qkv(7, b, s, s, h, h)
    seg = np.repeat(np.arange(3), [50, 90, 52])[None].astype(np.int32)
    (jq, jk, jv, jseg), (tq, tk, tv, tseg) = _both(q, k, v, seg)
    jvec = JFM.segment_intervals(jseg, causal=False)
    tvec = TFM.segment_intervals(tseg, causal=False)
    np.testing.assert_array_equal(tvec.numpy(), np.asarray(jvec))
    assert tvec.shape[2] == 4
    j_out = np.asarray(JFA._pallas_sdpa_masked(jq, jk, jv, jvec, False))
    t_out = TFA.sdpa(tq, tk, tv, flashmask=tvec).numpy()
    np.testing.assert_allclose(t_out, j_out, atol=ATOL, rtol=0)


def test_flash_mha_masked_bhsd_matches_plain_sdpa():
    """The [B, H, S, D] entry point with explicit sm_scale vs the port's
    own dense reference on the same intervals."""
    q, k, v = _qkv(11, 2, 96, 96, 4, 2)
    _, (tq, tk, tv) = _both(q, k, v)
    keep = torch.arange(96)[None] < torch.tensor([96, 40])[:, None]
    vecs = TFM.padding_mask_to_intervals(keep, 96)
    before = TFM.flash_mha_masked.launches
    out = TFM.flash_mha_masked(tq.transpose(1, 2), tk.transpose(1, 2),
                               tv.transpose(1, 2), vecs, True, 0.125)
    assert TFM.flash_mha_masked.launches == before   # CPU: plain version
    dense = TFM.dense_mask_from_intervals(vecs, 96, 96)
    ref = TFA._xla_sdpa(tq, tk, tv, attn_mask=dense, is_causal=True,
                        scale=0.125)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), ref.numpy(),
                               atol=ATOL, rtol=0)


def test_interval_helpers_match_jax():
    rng = np.random.RandomState(5)
    key = rng.rand(3, 40) > 0.3
    np.testing.assert_array_equal(
        TFM.padding_mask_to_intervals(torch.from_numpy(key), 17).numpy(),
        np.asarray(JFM.padding_mask_to_intervals(jnp.asarray(key), 17)))
    seg = np.sort(rng.randint(0, 4, (2, 30)), axis=1).astype(np.int32)
    for causal in (True, False):
        tv = TFM.segment_intervals(torch.from_numpy(seg), causal=causal)
        jv = JFM.segment_intervals(jnp.asarray(seg), causal=causal)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(
            TFM.dense_mask_from_intervals(tv, 30, 30).numpy(),
            np.asarray(JFM.dense_mask_from_intervals(jv, 30, 30)))
        np.testing.assert_array_equal(
            TFM.pad_intervals(tv, 64).numpy(),
            np.asarray(JFM.pad_intervals(jv, 64)))


def _spy(calls, name, result):
    def fn(q, *args, **kwargs):
        calls.append(name)
        return result(q)
    return fn


def test_dispatch_routes_like_jax(monkeypatch):
    """A [B, 1, 1, S] bool mask takes the masked kernel route and a
    [1, 1, S, T] bool mask the plain route — in the port, and in the JAX
    package when its backend gate would admit the kernels (S >= 128 on a
    TPU)."""
    s = 128
    q, k, v = _qkv(3, 1, s, s, 2, 2)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    pad = np.ones((1, 1, 1, s), bool)
    arb = np.tril(np.ones((s, s), bool))[None, None]

    calls = []
    monkeypatch.setattr(TFA, "_sdpa_masked",
                        _spy(calls, "masked", torch.zeros_like))
    monkeypatch.setattr(TFA, "_xla_sdpa", _spy(calls, "plain",
                                                torch.zeros_like))
    TFA.sdpa(tq, tk, tv, attn_mask=torch.from_numpy(pad), is_causal=True)
    TFA.sdpa(tq, tk, tv, attn_mask=torch.from_numpy(arb))
    assert calls == ["masked", "plain"]

    jcalls = []
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(JFA, "_probe_pallas", lambda: True)
    monkeypatch.setattr(JFA, "_pallas_sdpa_masked",
                        _spy(jcalls, "masked", jnp.zeros_like))
    monkeypatch.setattr(JFA, "_xla_sdpa", _spy(jcalls, "plain",
                                                jnp.zeros_like))
    JFA.sdpa(jq, jk, jv, attn_mask=jnp.asarray(pad), is_causal=True)
    JFA.sdpa(jq, jk, jv, attn_mask=jnp.asarray(arb))
    assert jcalls == calls


def test_unported_routes_raise():
    """The dense-bias route (K8 with a bias) still raises; the unmasked
    route runs the ported K1 (its plain version on the CPU)."""
    q, k, v = _qkv(1, 1, 8, 8, 2, 2)
    _, (tq, tk, tv) = _both(q, k, v)
    out = TFA.sdpa(tq, tk, tv, is_causal=True)
    assert out.shape == tq.shape and torch.isfinite(out).all()
    with pytest.raises(NotImplementedError, match="K8"):
        TFA.sdpa(tq, tk, tv, attn_mask=torch.zeros(1, 1, 8, 8))


def test_dropout_takes_plain_route():
    q, k, v = _qkv(2, 1, 16, 16, 2, 2)
    _, (tq, tk, tv) = _both(q, k, v)
    keep = torch.ones(1, 1, 1, 16, dtype=torch.bool)
    g = torch.Generator().manual_seed(0)
    out = TFA.sdpa(tq, tk, tv, attn_mask=keep, dropout_p=0.5,
                   is_causal=True, generator=g)
    ref = TFA.sdpa(tq, tk, tv, attn_mask=keep, is_causal=True)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert not torch.allclose(out, ref)
    assert math.isclose(float(TFA.MASK_VAL), float(JFA.MASK_VAL))
    assert TFA.LSE_INVALID == JFA.LSE_INVALID
