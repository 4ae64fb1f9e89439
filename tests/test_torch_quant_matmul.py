"""paddle_tpu_torch weight-only quantization (K4) against the JAX package.

The same numpy inputs (from a seed) go through the reference and the
port on the CPU:

  * ``pack_int4`` / ``unpack_int4``: byte-identical;
  * ``weight_quantize`` (per-channel int8 and int4, packed bytes
    included) and ``weight_dequantize``: bit-identical in float32 (both
    divide in IEEE f32 and round half to even);
  * ``weight_only_matmul`` — on the CPU the port's plain version
    ``_xla_fallback`` — against the Pallas kernel in interpret mode and
    against the reference's ``_xla_fallback``, at the reference test's
    shapes plus M = 64 and M = 256 (M > 64 is the XLA route on both
    sides).  float32: max |out - ref| <= 1e-5 x max |ref| (summation
    order only); bfloat16: per output row ||out - ref|| / ||ref|| <=
    2^-7 (both round once to bf16 at the output, and x is the same bf16
    bits on both sides).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from paddle_tpu.nn import quant as JQ
from paddle_tpu.ops.pallas import quant_matmul as JQM
from paddle_tpu_torch.nn import quant as TQ
from paddle_tpu_torch.ops.pallas import quant_matmul as TQM

F32_REL = 1e-5
BF16_ROW = 2 ** -7
SHAPES = [(8, 256, 512), (1, 512, 384), (8, 250, 512), (64, 256, 384),
          (256, 256, 512)]


def _t(a):
    """numpy (bf16 included) -> torch with the same bits."""
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_pack_unpack_int4_matches_reference():
    rng = np.random.default_rng(1)
    q = rng.integers(-8, 8, (64, 256)).astype(np.int8)
    jp = np.asarray(JQM.pack_int4(jnp.asarray(q)))
    tp = TQM.pack_int4(torch.from_numpy(q))
    assert tp.dtype == torch.int8 and tp.shape == (32, 256)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(TQM.unpack_int4(tp).numpy(), q)
    np.testing.assert_array_equal(
        TQM.unpack_int4(tp, 63).numpy(),
        np.asarray(JQM.unpack_int4(jnp.asarray(jp), 63)))
    with pytest.raises(ValueError, match="even K"):
        TQM.pack_int4(torch.from_numpy(q[:63]))


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
@pytest.mark.parametrize("k,n", [(256, 384), (96, 130)])
def test_weight_quantize_bit_identical(algo, k, n):
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    w[:, 0] = 0.0                                  # an all-zero column
    w[3, 1] = 0.5                                  # a dominant entry
    jq, js = JQ.weight_quantize.__op_body__(jnp.asarray(w), algo)
    tq, ts = TQ.weight_quantize(torch.from_numpy(w), algo)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    jd = JQ.weight_dequantize.__op_body__(jq, js, algo)
    np.testing.assert_array_equal(TQ.weight_dequantize(tq, ts, algo).numpy(),
                                  np.asarray(jd))


def test_weight_quantize_rejects():
    w = torch.zeros(63, 8)
    with pytest.raises(ValueError, match="even K"):
        TQ.weight_quantize(w, "weight_only_int4")
    with pytest.raises(ValueError, match="algo"):
        TQ.weight_quantize(w, "fp8")
    with pytest.raises(NotImplementedError,
                       match="queue 1, Paddle API surface"):
        TQ.weight_quantize(torch.zeros(128, 8), group_size=64)


def _inputs(m, k, n, kind, dt, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 0.3).astype(np.float32)
    if dt == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    bound = 127 if kind == "int8" else 7
    q = rng.integers(-bound, bound + 1, (k, n)).astype(np.int8)
    s = (rng.random(n) * 0.02 + 1e-3).astype(np.float32)
    if kind == "int4":
        p = np.array(JQM.pack_int4(jnp.asarray(q)))
        jw = JQM.QuantizedWeight(jnp.asarray(p), jnp.asarray(s), "int4", k)
        tw = TQM.QuantizedWeight(torch.from_numpy(p), torch.from_numpy(s),
                                 "int4", k)
    else:
        jw = JQM.QuantizedWeight(jnp.asarray(q), jnp.asarray(s))
        tw = TQM.QuantizedWeight(torch.from_numpy(q), torch.from_numpy(s))
    return x, jw, tw


def _assert_close(out, ref, dt):
    out, ref = out.astype(np.float32), ref.astype(np.float32)
    if dt == "float32":
        assert np.abs(out - ref).max() <= F32_REL * np.abs(ref).max()
    else:
        rows = (np.linalg.norm(out - ref, axis=-1)
                / np.linalg.norm(ref, axis=-1))
        assert rows.max() <= BF16_ROW, rows.max()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_weight_only_matmul_matches_reference(m, k, n, kind, dt):
    if kind == "int4" and k % 2:
        pytest.skip("int4 needs even K")
    x, jw, tw = _inputs(m, k, n, kind, dt)
    saved = JQM._INTERPRET
    JQM._INTERPRET = True
    try:
        kernel = np.asarray(JQM.weight_only_matmul(jnp.asarray(x), jw))
    finally:
        JQM._INTERPRET = saved
    xla = np.asarray(JQM._xla_fallback(jnp.asarray(x), jw))
    out = TQM.weight_only_matmul(_t(x), tw)
    assert out.dtype == _t(x).dtype and tuple(out.shape) == (m, n)
    for ref in (kernel, xla):
        _assert_close(_np(out), np.asarray(ref, np.float32), dt)


def test_quantized_weight_surface():
    x, jw, tw = _inputs(2, 64, 128, "int4", "float32")
    assert tw.shape == jw.shape == (64, 128)
    np.testing.assert_array_equal(
        tw.dequantize(torch.float32).numpy(),
        np.asarray(jw.dequantize(jnp.float32)))
    moved = tw.to("cpu")
    assert moved.kind == "int4" and moved.k == 64
    assert torch.equal(moved.q, tw.q) and torch.equal(moved.scale, tw.scale)
    for n in (128, 384, 1000, 14336):
        assert TQM._block_n(n) == JQM._block_n(n)
    with pytest.raises(ValueError, match="K mismatch"):
        TQM.weight_only_matmul(torch.zeros(2, 63), tw)
