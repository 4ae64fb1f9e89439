"""paddle_tpu_torch gather-LoRA matmul (K5) against the JAX package.

The same numpy inputs (from a seed) go through the reference and the
port on the CPU, where the port's ``lora_gather_matmul`` runs its plain
version ``_xla_gather_matmul``.  It is held against the Pallas kernel in
interpret mode and against the reference's ``_xla_gather_matmul``, with
a mixed index vector that includes the zero row 0:

  * f32 bank, f32 x: max |out - ref| <= 1e-5 x max |ref| (summation
    order only);
  * bf16 bank, f32 x: the Pallas body rounds h = x A^T to the bank's
    dtype before the second product (``lora_matmul.py:60``) and the
    plain versions keep h in f32 — one bf16 rounding (2^-9 relative)
    of each h element, so per output row ||out - ref|| / ||ref|| <=
    2^-7 against the kernel, 1e-5 against the reference's plain path;
  * rows with index 0 are exactly zero everywhere.

``lora_delta`` is also held with a scalar index (the prefill shape:
plain f32 matmuls on both sides).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from paddle_tpu.ops.pallas import lora_matmul as JLM
from paddle_tpu_torch.ops.pallas import lora_matmul as TLM

IDX = np.array([0, 1, 2, 3, 4, 1, 0, 2], np.int32)


def _bank(rows, r, k, m, bank_dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(IDX), k)).astype(np.float32)
    a = (rng.standard_normal((rows, r, k)) / np.sqrt(k)).astype(np.float32)
    b = (rng.standard_normal((rows, r, m)) / np.sqrt(r)).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0
    scale = (rng.random(rows) + 0.5).astype(np.float32)
    if bank_dtype == "bfloat16":
        a, b = a.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16)
    return x, a, b, scale


def _t(a):
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _rows(out, ref):
    return (np.linalg.norm(out - ref, axis=-1)
            / np.maximum(np.linalg.norm(ref, axis=-1), 1e-30))


@pytest.mark.parametrize("bank_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,m,r", [(64, 96, 4), (128, 40, 16)])
def test_gather_matmul_matches_reference(bank_dtype, k, m, r):
    x, a, b, scale = _bank(5, r, k, m, bank_dtype)
    jargs = [jnp.asarray(v) for v in (x, a, b, scale, IDX)]
    saved = JLM._INTERPRET
    JLM._INTERPRET = True
    try:
        kernel = np.asarray(JLM.lora_gather_matmul(*jargs), np.float32)
    finally:
        JLM._INTERPRET = saved
    xla = np.asarray(JLM._xla_gather_matmul(*jargs), np.float32)
    out = TLM.lora_gather_matmul(*[_t(v) for v in (x, a, b, scale, IDX)])
    assert out.dtype == torch.float32 and tuple(out.shape) == (len(IDX), m)
    out = out.numpy()
    zero = IDX == 0
    for ref in (kernel, xla):
        assert not ref[zero].any()
    assert not out[zero].any()
    live = ~zero
    np.testing.assert_allclose(out, xla, rtol=0,
                               atol=1e-5 * np.abs(xla).max())
    if bank_dtype == "float32":
        np.testing.assert_allclose(out, kernel, rtol=0,
                                   atol=1e-5 * np.abs(kernel).max())
    else:
        assert _rows(out[live], kernel[live]).max() <= 2 ** -7


def test_gather_matmul_bf16_x():
    """bf16 activations: every side rounds the f32 result to bf16 once."""
    x, a, b, scale = _bank(5, 8, 64, 96, "float32", seed=3)
    xb = x.astype(ml_dtypes.bfloat16)
    jargs = [jnp.asarray(v) for v in (xb, a, b, scale, IDX)]
    want = np.asarray(JLM._xla_gather_matmul(*jargs), np.float32)
    got = TLM.lora_gather_matmul(*[_t(v) for v in (xb, a, b, scale, IDX)])
    assert got.dtype == torch.bfloat16
    live = IDX != 0
    assert _rows(got.float().numpy()[live], want[live]).max() <= 2 ** -7


def test_gather_matmul_rejects():
    x, a, b, scale = _bank(3, 4, 32, 16, "float32")
    args = [_t(v) for v in (x, a, b, scale, IDX)]
    with pytest.raises(ValueError, match="K mismatch"):
        TLM.lora_gather_matmul(args[0][:, :31], *args[1:])
    with pytest.raises(ValueError, match="bank mismatch"):
        TLM.lora_gather_matmul(args[0], args[1], args[2][:2], *args[3:])
    with pytest.raises(ValueError, match=r"\[S, K\]"):
        TLM.lora_gather_matmul(args[0][None], *args[1:])


@pytest.mark.parametrize("idx", [0, 2, "vector"])
def test_lora_delta_matches_reference(idx):
    """The packed-bank entry: ``[..., K]`` activations, a per-row index
    vector (K5) or one scalar for the whole call (plain matmuls)."""
    rng = np.random.default_rng(4)
    L, rows, r, k, m = 2, 4, 4, 32, 48
    bank = {"a": {"q": (rng.standard_normal((L, rows, r, k)) * 0.2)
                  .astype(np.float32)},
            "b": {"q": (rng.standard_normal((L, rows, r, m)) * 0.2)
                  .astype(np.float32)},
            "scale": np.array([0.0, 2.0, 0.5, 1.5], np.float32)}
    bank["a"]["q"][:, 0] = 0.0
    bank["b"]["q"][:, 0] = 0.0
    x = rng.standard_normal((2, 3, k)).astype(np.float32)
    aidx = (np.array([0, 1, 2, 3, 1, 0], np.int32) if idx == "vector"
            else idx)
    jbank = {"a": {"q": jnp.asarray(bank["a"]["q"])},
             "b": {"q": jnp.asarray(bank["b"]["q"])},
             "scale": jnp.asarray(bank["scale"])}
    tbank = {"a": {"q": _t(bank["a"]["q"])}, "b": {"q": _t(bank["b"]["q"])},
             "scale": _t(bank["scale"])}
    want = np.asarray(JLM.lora_delta(jbank, "q", 1, jnp.asarray(x),
                                     jnp.asarray(aidx)))
    got = TLM.lora_delta(tbank, "q", 1, _t(x),
                         _t(aidx) if idx == "vector" else aidx)
    assert tuple(got.shape) == (2, 3, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30))
    if idx == 0:
        assert not got.numpy().any()


@pytest.mark.parametrize("s,k", [(8, 4096), (8, 14336), (8, 1024),
                                 (64, 4096), (64, 14336), (1, 4096),
                                 (3, 1001), (8, 100)])
def test_shrink_splits_rule(s, k):
    """The CUDA shrink's split of K (a rule of shapes, so a call never
    reads idx on the host): chunks of 128-element multiples that cover K
    once with no empty split, at least 256 elements long where K allows,
    and about two (split, slot) CTAs per SM on 132 SMs."""
    sms = 132
    splits, chunk = TLM._splits(k, s, sms)
    assert chunk % 128 == 0 and splits >= 1
    assert (splits - 1) * chunk < k <= splits * chunk
    assert chunk >= min(256, -(-k // 128) * 128)
    assert splits <= max(1, -(-2 * sms // s))
    if k >= 256 * -(-2 * sms // s):     # K long enough to fill the card
        assert splits * s > sms
