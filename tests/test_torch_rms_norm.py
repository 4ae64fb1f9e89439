"""paddle_tpu_torch's RMSNorm (``ops/pallas/rms_norm``, K6) and
``incubate.nn.functional.fused_rms_norm`` against the JAX package's.

The reference has no interpret switch for K6, so this file runs its
kernel body ``_rms_kernel`` through a ``pallas_call(...,
interpret=True)`` it builds itself (the reference's own grid and block
specs), leaving the JAX package untouched.  Held against it: the port's
plain K6 version (what ``rms_norm`` runs on CPU tensors at d % 128 == 0)
in float32 and bf16.  Held against the reference's functions:
``fused_rms_norm`` with residual, bias and ``norm_bias``, the backward
against ``jax.vjp`` of ``rms_norm``, and the d % 128 != 0 route (the
reference's cast-first body) in bf16.

Tolerances: float32 2e-6 relative + 2e-6 absolute (the row mean and
rsqrt in another order); bf16 one bf16 rounding (2^-8 relative) of the
output, where the f32 statistics differ in their last bits.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from paddle_tpu.incubate.nn import functional as JF
from paddle_tpu.ops.pallas import rms_norm as JR
from paddle_tpu_torch.incubate.nn import functional as TF
from paddle_tpu_torch.ops.pallas import rms_norm as TR

F32_TOL = dict(rtol=2e-6, atol=2e-6)
BF16_TOL = dict(rtol=2 ** -8, atol=2 ** -8)
EPS = 1e-6


def _interpret_k6(x2d, w, eps):
    """The reference's K6 body under its own grid, in interpret mode."""
    n, d = x2d.shape
    block = 8
    with jax.enable_x64(False):
        return pl.pallas_call(
            functools.partial(JR._rms_kernel, eps=eps),
            grid=(n // block,),
            in_specs=[pl.BlockSpec((block, d), lambda i: (i, 0)),
                      pl.BlockSpec((1, d), lambda i: (0, 0))],
            out_specs=pl.BlockSpec((block, d), lambda i: (i, 0)),
            out_shape=jax.ShapeDtypeStruct((n, d), x2d.dtype),
            interpret=True,
        )(x2d, w.reshape(1, d))


def _data(seed, n, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32) * 2.0,
            (1.0 + 0.2 * rng.standard_normal(d)).astype(np.float32))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_k6_matches_interpret_kernel(dt):
    x, w = _data(0, 16, 256)
    want = _interpret_k6(jnp.asarray(x).astype(dt), jnp.asarray(w).astype(dt),
                         EPS)
    tdt = getattr(torch, dt)
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    got = TR.rms_norm(xt, wt, EPS)       # CPU: the plain K6 version
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32_TOL if dt == "float32" else BF16_TOL))
    np.testing.assert_array_equal(_np(got), _np(TR._plain_rms(xt, wt, EPS)))


@pytest.mark.parametrize("with_residual", [False, True])
def test_fused_rms_norm_matches_reference(with_residual):
    x, w = _data(1, 12, 128)
    rng = np.random.default_rng(2)
    res, bias, nb = (rng.standard_normal(s).astype(np.float32)
                     for s in ((12, 128), (128,), (128,)))
    kw_j = dict(norm_bias=jnp.asarray(nb), bias=jnp.asarray(bias),
                residual=jnp.asarray(res) if with_residual else None,
                epsilon=1e-5, begin_norm_axis=1, quant_scale=0.5)
    want = JF.fused_rms_norm.__op_body__(jnp.asarray(x), jnp.asarray(w),
                                         **kw_j)
    kw_t = dict(norm_bias=torch.from_numpy(nb), bias=torch.from_numpy(bias),
                residual=torch.from_numpy(res) if with_residual else None,
                epsilon=1e-5, begin_norm_axis=1, quant_scale=0.5)
    got = TF.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w), **kw_t)
    if with_residual:
        assert isinstance(got, tuple) and len(got) == 2
        for g, wj in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(wj), **F32_TOL)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("d", [128, 96])
def test_backward_matches_jax_vjp(d):
    x, w = _data(3, 10, d)
    g = np.random.default_rng(4).standard_normal((10, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: JR.rms_norm(a, b, 1e-6), jnp.asarray(x),
                     jnp.asarray(w))
    want = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = torch.autograd.grad(TR.rms_norm(xt, wt), (xt, wt),
                              torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)


def test_narrow_width_takes_the_reference_cast_first_body():
    """d % 128 != 0: the reference's plain body in bf16, the normalised
    row rounded before the weight multiply (an f32 weight promotes)."""
    x, w = _data(5, 6, 96)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    for wdt in ("bfloat16", "float32"):
        want = JR.rms_norm(xj, jnp.asarray(w).astype(wdt), EPS)
        got = TR.rms_norm(xt, torch.from_numpy(w).to(getattr(torch, wdt)),
                          EPS)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
