"""paddle_tpu_torch's grouped expert FFN (``ops/pallas/grouped_ffn``)
against the JAX package's K9 kernel, run in Pallas interpret mode (the
fixture sets ``G._INTERPRET``, as ``tests/test_grouped_ffn.py`` does).

The port's plain forward (``grouped_ffn_xla``) and plain backward
(``_plain_bwd``, reached through ``grouped_ffn``'s autograd on CPU
tensors) are held to the reference's ``grouped_ffn`` and its
``jax.vjp``, on seeded numpy inputs, with an expert that owns no tile
and trailing tiles clipped to the last expert.

Tolerances: float32 2e-5 relative + 2e-5 absolute (the reference test's
own; f32 sums in another order).  bf16 weights (with float32 biases):
outputs within 2^-7 relative + 2^-7 x the output's largest entry —
both sides round h and ds to bf16 from f32 sums taken in another order,
which flips a last bf16 bit now and then, and round each output once.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import grouped_ffn as G
from paddle_tpu_torch.ops.pallas import grouped_ffn as TG

F32_TOL = dict(rtol=2e-5, atol=2e-5)
EMAP = [0, 0, 1, 3, 3, 3]        # expert 2 owns no tile; 3 has the tail


@pytest.fixture(autouse=True)
def _interpret():
    G._INTERPRET = True
    yield
    G._INTERPRET = False


def _inputs(seed, e=4, d=64, f=96, gated=False, emap=EMAP):
    rng = np.random.default_rng(seed)
    r = len(emap) * G.TILE
    f2 = 2 * f if gated else f
    return {"x": rng.standard_normal((r, d)).astype(np.float32) * 0.5,
            "w1": rng.standard_normal((e, d, f2)).astype(np.float32) * 0.15,
            "b1": rng.standard_normal((e, f2)).astype(np.float32) * 0.1,
            "w2": rng.standard_normal((e, f, d)).astype(np.float32) * 0.1,
            "b2": rng.standard_normal((e, d)).astype(np.float32) * 0.1,
            "emap": np.asarray(emap, np.int32),
            "dy": rng.standard_normal((r, d)).astype(np.float32)}


KEYS = ("x", "w1", "b1", "w2", "b2")


def _jax_args(a, wdt):
    dts = {"x": wdt, "w1": wdt, "b1": jnp.float32, "w2": wdt,
           "b2": jnp.float32}
    return [jnp.asarray(a[k]).astype(dts[k]) for k in KEYS]


def _torch_args(a, wdt):
    dts = {"x": wdt, "w1": wdt, "b1": torch.float32, "w2": wdt,
           "b2": torch.float32}
    return [torch.from_numpy(a[k]).to(dts[k]) for k in KEYS]


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _close(got, want, wdt_is_bf16):
    got, want = _np(got), _np(want)
    if not wdt_is_bf16:
        np.testing.assert_allclose(got, want, **F32_TOL)
        return
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7 * scale)


@pytest.mark.parametrize("gated", [False, True])
def test_plain_forward_matches_interpret_kernel(gated):
    a = _inputs(0, gated=gated)
    emap_j = jnp.asarray(a["emap"])
    want = G.grouped_ffn(*_jax_args(a, jnp.float32), emap_j, gated)
    got = TG.grouped_ffn_xla(*_torch_args(a, torch.float32),
                             torch.from_numpy(a["emap"]), gated)
    _close(got, want, False)


@pytest.mark.parametrize("gated", [False, True])
def test_plain_backward_matches_jax_vjp(gated):
    a = _inputs(1, gated=gated)
    emap_j = jnp.asarray(a["emap"])
    out_j, vjp = jax.vjp(
        lambda *p: G.grouped_ffn(*p, emap_j, gated),
        *_jax_args(a, jnp.float32))
    want = vjp(jnp.asarray(a["dy"]))
    leaves = [t.requires_grad_() for t in _torch_args(a, torch.float32)]
    out = TG.grouped_ffn(*leaves, torch.from_numpy(a["emap"]), gated)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(a["dy"]))
    _close(out.detach(), out_j, False)
    for name, g, w in zip(KEYS, got, want):
        assert g.dtype == leaves[KEYS.index(name)].dtype
        _close(g, w, False)
    # the expert with no tile: exact zeros on both sides
    for g in got[1:]:
        assert not g[2].abs().any()


def test_bf16_weights_with_f32_biases():
    a = _inputs(2)
    emap_j = jnp.asarray(a["emap"])
    out_j, vjp = jax.vjp(lambda *p: G.grouped_ffn(*p, emap_j),
                         *_jax_args(a, jnp.bfloat16))
    want = vjp(jnp.asarray(a["dy"]).astype(jnp.bfloat16))
    leaves = [t.requires_grad_() for t in _torch_args(a, torch.bfloat16)]
    out = TG.grouped_ffn(*leaves, torch.from_numpy(a["emap"]))
    got = torch.autograd.grad(out, leaves,
                              torch.from_numpy(a["dy"]).bfloat16())
    assert out.dtype == torch.bfloat16
    _close(out.detach(), out_j, True)
    for g, w, leaf in zip(got, want, leaves):
        assert g.dtype == leaf.dtype
        _close(g, w, True)


def test_every_tile_on_one_expert():
    """All rows on expert 1 of 3: the other two get zero gradients."""
    a = _inputs(3, e=3, emap=[1, 1, 1])
    emap_j = jnp.asarray(a["emap"])
    _, vjp = jax.vjp(lambda *p: G.grouped_ffn(*p, emap_j),
                     *_jax_args(a, jnp.float32))
    want = vjp(jnp.asarray(a["dy"]))
    leaves = [t.requires_grad_() for t in _torch_args(a, torch.float32)]
    out = TG.grouped_ffn(*leaves, torch.from_numpy(a["emap"]))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(a["dy"]))
    for g, w in zip(got, want):
        _close(g, w, False)
    for g in got[1:]:
        assert not g[0].abs().any() and not g[2].abs().any()
