"""paddle_tpu_torch masked flash attention (K8) gradients against the JAX
package's Pallas kernels.

The same numpy inputs (from a seed) go through the JAX
``_pallas_sdpa_masked`` — its ``flash_mha_masked`` custom_vjp, with the
Pallas kernels in interpret mode: the resident kernels here, the
streamed long-sequence variants forced on at S 256 in
``test_torch_flash_mask_grad_stream.py`` — and through
the port's ``sdpa`` on CPU tensors (the plain versions of the K8
forward, dq and dk/dv kernels).  Out and the gradients of sum(out * g)
for a random cotangent g are held to the JAX package's own tolerances
(``tests/test_flash_mask.py``): forward 3e-5 absolute, gradients 5e-4
absolute, float32 throughout.  The CUDA kernels are held against the
same plain versions on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu.ops.pallas import flash_mask as JFM
from paddle_tpu_torch.ops.pallas import flash_attention as TFA

FWD_ATOL = 3e-5
GRAD_ATOL = 5e-4
D = 64


@contextlib.contextmanager
def interpret_mode(stream):
    """Run the JAX kernels in interpret mode, resident or streamed;
    restore both flags afterwards."""
    saved = (JFM._INTERPRET, JFA._FORCE_STREAM)
    JFM._INTERPRET = True
    JFA._FORCE_STREAM = stream
    try:
        yield
    finally:
        JFM._INTERPRET, JFA._FORCE_STREAM = saved


@pytest.fixture
def resident():
    with interpret_mode(stream=False):
        yield


def _inputs(seed, b, sq, sk, h, kvh):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, sq, h, D) * 0.3).astype(np.float32)
    k = (rng.randn(b, sk, kvh, D) * 0.3).astype(np.float32)
    v = (rng.randn(b, sk, kvh, D) * 0.3).astype(np.float32)
    g = rng.randn(b, sq, h, D).astype(np.float32)
    return q, k, v, g


def _jax_grads(fn, arrays, g):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _torch_grads(fn, arrays, g):
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out = fn(*leaves)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


def _segments(b, s, sizes):
    return np.repeat(np.arange(len(sizes)), sizes)[None].repeat(
        b, 0).astype(np.int32)


def _vecs(kind, b, sq, sk, arg):
    """numpy mask_vecs of one kind, built by the JAX package's helpers."""
    if kind == "pad":
        keep = np.arange(sk)[None] < np.asarray(arg)[:, None]
        vecs = JFM.padding_mask_to_intervals(jnp.asarray(keep), sq)
    elif kind in ("seg2", "seg4"):
        vecs = JFM.segment_intervals(jnp.asarray(_segments(b, sk, arg)),
                                     causal=kind == "seg2")
    else:
        vecs = JFM.sliding_window_intervals(sk, arg, batch=b)
    return np.array(vecs)


# (name, b, sq, sk, h, kvh, causal, vecs kind, its argument)
CASES = [
    ("pad_causal", 1, 256, 256, 1, 1, True, "pad", (150,)),
    ("pad_noncausal", 1, 256, 256, 1, 1, False, "pad", (200,)),
    ("seg_nvec2", 1, 256, 256, 1, 1, True, "seg2", (80, 100, 76)),
    ("seg_nvec4", 1, 256, 256, 1, 1, False, "seg4", (80, 100, 76)),
    ("window", 1, 256, 256, 1, 1, True, "window", 40),
    ("gqa", 1, 256, 256, 4, 2, True, "pad", (190,)),
    ("sq_lt_sk", 1, 128, 256, 1, 1, True, "pad", (230,)),
    # rows 0..95 see no key (bottom-right causal), batch 1 sees none
    ("dead_rows", 2, 256, 160, 1, 1, True, "pad", (160, 0)),
]


def check_masked_case(case):
    name, b, sq, sk, h, kvh, causal, kind, arg = case
    q, k, v, g = _inputs(sum(map(ord, name)), b, sq, sk, h, kvh)
    vecs = _vecs(kind, b, sq, sk, arg)
    j_out, j_grads = _jax_grads(
        lambda q, k, v: JFA._pallas_sdpa_masked(q, k, v, jnp.asarray(vecs),
                                                causal), (q, k, v), g)
    tvecs = torch.from_numpy(vecs)
    t_out, t_grads = _torch_grads(
        lambda q, k, v: TFA.sdpa(q, k, v, flashmask=tvecs,
                                 is_causal=causal), (q, k, v), g)
    np.testing.assert_allclose(t_out, j_out, atol=FWD_ATOL, rtol=0)
    for got, want, what in zip(t_grads, j_grads, "qkv"):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"d{what}")
    if name == "dead_rows":
        # fully masked rows: zero output and zero dq, in both packages
        dead = np.zeros((b, sq), bool)
        dead[0, :sq - sk] = True
        dead[1] = True
        assert np.all(t_out[dead] == 0) and np.all(j_out[dead] == 0)
        assert np.all(t_grads[0][dead] == 0)
        assert np.all(t_grads[1][1] == 0) and np.all(t_grads[2][1] == 0)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_masked_grads_match_jax_kernels(resident, case):
    check_masked_case(case)
