"""paddle_tpu_torch flash attention (K1/K2) and masked/biased flash
attention (K8) at head_dim 64 and 256 against the JAX package's Pallas
kernels.

The port's Hopper kernels are built for head dims 64, 128 and 256, the
ones the reference's ``sdpa`` sends to its kernels.  Here the same numpy
inputs (from a seed) go through the JAX ``_pallas_sdpa``,
``_pallas_sdpa_masked`` and ``_pallas_sdpa_biased`` (their custom_vjps,
the Pallas kernels in interpret mode: resident, or the streamed
long-sequence variants forced on with ``_FORCE_STREAM``) and through
the port's ``sdpa`` on CPU tensors (the plain versions of the K1/K2 and
K8 kernels, which the card tests hold the kernels to).  K1/K2 at head
dim 256 (head dim 64 is in ``test_torch_flash_attention*.py``) and K8
at 64 and 256, each at GQA groups 1 and 4: out and the gradients of
sum(out * g) for a random cotangent g, dbias included.  Tolerances are
the JAX package's own (``tests/test_flash_mask.py``): forward 3e-5
absolute, gradients 5e-4 absolute, float32 throughout.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu.ops.pallas import flash_mask as JFM
from paddle_tpu_torch.ops.pallas import flash_attention as TFA
from test_torch_flash_mask_grad import (FWD_ATOL, GRAD_ATOL, _jax_grads,
                                        _torch_grads, _vecs, interpret_mode)

S = 128


def _inputs(seed, b, s, h, kvh, d):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, s, h, d) * 0.3).astype(np.float32)
    k = (rng.randn(b, s, kvh, d) * 0.3).astype(np.float32)
    v = (rng.randn(b, s, kvh, d) * 0.3).astype(np.float32)
    g = rng.randn(b, s, h, d).astype(np.float32)
    return q, k, v, g


def _assert_close(t_out, j_out, t_grads, j_grads, names="qkv"):
    np.testing.assert_allclose(t_out, j_out, atol=FWD_ATOL, rtol=0)
    for got, want, what in zip(t_grads, j_grads, names):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"d{what}")


# (name, d, q heads, kv heads, causal, streamed)
FLASH_CASES = [("d256_g1", 256, 2, 2, True, False),
               ("d256_g4_stream", 256, 4, 1, True, True)]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in
                                                   FLASH_CASES])
def test_flash_head_dim_matches_jax(case):
    """K1 forward and the K2 dq and dk/dv (dk/dv summed per GQA group)."""
    name, d, h, kvh, causal, stream = case
    q, k, v, g = _inputs(sum(map(ord, name)), 1, S, h, kvh, d)
    saved = JFA._INTERPRET
    JFA._INTERPRET = True
    try:
        with interpret_mode(stream):
            j_out, j_grads = _jax_grads(
                lambda q, k, v: JFA._pallas_sdpa(q, k, v, causal),
                (q, k, v), g)
    finally:
        JFA._INTERPRET = saved
    t_out, t_grads = _torch_grads(
        lambda q, k, v: TFA.sdpa(q, k, v, is_causal=causal), (q, k, v), g)
    _assert_close(t_out, j_out, t_grads, j_grads)


# (name, d, q heads, kv heads, causal, vecs kind, its argument, streamed)
MASKED_CASES = [
    ("d64_g4_pad", 64, 4, 1, True, "pad", (S, 90), False),
    ("d256_g1_seg2_stream", 256, 2, 2, True, "seg2", (50, 40, 38), True),
]


@pytest.mark.parametrize("case", MASKED_CASES, ids=[c[0] for c in
                                                    MASKED_CASES])
def test_masked_head_dim_matches_jax(case):
    """The K8 forward, dq and dk/dv under flashmask intervals."""
    name, d, h, kvh, causal, kind, arg, stream = case
    b = len(arg) if kind == "pad" else 1
    q, k, v, g = _inputs(sum(map(ord, name)), b, S, h, kvh, d)
    vecs = _vecs(kind, b, S, S, arg)
    with interpret_mode(stream):
        j_out, j_grads = _jax_grads(
            lambda q, k, v: JFA._pallas_sdpa_masked(
                q, k, v, jnp.asarray(vecs), causal), (q, k, v), g)
    tvecs = torch.from_numpy(vecs)
    t_out, t_grads = _torch_grads(
        lambda q, k, v: TFA.sdpa(q, k, v, flashmask=tvecs, is_causal=causal),
        (q, k, v), g)
    _assert_close(t_out, j_out, t_grads, j_grads)


# (name, d, q heads, kv heads, bias batch, bias heads, causal, streamed):
# the bias per q head, or per kv head under GQA (repeated to the q heads,
# its gradient summed back through the repeat)
BIASED_CASES = [
    ("d64_g1", 64, 2, 2, 2, 2, True, False),
    ("d256_g4_kv_bias_stream", 256, 4, 1, 1, 1, False, True),
]


@pytest.mark.parametrize("case", BIASED_CASES, ids=[c[0] for c in
                                                    BIASED_CASES])
def test_biased_head_dim_matches_jax(case):
    """The K8 forward, dq, dk/dv and dbias under a dense bias."""
    name, d, h, kvh, bb, hb, causal, stream = case
    q, k, v, g = _inputs(sum(map(ord, name)), 2, S, h, kvh, d)
    bias = (np.random.RandomState(len(name)).randn(bb, hb, S, S)
            * 0.5).astype(np.float32)
    with interpret_mode(stream):
        j_out, j_grads = _jax_grads(
            lambda q, k, v, b: JFA._pallas_sdpa_biased(q, k, v, b, causal),
            (q, k, v, bias), g)
    t_out, t_grads = _torch_grads(
        lambda q, k, v, b: TFA.sdpa(q, k, v, attn_mask=b, is_causal=causal),
        (q, k, v, bias), g)
    assert t_grads[3].shape == bias.shape
    _assert_close(t_out, j_out, t_grads, j_grads, names=("q", "k", "v",
                                                         "bias"))
