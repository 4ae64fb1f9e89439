"""paddle_tpu_torch flash attention forward (K1 port) and the unmasked
sdpa route, against the JAX package.

The same numpy inputs (from a seed) go through the JAX K1 kernel in
Pallas interpret mode (``_flash_fwd`` on the padded, transposed inputs,
as ``_pallas_sdpa`` calls it) and through the port's ``_flash_fwd`` on
CPU tensors (the plain version, ``_flash_fwd_xla``).  Compared: out on
every row, lse on the real rows; rows with no visible key (sq > sk,
causal) must be zeros with ``lse == LSE_INVALID`` in both.  float32;
tolerance 1e-5 absolute and relative — the two differ only in
summation order and in the online vs one-pass softmax (measured gaps
<= 3e-7).  The gradients (K2) are in
``tests/test_torch_flash_attention_grad.py``; the CUDA kernels are held
against the same plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu_torch.ops.pallas import flash_attention as TFA

TOL = 1e-5

# (sq, sk, causal, kv heads) at H = 4, D = 64; and one D = 128 case
CASES = [(256, 256, True, 4, 64), (200, 200, False, 4, 64),
         (150, 300, True, 2, 64), (300, 150, True, 2, 64),
         (192, 160, True, 1, 128)]
IDS = [f"sq{c[0]}-sk{c[1]}-{'causal' if c[2] else 'full'}-hk{c[3]}-d{c[4]}"
       for c in CASES]


@pytest.fixture
def interpret():
    JFA._INTERPRET, saved = True, JFA._INTERPRET
    yield
    JFA._INTERPRET = saved


def qkv(seed, b, sq, sk, h, hk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    return q, k, v


def jax_flash_fwd(q, k, v, causal):
    """The JAX K1 kernel as ``_pallas_sdpa`` calls it: (out [B, Sq, H, D],
    lse [B, H, Sq]) on the real rows."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    sq_p, sk_p = JFA._pad_len(sq), JFA._pad_len(sk)
    qt, kt, vt = (jnp.swapaxes(JFA._pad_seq(jnp.asarray(x), n), 1, 2)
                  for x, n in ((q, sq_p), (k, sk_p), (v, sk_p)))
    out, lse = JFA._flash_fwd(qt, kt, vt, causal, 1.0 / np.sqrt(d),
                              *JFA._block_sizes(sq_p, sk_p), sq, sk)
    return (np.asarray(jnp.swapaxes(out, 1, 2)[:, :sq]),
            np.asarray(lse[:, :, :sq, 0]))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_and_lse_match_jax_kernel(interpret, case):
    sq, sk, causal, hk, d = case
    q, k, v = qkv(sq + sk, 1, sq, sk, 4, hk, d)
    j_out, j_lse = jax_flash_fwd(q, k, v, causal)
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v))
    before = TFA.flash_mha.fwd_launches
    t_out, t_lse = TFA._flash_fwd(tq, tk, tv, causal, 1.0 / math.sqrt(d))
    assert TFA.flash_mha.fwd_launches == before     # CPU: plain version
    t_out, t_lse = t_out.transpose(1, 2).numpy(), t_lse.numpy()
    np.testing.assert_allclose(t_out, j_out, atol=TOL, rtol=TOL)
    dead = j_lse == JFA.LSE_INVALID
    np.testing.assert_array_equal(t_lse == TFA.LSE_INVALID, dead)
    np.testing.assert_allclose(t_lse[~dead], j_lse[~dead], atol=TOL,
                               rtol=TOL)
    if sq > sk and causal:
        # the first sq - sk rows see no key: zeros in both
        assert dead[:, :, :sq - sk].all() and not dead[:, :, sq - sk:].any()
        np.testing.assert_array_equal(t_out[:, :sq - sk], 0.0)
        np.testing.assert_array_equal(j_out[:, :sq - sk], 0.0)


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_unmasked_route_matches_jax_sdpa(causal, monkeypatch):
    """The port's sdpa with no mask runs flash_mha (its plain version on
    the CPU); JAX's sdpa on the CPU runs ``_xla_sdpa``."""
    q, k, v = qkv(3, 2, 96, 96, 4, 2, 32)
    calls = []
    real = TFA._pallas_sdpa
    monkeypatch.setattr(TFA, "_pallas_sdpa",
                        lambda *a: calls.append("flash") or real(*a))
    out = TFA.sdpa(*(torch.from_numpy(x) for x in (q, k, v)),
                   is_causal=causal).numpy()
    assert calls == ["flash"]
    ref = np.asarray(JFA.sdpa(*(jnp.asarray(x) for x in (q, k, v)),
                              is_causal=causal))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_plain_versions_round_like_the_kernels_in_bf16(interpret):
    """bf16 inputs: the plain forward rounds the unnormalised p to bf16
    before P.V, as the Pallas kernel does (one bf16 rounding of the
    output apart: 2^-7 relative on O(1) values)."""
    q, k, v = qkv(5, 1, 128, 128, 2, 2, 64)
    bf = [np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (q, k, v)]
    j_out, _ = jax_flash_fwd(*bf, True)
    t = [torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
         .transpose(1, 2) for x in bf]
    t_out, _ = TFA._flash_fwd(*t, True, 0.125)
    assert t_out.dtype == torch.bfloat16
    np.testing.assert_allclose(t_out.transpose(1, 2).float().numpy(),
                               np.asarray(j_out, np.float32), atol=2 ** -7,
                               rtol=2 ** -7)


def test_dense_bias_route_still_raises():
    q, k, v = qkv(1, 1, 8, 8, 2, 2, 16)
    t = tuple(torch.from_numpy(x) for x in (q, k, v))
    with pytest.raises(NotImplementedError, match="K8"):
        TFA.sdpa(*t, attn_mask=torch.zeros(1, 1, 8, 8))
