"""paddle_tpu_torch dense-cache decode attention (K7) against the JAX
package, on the CPU.

The port's ``decode_attention`` on CPU tensors runs its plain version
``_xla_decode``; it is held against the reference's Pallas kernel in
interpret mode (``DA._INTERPRET = True``, as
``tests/test_decode_attention.py`` runs it) and against the reference's
``_xla_decode``, in float32 at atol 2e-5 (the reference's own
tolerance: summation order over T and D), at head dims 64, 128 and 256
and groups of 1, 4 and 32; head_dim 32, which the reference routes to
``_xla_decode``, against that.  bf16 is held against the
reference's ``_xla_decode`` at one bf16 rounding of the output
(2^-8 relative, plus 2^-10 absolute for entries near zero): both round
the probabilities and the output to bf16, in a different order of
summation.  One ``_decode_layer`` is held to the reference's in
float32 at 1e-5 (output and the cache row it writes).  The CUDA
kernel itself is held to the plain version on the card
(``tests/test_torch_cuda_kernels.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import generation as JG
from paddle_tpu.models import llama as JL
from paddle_tpu.ops.pallas import decode_attention as JDA
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.ops.pallas import decode_attention as TDA

F32_ATOL = 2e-5
POS = [37, 201]


@pytest.fixture
def interpret():
    JDA._INTERPRET = True
    with jax.default_matmul_precision("highest"):
        yield
    JDA._INTERPRET = False


def _inputs(nh, kvh, d, seed=0, b=2, t=256):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, nh, d) * 0.4).astype(np.float32)
    k = (rng.randn(b, kvh, t, d) * 0.4).astype(np.float32)
    v = (rng.randn(b, kvh, t, d) * 0.4).astype(np.float32)
    return q, k, v, np.asarray(POS[:b], np.int32)


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("nh,kvh", [(4, 4), (8, 2), (32, 1)])
def test_plain_matches_jax_kernel_and_xla(interpret, nh, kvh, d):
    q, k, v, pos = _inputs(nh, kvh, d, seed=nh + d)
    got = TDA.decode_attention(*_torch(q, k, v, pos)).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v, pos)]
    kernel = np.asarray(JDA.decode_attention(*jargs))   # interpret mode
    xla = np.asarray(JDA._xla_decode(*jargs))
    np.testing.assert_allclose(got, kernel, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got, xla, atol=F32_ATOL, rtol=0)


def test_head_dim_32_takes_the_reference_xla_route(interpret):
    """d 32 is outside the reference's kernel dims: its decode_attention
    runs _xla_decode even in interpret mode, and so does the port's rule
    on the card (``_route``); the plain versions agree."""
    q, k, v, pos = _inputs(8, 2, 32, seed=32)
    jargs = [jnp.asarray(a) for a in (q, k, v, pos)]
    want = np.asarray(JDA.decode_attention(*jargs))
    np.testing.assert_array_equal(want, np.asarray(JDA._xla_decode(*jargs)))
    assert TDA._route(32) == "plain"
    got = TDA.decode_attention(*_torch(q, k, v, pos)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("nh,kvh", [(4, 4), (8, 2)])
def test_bf16_matches_jax_xla(nh, kvh):
    import ml_dtypes
    q, k, v, pos = _inputs(nh, kvh, 128, seed=7)
    bf = [a.astype(ml_dtypes.bfloat16) for a in (q, k, v)]
    want = np.asarray(JDA._xla_decode(*[jnp.asarray(a) for a in bf],
                                      jnp.asarray(pos))).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a.astype(np.float32)).bfloat16()
                  for a in (q, k, v))
    got = TDA.decode_attention(tq, tk, tv, torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                               atol=2 ** -10)


def test_cache_past_pos_is_never_read():
    q, k, v, pos = _inputs(8, 2, 128, seed=3)
    tq, tk, tv, tp = _torch(q, k, v, pos)
    out1 = TDA.decode_attention(tq, tk, tv, tp)
    for row, p in enumerate(POS):
        tk[row, :, p + 1:] = 99.0
        tv[row, :, p + 1:] = -99.0
    out2 = TDA.decode_attention(tq, tk, tv, tp)
    torch.testing.assert_close(out1, out2, atol=0, rtol=0)


def test_cpu_runs_the_plain_version_without_a_launch(monkeypatch):
    q, k, v, pos = _torch(*_inputs(4, 4, 128))
    before = TDA.decode_attention.launches
    for on in (True, False):
        monkeypatch.setattr(TDA, "PALLAS_DECODE", on)
        torch.testing.assert_close(TDA.decode_attention(q, k, v, pos),
                                   TDA._xla_decode(q, k, v, pos),
                                   atol=0, rtol=0)
    assert TDA.decode_attention.launches == before


@pytest.fixture(scope="module")
def weights():
    paddle.seed(0)
    cfg = JL.llama_tiny(num_hidden_layers=1)
    model = JL.LlamaForCausalLM(cfg)
    np_state = {k: np.asarray(v) for k, v in model.functional_state().items()}
    jstate = {k: jnp.asarray(v) for k, v in np_state.items()}
    tstate = TC.state_from_numpy(np_state, device="cpu")
    return cfg, TL.llama_tiny(num_hidden_layers=1), jstate, tstate


def test_decode_layer_matches_jax(weights):
    jcfg, tcfg, jstate, tstate = weights
    b, t = 3, 40
    kvh, hd = jcfg.num_key_value_heads, jcfg.head_dim
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, jcfg.hidden_size)).astype(np.float32)
    kc = rng.standard_normal((b, kvh, t, hd)).astype(np.float32)
    vc = rng.standard_normal((b, kvh, t, hd)).astype(np.float32)
    pos = np.array([0, 17, 39], np.int32)
    cos, sin = JL._rope_tables(t, hd, jcfg.rope_theta)
    cos1 = np.asarray(cos, np.float32)[pos]
    sin1 = np.asarray(sin, np.float32)[pos]
    jout, jk, jv = JG._decode_layer(
        JG._layer_weights(jstate, 0), jnp.asarray(x), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(cos1), jnp.asarray(sin1),
        jnp.asarray(pos), jcfg)
    tk, tv = _torch(kc, vc)
    tout = TG._decode_layer(TG._layer_weights(tstate, 0),
                            torch.from_numpy(x), tk, tv,
                            torch.from_numpy(cos1), torch.from_numpy(sin1),
                            torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)
    # the cache rows this token wrote, and nothing else
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    rows = np.arange(b)
    assert not np.allclose(tk.numpy()[rows, :, pos], kc[rows, :, pos])


@pytest.mark.parametrize("on", [True, False])
def test_cache_len_pads_like_the_reference(monkeypatch, on):
    monkeypatch.setattr(TDA, "PALLAS_DECODE", on)
    monkeypatch.setattr(JDA, "_INTERPRET", on)
    for prompt, new in ((7, 6), (128, 128), (2048, 64), (8064, 128)):
        assert TG._cache_len(prompt, new) == JG._cache_len(prompt, new)
