"""paddle_tpu_torch's head-dim routes against the JAX package's, on the
CPU.

On a CUDA tensor each attention wrapper takes the route the reference
takes at that shape: its kernel where the reference runs a Pallas kernel,
the plain version where the reference runs XLA, and
``NotImplementedError`` naming the kernel where the reference runs a
kernel that the port has not built (K3 at head dims outside 32, 64, 128
and 256).  The rule is one function per
wrapper (``flash_attention._route`` for K1/K2 and K8,
``decode_attention._route`` for K7, ``paged_attention._route`` for K3);
these tests hold each against the reference's own choice, observed by
calling the reference's dispatcher with its kernel entries replaced by
recorders (the reference keeps its head-dim sets inline, not as
constants).  ``llama_tiny`` (head_dim 32) then runs through the port's
``generate`` and engine on the routes the card would take there (the
plain versions of K8 and K7; K3's kernel, whose CPU route is its plain
version), to the reference's tokens.  On the card the same routes are
shown by ``chip_smoke.py`` phase 3.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import generation as JG
from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu.ops.pallas import decode_attention as JDA
from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu.ops.pallas import paged_attention as JPA
from paddle_tpu.serving import create_engine as j_create_engine
from paddle_tpu.serving.request import GenerationConfig as JGen
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.ops.pallas import decode_attention as TDA
from paddle_tpu_torch.ops.pallas import flash_attention as TFA
from paddle_tpu_torch.ops.pallas import flash_mask as TFM
from paddle_tpu_torch.ops.pallas import paged_attention as TPA
from paddle_tpu_torch.serving import create_engine as t_create_engine
from paddle_tpu_torch.serving.request import GenerationConfig as TGen

HEAD_DIMS = (16, 32, 48, 64, 96, 128, 256)
DECODE_DIMS = (32, 64, 96, 128, 256)


def _reference_sdpa_kernel_dims(monkeypatch, route):
    """The head dims at which the reference's ``sdpa`` (as on its TPU)
    sends an unmasked call (``route`` "plain"), a flashmask call
    ("masked") or a float-bias call ("biased") to a Pallas kernel."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(JFA, "_probe_pallas", lambda: True)
    hits = []
    for name in ("_pallas_sdpa", "_pallas_sdpa_masked",
                 "_pallas_sdpa_biased"):
        monkeypatch.setattr(JFA, name, lambda q, *a: hits.append(
            q.shape[-1]) or jnp.zeros_like(q))
    seen = set()
    for d in HEAD_DIMS:
        q = jnp.zeros((1, 128, 2, d), jnp.float32)
        kw = {"plain": {},
              "masked": {"flashmask": jnp.full((1, 1, 2, 128), 128,
                                               jnp.int32)},
              "biased": {"attn_mask": jnp.zeros((1, 2, 128, 128))}}[route]
        del hits[:]
        JFA.sdpa(q, q, q, is_causal=True, **kw)
        if hits:
            seen.add(d)
    return seen


@pytest.mark.parametrize("route,kernel", [("plain", "K1/K2"),
                                          ("masked", "K8"),
                                          ("biased", "K8")])
def test_flash_rule_follows_the_reference(monkeypatch, route, kernel):
    """Every head dim at which the reference runs a Pallas kernel (64,
    128 and 256) takes the port's kernel (``kernel``: K1/K2 unmasked, K8
    masked or biased); every other one the plain version."""
    kernel_dims = _reference_sdpa_kernel_dims(monkeypatch, route)
    assert kernel_dims == {64, 128, 256}
    assert set(TFA.KERNEL_HEAD_DIMS) == kernel_dims, kernel
    for d in HEAD_DIMS:
        want = "kernel" if d in kernel_dims else "plain"
        assert TFA._route(d) == want, (kernel, d)


def _reference_decode_kernel_dims(monkeypatch, groups):
    monkeypatch.setattr(JDA, "_INTERPRET", True)
    hits = []
    monkeypatch.setattr(JDA, "_pallas_decode", lambda q, *a: hits.append(
        q.shape[-1]) or jnp.zeros_like(q))
    seen = set()
    for d in DECODE_DIMS:
        for nh, kvh in groups:
            del hits[:]
            JDA.decode_attention(jnp.zeros((1, nh, d)),
                                 jnp.zeros((1, kvh, 256, d)),
                                 jnp.zeros((1, kvh, 256, d)),
                                 jnp.zeros((1,), jnp.int32))
            if hits:
                seen.add((d, nh // kvh))
    return seen


def test_decode_rule_follows_the_reference(monkeypatch):
    groups = ((4, 4), (32, 1))
    kernel = _reference_decode_kernel_dims(monkeypatch, groups)
    assert {d for d, _ in kernel} == set(TDA.KERNEL_HEAD_DIMS)
    for d in DECODE_DIMS:
        for nh, kvh in groups:
            want = "kernel" if (d, nh // kvh) in kernel else "plain"
            assert TDA._route(d) == want
            if want == "kernel":   # the kernel's checks take any group
                z = torch.zeros(1, kvh, 256, d)
                assert TDA._check(torch.zeros(1, nh, d), z, z,
                                  torch.zeros(1, dtype=torch.int32))


def test_paged_rule_follows_the_reference(monkeypatch):
    """The reference runs its K3 kernel at every shape
    (``select_paged_attention``), and so does the port: the ``mma.sync``
    kernel at every head dim that is a multiple of 16 from 16 to 256, the
    CUDA-core body at every other head dim (8, 24, 72, 100, 272 here),
    at any group."""
    monkeypatch.setattr(JPA, "_INTERPRET", True)
    assert JPA.select_paged_attention() is JPA.paged_attention
    assert TPA.KERNEL_HEAD_DIMS == tuple(range(16, 257, 16))
    for d in HEAD_DIMS + (1, 7, 8, 24, 40, 72, 80, 100, 112, 240, 272, 320):
        for group in (1, 4, 16, 32):
            assert TPA._route(d, group) == "kernel"
            body = TPA._body(d)
            assert body == ("mma" if d % 16 == 0 and 16 <= d <= 256
                            else "any")
            if body == "any":
                tile, rows = TPA._any_plan(d, group)
                assert 1 <= rows <= min(16, group) and 1 <= tile <= 64
                assert TPA._any_smem(d, tile, rows) <= 227 * 1024
    with pytest.raises(ValueError, match="head_dim"):
        TPA._route(0, 1)
    # the widest head dims shrink the CUDA-core body's tile, then its rows
    assert TPA._any_plan(320, 32) == (64, 16)
    assert TPA._any_plan(4096, 32)[1] < 16
    with pytest.raises(ValueError, match="shared memory"):
        TPA._any_plan(20000, 1)
    # the bf16 kernel's shared memory fits a block at every instance,
    # and the padded rows keep 16-byte chunks
    for d in TPA.KERNEL_HEAD_DIMS:
        assert TPA._smem(d) <= 227 * 1024
        assert TPA._smem(d) % (16 * (16 + 6 * TPA._TILE)) == 0


@pytest.fixture(scope="module")
def tiny():
    paddle.seed(0)
    m = LlamaForCausalLM(llama_tiny())
    m.eval()
    np_state = {k: np.asarray(v) for k, v in m.functional_state().items()}
    return m, np_state


def test_llama_tiny_generate_takes_the_plain_routes(tiny, monkeypatch):
    """llama_tiny's head_dim 32 routes every attention of the dense
    ``generate`` to the plain versions (the K8 prefill and K7 decode
    rules), as the card would; the tokens are the reference's."""
    jm, np_state = tiny
    cfg = TL.llama_tiny()
    assert cfg.head_dim == 32
    assert TFA._route(cfg.head_dim) == "plain"
    assert TDA._route(cfg.head_dim) == "plain"
    calls = {"prefill": 0, "decode": 0}
    real_fwd, real_dec = TFM._masked_fwd_xla, TDA._xla_decode

    def prefill(*a):
        calls["prefill"] += 1
        return real_fwd(*a)

    def decode(*a):
        calls["decode"] += 1
        return real_dec(*a)

    monkeypatch.setattr(TFM, "_masked_fwd_xla", prefill)
    monkeypatch.setattr(TDA, "_xla_decode", decode)
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12))
    lengths = np.array([12, 7])
    want = np.asarray(JG.generate(jm, paddle.to_tensor(ids),
                                  max_new_tokens=6,
                                  lengths=paddle.to_tensor(lengths)).numpy())
    got = TG.generate(TC.state_from_numpy(np_state, device="cpu"), cfg, ids,
                      max_new_tokens=6, lengths=lengths, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert calls["prefill"] == cfg.num_hidden_layers and calls["decode"] > 0


def test_llama_tiny_engine_matches_the_reference(tiny):
    """The engine at head_dim 32: its prefill takes the plain K8 route,
    as on the card; its decode is K3, whose kernel the card runs at
    head_dim 32 (``chip_smoke.py`` phase 3 holds its tokens to the
    CPU's); the CPU engine holds them to the reference's here."""
    jm, np_state = tiny
    kw = dict(max_slots=2, page_size=8, max_model_len=64, preempt=False)
    je = j_create_engine(jm, **kw)
    te = t_create_engine(TL.llama_tiny(),
                         TC.state_from_numpy(np_state, device="cpu"),
                         device="cpu", **kw)
    prompts = [list(range(3, 14)), list(range(40, 47))]
    outs = []
    for engine, gen in ((je, JGen), (te, TGen)):
        reqs = [engine.submit(p, gen(max_new_tokens=5)) for p in prompts]
        while engine.scheduler.has_work():
            engine.step()
        outs.append([r.output_tokens for r in reqs])
    assert outs[0] == outs[1]
    cfg = TL.llama_tiny()
    assert TPA._route(cfg.head_dim, cfg.num_attention_heads
                      // cfg.num_key_value_heads) == "kernel"
