"""paddle_tpu_torch ``flashmask_attention`` against the JAX package's
``paddle_tpu.nn.functional.flashmask_attention``, and the K8 entry
points' helpers and routes.

The same numpy inputs (from a seed) and start/end row indices go through
both functions on the CPU: the JAX one runs its dense fallback (the
intervals as a -1e9 additive mask through the XLA path, rows with no
visible key zeroed), the port's the plain versions of the K8 kernels
through ``sdpa``.  Out is held to 3e-5 absolute and the gradients of
sum(out * g) — from ``jax.vjp`` of the reference op's body — to 5e-4,
float32 (the JAX package's own flashmask tolerances).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops.pallas import flash_mask as JFM
from paddle_tpu_torch.nn.functional_extra2 import flashmask_attention
from paddle_tpu_torch.ops.pallas import flash_mask as TFM

FWD_ATOL = 3e-5
GRAD_ATOL = 5e-4
B, S, H, D = 2, 128, 2, 32


def _qkvg(seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, S, H, D) * 0.5).astype(np.float32)
            for _ in range(4)]


def _startend(kind, heads=1):
    """[B, heads, S, k] int32 start/end row indices for two packed
    documents per batch row (lengths 50/78 and 90/38)."""
    ends = np.zeros((B, S), np.int32)
    starts = np.zeros((B, S), np.int32)
    for b, first in enumerate((50, 90)):
        ends[b, :first], ends[b, first:] = first, S
        starts[b, first:] = first
    lts = np.repeat(ends[:, None], heads, axis=1)
    ute = np.repeat(starts[:, None], heads, axis=1)
    lte = np.minimum(lts + 20, S)
    if heads > 1:                       # head 1 masks fewer rows
        lte[:, 1] = np.minimum(lts[:, 1] + 5, S)
        ute[:, 1] = np.maximum(ute[:, 1] - 8, 0)
    cols = {"c1": [lts], "c2": [lts, lte], "n2": [lts, ute],
            "n4": [lts, np.full_like(lts, S), np.zeros_like(lts), ute]}
    return np.stack(cols[kind], axis=-1).astype(np.int32)


# (name, start/end kind, heads of the indices, causal, window_size)
CASES = [
    ("causal_1", "c1", 1, True, None),
    ("causal_2_per_head", "c2", H, True, None),
    ("noncausal_2", "n2", 1, False, None),
    ("noncausal_4", "n4", H, False, None),
    ("window_1", "c1", 1, True, 20),
    ("window_2_tuple", "c2", 1, True, (16, 0)),
    ("no_indices", None, 1, True, None),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flashmask_attention_matches_jax(case):
    name, kind, heads, causal, window = case
    q, k, v, g = _qkvg(sum(map(ord, name)))
    idx = _startend(kind, heads) if kind else None
    kw = dict(causal=causal, window_size=window)
    j_out = JF.flashmask_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)),
        None if idx is None else paddle.to_tensor(idx), **kw).numpy()
    body = JF.flashmask_attention.__op_body__
    _, vjp = jax.vjp(lambda q, k, v: body(
        q, k, v, None if idx is None else jnp.asarray(idx), **kw),
        *(jnp.asarray(a) for a in (q, k, v)))
    j_grads = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    t_out = flashmask_attention(
        *leaves, None if idx is None else torch.from_numpy(idx), **kw)
    t_out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(t_out.detach().numpy(), j_out,
                               atol=FWD_ATOL, rtol=0)
    for leaf, want, what in zip(leaves, j_grads, "qkv"):
        np.testing.assert_allclose(leaf.grad.numpy(), want, atol=GRAD_ATOL,
                                   rtol=0, err_msg=f"d{what}")


@pytest.mark.parametrize("kw,exc", [
    (dict(causal=True, return_softmax_lse=True), NotImplementedError),
    (dict(causal=True, return_seed_offset=True), NotImplementedError),
    (dict(causal=False, window_size=8), NotImplementedError),
    (dict(causal=True, kind="n4"), ValueError),
    (dict(causal=False, kind="c1"), ValueError),
], ids=["lse", "seed_offset", "noncausal_window", "causal_4", "noncausal_1"])
def test_flashmask_attention_raises_like_jax(kw, exc):
    kw = dict(kw)
    idx = _startend(kw.pop("kind", "n2" if not kw["causal"] else "c1"))
    q, k, v, _ = _qkvg(0)
    with pytest.raises(exc):
        JF.flashmask_attention(*(paddle.to_tensor(a) for a in (q, k, v)),
                               paddle.to_tensor(idx), **kw)
    with pytest.raises(exc):
        flashmask_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            torch.from_numpy(idx), **kw)


def test_fully_masked_rows_follow_the_jax_kernel():
    """Rows whose every key is masked — here rows 42-49 of head 1, whose
    unmasked keys all lie right of the causal diagonal — give zeros in
    the port, as in the JAX Pallas kernel (interpret mode).  The JAX
    dense fallback that ``flashmask_attention`` takes on the CPU zeroes
    rows by the intervals alone, without the causal mask, and averages v
    there instead (a fault of the reference, recorded in ROADMAP.md):
    the port is held to the kernel."""
    from paddle_tpu.ops.pallas import flash_attention as JFA
    q, k, v, _ = _qkvg(1)
    idx = _startend("c1", H)
    idx[:, 1] = np.maximum(idx[:, 1] - 8, 0)
    t_out = flashmask_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                torch.from_numpy(idx), causal=True).numpy()
    saved, JFM._INTERPRET = JFM._INTERPRET, True
    try:
        vecs = np.concatenate([np.moveaxis(idx, -1, 2),
                               np.full((B, H, 1, S), S, np.int32)], axis=2)
        j_kernel = np.asarray(JFA._pallas_sdpa_masked(
            *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(vecs), True))
    finally:
        JFM._INTERPRET = saved
    np.testing.assert_allclose(t_out, j_kernel, atol=FWD_ATOL, rtol=0)
    assert np.all(t_out[0, 42:50, 1] == 0) and np.all(j_kernel[0, 42:50, 1]
                                                       == 0)
    j_fallback = JF.flashmask_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), paddle.to_tensor(idx),
        causal=True).numpy()
    assert np.abs(j_fallback[0, 42:50, 1]).max() > 0.01


def test_flashmask_attention_dropout_uses_the_generator():
    q, k, v, _ = _qkvg(3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    idx = torch.from_numpy(_startend("c1"))

    def run(seed):
        return flashmask_attention(tq, tk, tv, idx, causal=True, dropout=0.3,
                                   generator=torch.Generator().manual_seed(
                                       seed))

    plain = flashmask_attention(tq, tk, tv, idx, causal=True)
    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.allclose(run(1), run(2))
    assert not torch.allclose(run(1), plain)


def test_sliding_window_intervals_match_jax():
    for sk, window, batch in ((256, 40, 1), (100, 0, 3), (64, 200, 2)):
        np.testing.assert_array_equal(
            TFM.sliding_window_intervals(sk, window, batch,
                                         device="cpu").numpy(),
            np.asarray(JFM.sliding_window_intervals(sk, window, batch)))


def test_no_grad_forward_skips_the_function(monkeypatch):
    """A forward that takes no gradient runs the forward alone (on the
    card: no lse written), and under autograd the Function saves lse."""
    q, k, v, _ = _qkvg(9)
    keep = torch.arange(S)[None] < torch.tensor([[S], [40]])
    vecs = TFM.padding_mask_to_intervals(keep, S)
    need = []
    real = TFM._masked_fwd

    def spy(*args, need_lse):
        need.append(need_lse)
        return real(*args, need_lse=need_lse)

    monkeypatch.setattr(TFM, "_masked_fwd", spy)
    leaves = [torch.from_numpy(a) for a in (q, k, v)]

    def run():
        return TFM.flash_mha_masked(*(t.transpose(1, 2) for t in leaves),
                                    vecs, True, 0.125)

    plain = run()
    leaves[0].requires_grad_()
    with torch.no_grad():
        run()
    out = run()
    assert need == [False, False, True]
    assert out.requires_grad and not plain.requires_grad
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)
