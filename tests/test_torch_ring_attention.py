"""paddle_tpu_torch's ring and Ulysses attention (``ops/ring_attention``)
on 8 gloo ranks of a ``sep`` axis against the JAX package's on its
8-device CPU mesh (``tests/test_moe_ring.py:102-146``), from the same
seeded numpy q, k, v and output cotangent.

Ring attention, causal and not (B 2, S 64, 4 heads, d 16: a chunk of 8
positions a rank), and Ulysses, causal (8 heads): each rank's output
chunk and the gradients of sum(out * ct) w.r.t. its q, k and v chunks,
gathered, against the reference's output and ``jax.grad``.  Tolerances
are the reference's own tests': outputs 2e-5, gradients 5e-4 (absolute;
f32 sums in another order).  With one rank both are ``sdpa``; heads
that the sep degree does not divide (Ulysses) and GQA inputs (ring)
raise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from paddle_tpu.ops.ring_attention import (ring_attention,
                                           ulysses_attention)
from paddle_tpu_torch.ops.pallas.flash_attention import sdpa as t_sdpa
from paddle_tpu_torch.ops.ring_attention import (
    ring_attention as t_ring, ulysses_attention as t_ulysses)

import torch_hybrid_ranks as R

OUT_TOL = 2e-5
GRAD_TOL = 5e-4


def _inputs(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(4)]


def _reference(fn, q, k, v, ct, causal):
    mesh = Mesh(np.asarray(jax.devices()), ("sep",))
    spec = NamedSharding(mesh, P(None, "sep", None, None))

    def obj(q, k, v):
        out = fn(q, k, v, mesh, axis="sep", is_causal=causal)
        return jnp.sum(out * ct), out

    placed = [jax.device_put(jnp.asarray(a), spec) for a in (q, k, v)]
    (_, out), g = jax.jit(jax.value_and_grad(obj, argnums=(0, 1, 2),
                                             has_aux=True))(*placed)
    return [np.asarray(out)] + [np.asarray(t) for t in g]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pool = R.RankPool(8, tmp_path_factory.mktemp("gloo"))
    try:
        q, k, v, ct = _inputs(2, 64, 4, 16, 3)
        qu, ku, vu, ctu = _inputs(2, 64, 8, 16, 5)
        pool.submit("ring", q=q, k=k, v=v, ct=ct, qu=qu, ku=ku, vu=vu,
                    ctu=ctu)
        ref = {"ring_causal": _reference(ring_attention, q, k, v, ct, True),
               "ring_full": _reference(ring_attention, q, k, v, ct, False),
               "ulysses": _reference(ulysses_attention, qu, ku, vu, ctu,
                                     True)}
        yield pool.collect(), ref
    finally:
        pool.close()


@pytest.mark.parametrize("name", ["ring_causal", "ring_full", "ulysses"])
def test_matches_reference(runs, name):
    results, ref = runs
    # rank r holds the r-th sequence chunk of the output and the grads
    got = [np.concatenate([r[name][i] for r in results], axis=1)
           for i in range(4)]
    np.testing.assert_allclose(got[0], ref[name][0], atol=OUT_TOL)
    for what, g, w in zip(("dq", "dk", "dv"), got[1:], ref[name][1:]):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, err_msg=what)


def test_bad_shapes_raise(runs):
    results, _ = runs
    for r in results:
        assert "equal q and kv head counts" in r["errors"]["ring_gqa"]
        assert "divisible by the sep degree 8" in \
            r["errors"]["ulysses_heads"]


@pytest.mark.parametrize("causal", [True, False])
def test_one_rank_is_sdpa(causal):
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 16, 4, 8, 7))
    want = t_sdpa(q, k, v, is_causal=causal)
    for fn in (t_ring, t_ulysses):
        for mesh in (None, {"sep": 1}):
            torch.testing.assert_close(fn(q, k, v, mesh, is_causal=causal),
                                       want, rtol=0, atol=0)
