"""paddle_tpu_torch's expert-parallel ``moe_dispatch_combine`` on 8 gloo
ranks against the JAX package's on its 8-device CPU mesh
(``tests/test_moe_ring.py:80, :224``): a (dp 2, ep 4) mesh, x sharded
over dp and the experts over ep, and a 1-D ep mesh of 4 ranks (each
half of the world runs it) with x whole, in the "sort" and "dense"
modes, top_k 1 and 2, capacity_factor 1.25 and 0.35 (0.35 drops
entries past the global capacity: the reference counts capacity, fill
order and drops over the whole flattened batch, and so must the port).

Same seeded numpy inputs on both sides (64 tokens, hidden 16, FFN 32,
8 experts), the objective sum(y ** 2) + aux.  Compared in float32: y
and aux, and the gradients of x, gate_w, w1, b1, w2 and b2 (each rank's
part gathered into the reference's layout), 1e-4 relative + 1e-5
absolute (f32 sums in another order: per holder, per row and over the
gloo reductions; routing is identical, the seeded probabilities are far
from ties).  The grouped mode under an ep mesh raises, as in the
reference.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from paddle_tpu.distributed.moe import moe_dispatch_combine
from paddle_tpu_torch.distributed import moe as TMoE

import torch_hybrid_ranks as R

TOL = dict(rtol=1e-4, atol=1e-5)
CASES = [(mode, k, cf) for mode in ("sort", "dense") for k in (1, 2)
         for cf in (1.25, 0.35)]
MESHES = {"dp2_ep4": (2, 4), "ep4": ("ep", 4)}
NAMES = ("x", "gate_w", "w1", "b1", "w2", "b2")


def _args(s=64, m=16, f=32, e=8, seed=0):
    r = np.random.RandomState(seed)
    return [(r.randn(*shape) * sc).astype(np.float32)
            for shape, sc in (((s, m), 1.0), ((m, e), 0.5), ((e, m, f), 0.1),
                              ((e, f), 0.1), ((e, f, m), 0.1), ((e, m), 0.1))]


def _reference(args, dims):
    """y, aux and the grads of every case, from one jit on the mesh."""
    if dims[0] == "ep":
        mesh = Mesh(np.asarray(jax.devices()[:dims[1]]), ("ep",))
        x_spec = P(None, None)
    else:
        mesh = Mesh(np.asarray(jax.devices()).reshape(dims), ("dp", "ep"))
        x_spec = P("dp", None)

    def one(a, mode, k, cf):
        def obj(a):
            y, aux = moe_dispatch_combine(
                a[0], *a[1:], top_k=k, capacity_factor=cf, mesh=mesh,
                ep_axis="ep", train=False, dispatch_mode=mode)
            return jnp.sum(y ** 2) + aux, (y, aux)
        (_, (y, aux)), g = jax.value_and_grad(obj, has_aux=True)(a)
        return y, aux, g

    fn = jax.jit(lambda a: [one(a, *c) for c in CASES])
    specs = [x_spec, P(None, None), P("ep", None, None), P("ep", None),
             P("ep", None, None), P("ep", None)]
    placed = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, sp))
              for a, sp in zip(args, specs)]
    return [(np.asarray(y), float(aux), [np.asarray(t) for t in g])
            for y, aux, g in fn(placed)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pool = R.RankPool(8, tmp_path_factory.mktemp("gloo"))
    try:
        args = _args()
        out = {}
        for name, dims in MESHES.items():
            pool.submit("moe_ep", dims=dims, cases=CASES,
                        **dict(zip(NAMES, args)))
            ref = _reference(args, dims)
            out[name] = (pool.collect(), ref)
        yield args, out
    finally:
        pool.close()


def _gathered(results, i):
    """Case i's y and grads in the reference's layout: x's rows from the
    first ep rank of each dp row, the experts from dp row 0's ranks."""
    first = [r for r in results if r["j"] == 0]
    row0 = sorted((r for r in results if r["d"] == 0), key=lambda r: r["j"])
    if results[0]["dp"] == 1:          # a 1-D ep mesh: ranks 0-3 hold it
        first, row0 = results[:1], results[:results[0]["ep"]]
    first = sorted(first, key=lambda r: r["d"])
    y = np.concatenate([r["cases"][i]["y"] for r in first])
    g = [np.concatenate([r["cases"][i]["grads"][0] for r in first]),
         results[0]["cases"][i]["grads"][1]]
    g += [np.concatenate([r["cases"][i]["grads"][n] for r in row0])
          for n in range(2, 6)]
    return y, g


@pytest.mark.parametrize("case", CASES, ids=[f"{m}-k{k}-cf{cf}"
                                             for m, k, cf in CASES])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_matches_reference(runs, mesh, case):
    _, out = runs
    results, ref = out[mesh]
    i = CASES.index(case)
    y, grads = _gathered(results, i)
    ry, raux, rgrads = ref[i]
    np.testing.assert_allclose(y, ry, **TOL)
    for r in results:
        # every ep rank of a row holds the row's y whole; aux is global
        np.testing.assert_allclose(r["cases"][i]["aux"], raux, rtol=1e-5)
    for name, got, want in zip(NAMES, grads, rgrads):
        np.testing.assert_allclose(got, want, err_msg=f"d{name}", **TOL)


def test_low_capacity_drops_past_the_global_capacity(runs):
    """At capacity_factor 0.35 the global batch drops entries, and a
    capacity counted per holder would keep more of them."""
    args, _ = runs
    x, gate_w = (torch.from_numpy(a) for a in args[:2])
    for k in (1, 2):
        idx, gv, _ = TMoE._topk_choices(x @ gate_w, k, False, None)
        *_, pos, _ = TMoE._count_rank(idx, gv, 8, x.dtype)
        cap = TMoE._capacity(64, k, 0.35, 8, None)
        assert int((pos >= cap).sum()) >= 16
        holder_cap = TMoE._capacity(64 // 8, k, 0.35, 8, None)
        assert holder_cap * 8 > cap


def test_grouped_raises_under_an_ep_mesh(runs):
    _, out = runs
    for results, _ in out.values():
        for r in results:
            assert r["grouped"] and "single-device" in r["grouped"]
