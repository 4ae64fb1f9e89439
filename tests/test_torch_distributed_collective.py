"""paddle_tpu_torch's collectives on 4 gloo ranks against the JAX
package's over a 4-device mesh axis of its CPU mesh.

Rank r holds row r of X (and rows 4r .. 4r+3 of Y and Z); the reference
holds the same arrays sharded over the axis, device r's shard being rank
r's values.  Each rank's result equals device r's shard of the
reference's result: the eager ``all_reduce`` (sum, max, min, prod, avg),
``all_gather`` and ``reduce_scatter``, and the traced ``all_to_all``,
``broadcast`` and ``scatter`` (the reference's eager forms of those are
the identity on one controller's replicated values).  ``send``/``recv``
(the reference has none) carry a ring.

The counters move as the reference's do: one ``collective_calls_total``
per call on every rank as on the reference, and
``collective_bytes_total`` summed over the ranks equal to the
reference's (it counts the whole sharded array, a rank its own part).
A group of one rank is the identity and counts nothing, as the
reference's collectives are without a mesh.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from paddle_tpu import observability as j_obs
from paddle_tpu.distributed import collective as JC
from paddle_tpu.distributed import mesh as JM

import torch_hybrid_ranks as R

RNG = np.random.default_rng(0)
X = RNG.standard_normal((4, 6)).astype(np.float32)
Y = RNG.standard_normal((16, 6)).astype(np.float32)
Z = RNG.standard_normal((16, 6)).astype(np.float32)
EAGER = ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
         "barrier")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = R.RankPool(4, tmp_path_factory.mktemp("gloo"))
    yield pool.run("collectives", X=X, Y=Y, Z=Z)
    pool.close()


@pytest.fixture(scope="module")
def reference():
    """The reference's results and counter growth on a 4-device axis
    "x" (the previous global mesh is put back afterwards)."""
    mesh = JM.ProcessMesh(Mesh(np.asarray(jax.devices()[:4]), ("x",)))
    prev = JM.get_mesh()
    JM.set_mesh(mesh)
    try:
        g = JC.new_group(axis_names=("x",))

        def sharded(a):
            return jax.device_put(a, NamedSharding(mesh.jax_mesh, P("x")))

        def count():
            return {op: (j_obs.metric_value("collective_calls_total",
                                            {"op": op}) or 0.0,
                         j_obs.metric_value("collective_bytes_total",
                                            {"op": op}) or 0.0)
                    for op in EAGER}
        before = count()
        out = {}
        for op in ("sum", "max", "min", "prod", "avg"):
            out[f"all_reduce_{op}"] = np.asarray(
                JC.all_reduce(sharded(X), op=op, group=g))
        out["all_gather"] = np.asarray(JC.all_gather(None, sharded(X),
                                                     group=g)._data)
        out["reduce_scatter"] = np.asarray(JC.reduce_scatter(
            None, sharded(Y), group=g)._data)
        JC.broadcast(sharded(X), src=0, group=g)
        JC.barrier(g)
        after = count()
        out["counters"] = {op: (after[op][0] - before[op][0],
                                after[op][1] - before[op][1])
                           for op in EAGER}

        def traced(fn, a):
            return np.asarray(jax.jit(jax.shard_map(
                fn, mesh=mesh.jax_mesh, in_specs=(P("x"),),
                out_specs=P("x"), check_vma=False))(sharded(a)))
        out["all_to_all"] = traced(lambda z: JC.all_to_all(None, z, group=g),
                                   Z)
        out["broadcast"] = traced(lambda x: JC.broadcast(x, src=0, group=g),
                                  X)
        out["scatter"] = traced(
            lambda x: JC.scatter(None, [jnp.asarray(X[i:i + 1])
                                        for i in range(4)], src=2,
                                 group=g), X)
        return out
    finally:
        JM.set_mesh(prev)


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod", "avg"])
def test_all_reduce(ranks, reference, op):
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"all_reduce_{op}"],
                                   reference[f"all_reduce_{op}"][r:r + 1],
                                   rtol=1e-6, atol=1e-7)


def test_gathers_and_scatters(ranks, reference):
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["all_gather"],
                                      reference["all_gather"])
        np.testing.assert_array_equal(out["all_gather_list"][:, 0], X)
        np.testing.assert_allclose(out["reduce_scatter"],
                                   reference["reduce_scatter"][r:r + 1],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out["reduce_scatter_axis1"],
                                   reference["reduce_scatter"][r:r + 1].T,
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(out["all_to_all"],
                                      reference["all_to_all"][4 * r:4 * r + 4])
        np.testing.assert_array_equal(out["broadcast"],
                                      reference["broadcast"][r:r + 1])
        np.testing.assert_array_equal(out["scatter"],
                                      reference["scatter"][r:r + 1])
        assert out["scatter"].tolist() == X[r:r + 1].tolist()
    np.testing.assert_allclose(ranks[1]["reduce"], X.sum(0, keepdims=True),
                               rtol=1e-6)


def test_point_to_point_objects_and_groups(ranks):
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["ring"], X[(r - 1) % 4][None])
        assert out["objects"] == [{"rank": i} for i in range(4)]
        assert out["group"] == ([0, 1, 2, 3], 4, r, 4)
        np.testing.assert_array_equal(out["identity"], X[r:r + 1])


def test_counters_move_as_the_reference(ranks, reference):
    for op in EAGER:
        calls, nbytes = reference["counters"][op]
        want_calls = 5 if op == "all_reduce" else 1
        assert calls == want_calls, op
        for out in ranks:
            assert out["counters"][op][0] == calls, op
        assert sum(out["counters"][op][1] for out in ranks) == nbytes, op
    for out in ranks:
        more = out["more_counters"]
        for op in ("all_gather", "reduce_scatter", "all_to_all", "scatter",
                   "reduce", "send", "recv", "all_gather_object"):
            assert more[op][0] == 1, op
        assert more["all_reduce"] == (0, 0)   # the identity group's


def test_the_world_on_one_process_is_the_identity():
    """Without an initialised world every collective of the default
    group is the identity, as the reference's are without a mesh."""
    import torch.distributed as dist
    from paddle_tpu_torch import distributed as D
    assert not dist.is_initialized()
    x = torch.arange(3.0)
    assert D.all_reduce(x) is x
    assert D.get_world_size() == 1 and D.get_rank() == 0
    assert D.get_world_size_group() == 1
    assert D.all_gather(None, x) is x
