"""``paddle_tpu_torch.ops.manipulation`` and ``ops.indexing`` against the
reference's modules: every op's forward (values and dtypes) and, where
the reference differentiates, its gradient, on seeded numpy inputs
(f32, rtol 1e-5 / atol 1e-6); the op inventories must be equal.  Also
the Tensor's indexing methods (``__getitem__``/``__setitem__``)."""
import numpy as np
import pytest

from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch.ops.registry import OPS as TOPS
from torch_op_parity import Spec, check, cpu_place, ops_of, reference, rng

_cpu = pytest.fixture(autouse=True)(cpu_place)

R = rng(1)


def f(*shape):
    return R.standard_normal(shape).astype(np.float32)


def i64(lo, hi, *shape):
    return R.integers(lo, hi, shape).astype(np.int64)


X = f(3, 4)
X3 = f(2, 3, 4)
SORTED = np.sort(f(6))

SPECS = {
    "reshape": Spec(X3, [0, -1], diff=(0,)),
    "transpose": Spec(X3, [2, 0, 1], diff=(0,)),
    "concat": Spec([X, f(2, 4)], axis=0),
    "stack": Spec([X, f(3, 4)], axis=1),
    "unstack": Spec(X3, axis=1, diff=(0,)),
    "split": Spec(f(6, 4), [2, -1], axis=0, diff=(0,)),
    "chunk": Spec(f(7, 2), 3, axis=0, diff=(0,)),
    "squeeze": Spec(f(3, 1, 4, 1), axis=[1, 3], diff=(0,)),
    "unsqueeze": Spec(X, [0, 2], diff=(0,)),
    "flatten": Spec(X3, 1, 2, diff=(0,)),
    "tile": Spec(X, [2, 1], diff=(0,)),
    "expand": Spec(f(1, 4), [3, -1], diff=(0,)),
    "expand_as": Spec(f(1, 4), X, diff=(0,)),
    "broadcast_to": Spec(f(3, 1), [3, 4], diff=(0,)),
    "broadcast_tensors": Spec([f(3, 1), f(1, 4)]),
    "gather": Spec(X, i64(0, 3, 5), axis=0, diff=(0,)),
    "gather_nd": Spec(X3, i64(0, 2, 4, 2), diff=(0,)),
    "scatter": Spec(f(5, 3), np.array([1, 3], np.int64), f(2, 3),
                    diff=(0, 2)),
    "scatter_nd_add": Spec(f(4, 3), i64(0, 4, 5, 1), f(5, 3), diff=(0, 2)),
    "scatter_nd": Spec(i64(0, 4, 5, 1), f(5, 3), [4, 3], diff=(1,)),
    "index_select": Spec(X, i64(0, 4, 6), axis=1, diff=(0,)),
    "index_sample": Spec(X, i64(0, 4, 3, 2), diff=(0,)),
    "index_add": Spec(X, np.array([0, 2], np.int64), 0, f(2, 4),
                      diff=(0, 3)),
    "index_put": Spec(X, (np.array([0, 2], np.int64),
                          np.array([1, 3], np.int64)), f(2), diff=(0, 2)),
    "take_along_axis": Spec(X, i64(0, 4, 3, 2), 1, diff=(0,)),
    "put_along_axis": Spec(X, np.array([[0], [3], [1]], np.int64), f(3, 1),
                           1, diff=(0, 2)),
    "flip": Spec(X3, [0, 2], diff=(0,)),
    "roll": Spec(X, 1, axis=1, diff=(0,)),
    "rot90": Spec(X, 1, diff=(0,)),
    "where": Spec(X > 0, X, f(3, 4), diff=(1, 2)),
    "nonzero": Spec(X > 0, eager=True),
    "masked_select": Spec(X, X > 0, eager=True),
    "masked_fill": Spec(X, X > 0, 0.5, diff=(0,)),
    "topk": Spec(X, 2, axis=1, diff=(0,)),
    "sort": Spec(X, axis=1, descending=True, diff=(0,)),
    "argsort": Spec(X, axis=0),
    "searchsorted": Spec(SORTED, f(5)),
    "bucketize": Spec(f(5), SORTED, right=True),
    "unique": Spec(i64(0, 4, 9), return_index=True, return_inverse=True,
                   return_counts=True, eager=True),
    "unique_consecutive": Spec(np.array([1, 1, 2, 2, 3, 1], np.int64),
                               return_inverse=True, return_counts=True,
                               eager=True),
    "tril": Spec(X, 1, diff=(0,)),
    "triu": Spec(X, -1, diff=(0,)),
    "tril_indices": Spec(4, 3, 1),
    "triu_indices": Spec(4, 3, -1),
    "diag": Spec(f(3), 1, diff=(0,)),
    "diagflat": Spec(f(2, 2), -1, diff=(0,)),
    "diagonal": Spec(X3, 1, 1, 2, diff=(0,)),
    "diag_embed": Spec(X, 1, diff=(0,)),
    "meshgrid": Spec(f(3), f(2)),
    "cast": Spec(X, "int32"),
    "pad": Spec(f(1, 2, 3, 3), [1, 2, 0, 1], mode="reflect", diff=(0,)),
    "repeat_interleave": Spec(X, 2, axis=0, diff=(0,)),
    "as_strided": Spec(X, [2, 3], [4, 1], 1, diff=(0,)),
    "moveaxis": Spec(X3, 0, 2, diff=(0,)),
    "swapaxes": Spec(X3, 0, 1, diff=(0,)),
    "atleast_1d": Spec(np.array(2.0, np.float32), diff=(0,)),
    "atleast_2d": Spec(f(3), diff=(0,)),
    "atleast_3d": Spec(X, diff=(0,)),
    "view": Spec(X, [2, 6], diff=(0,)),
    "unfold": Spec(f(2, 7), 1, 3, 2, diff=(0,)),
    "tensordot": Spec(X3, f(4, 3, 2), axes=[[1, 2], [1, 0]], diff=(0, 1),
                      tol=(1e-5, 1e-5)),
    "crop": Spec(X, [2, -1], [1, 1], diff=(0,)),
    "slice": Spec(X3, [0, 2], [1, 1], [2, 3], diff=(0,)),
    "strided_slice": Spec(X, [1], [0], [4], [2], diff=(0,)),
    "numel": Spec(X3),
    "shape": Spec(X3),
    "increment": Spec(X, 2.0, diff=(0,)),
    "assign": Spec(X, diff=(0,)),
    "bincount": Spec(i64(0, 5, 12), minlength=7, eager=True),
    "histogram": Spec(f(50), bins=7, eager=True),
    "getitem": Spec(X3, (1, slice(0, 2), np.array([0, 3])), diff=(0,)),
    "setitem": Spec(X, (slice(0, 2), 1), f(2), diff=(0, 2)),
}

MODULES = {"manipulation": "paddle_tpu.ops.manipulation",
           "indexing": "paddle_tpu.ops.indexing"}


@pytest.mark.parametrize("mod", sorted(MODULES))
def test_op_inventory_matches_reference(mod):
    ref = ops_of(JOPS, MODULES[mod])
    port = ops_of(TOPS, "paddle_tpu_torch.ops." + mod)
    assert port == ref
    assert set(ref) <= set(SPECS)


@pytest.fixture(scope="module")
def ref():
    return reference({n: JOPS[n].__op_body__ for n in SPECS}, SPECS)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_op_matches_reference(name, ref):
    check(ref[name], TOPS[name], SPECS[name], name)
