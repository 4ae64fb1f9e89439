"""The port's Tensor handle against the reference's: creation dtype
rules, the method surface and operator dunders, in-place APIs that
rebind, the snapshot-view rule (``tests/test_strict_views.py``'s cases)
and the default place (CUDA: it raises here).  Autograd:
``test_torch_autograd.py``.  Values in f32, rtol 1e-5 / atol 1e-6."""
import gc

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from torch_op_parity import cpu_place, rng, same

_cpu = pytest.fixture(autouse=True)(cpu_place)

R = rng(5)
XV = R.standard_normal((3, 4)).astype(np.float32)
YV = R.standard_normal((3, 4)).astype(np.float32)


def both(fn):
    """fn(module, x, y) on the reference and on the port."""
    outs = []
    for M in (J, T):
        x, y = M.to_tensor(XV), M.to_tensor(YV)
        outs.append(fn(M, x, y))
    return outs


@pytest.mark.parametrize("data", [3, 2.5, True, [1, 2], [1.0, 2.0],
                                  np.arange(3.0), np.arange(3, dtype=np.int32),
                                  [[True, False]]],
                         ids=lambda d: repr(d)[:20])
def test_creation_dtypes_follow_the_reference(data):
    a, b = J.to_tensor(data), T.to_tensor(data)
    same(a, b)
    assert J.to_tensor(data, dtype="float64").dtype.name == \
        T.to_tensor(data, dtype="float64").dtype.name


METHODS = {
    "shape_meta": lambda M, x, y: (x.shape, x.ndim, x.size, x.dtype.name),
    "T_mT": lambda M, x, y: [x.T, x.unsqueeze(0).mT],
    "dunders": lambda M, x, y: [x + y, x - 1.5, 2 - x, x * y, x / 2,
                                1 / (x.abs() + 1), x ** 2, 2 ** x, -x,
                                abs(x), x @ y.T, x // 1, x % 2],
    "compare": lambda M, x, y: [x > y, x >= 0, x < 0.5, x == x,
                                x != y, (x > 0) & (y > 0), (x > 0) | (y > 0),
                                ~(x > 0), (x > 0) ^ (y > 0)],
    "astype": lambda M, x, y: [x.astype("int32"), x.cast("float16"),
                               x.astype(M.bfloat16).astype("float32")],
    "split_chunk": lambda M, x, y: [*x.split(2, axis=1), *x.chunk(3)],
    "getitem": lambda M, x, y: [x[1], x[:, 1:3], x[x > 0], x[..., -1]],
    "item_tolist": lambda M, x, y: [float(x[0, 0]), x[1].tolist(),
                                    int(x.argmax())],
}


def test_method_surface_covers_the_reference():
    """Every Tensor method the reference binds to an op of the ported
    modules exists on the port's Tensor and calls the same-named op
    (the ops themselves are held to the reference in test_torch_ops_*)."""
    from paddle_tpu.framework import tensor_methods as JTM
    from paddle_tpu_torch.framework import tensor_methods as TTM
    ported = ("math", "reduction", "manipulation", "creation",
              "comparison", "indexing")
    want = {n for n, fn in JTM._METHODS.items() if fn is not None and
            fn.__op_body__.__module__.rsplit(".", 1)[-1] in ported}
    assert want <= set(TTM._METHODS)
    for n in want:
        assert TTM._METHODS[n].__op_name__ == JTM._METHODS[n].__op_name__
        assert callable(getattr(T.Tensor, n))
    inplace = {n for n in JTM._INPLACE if n in want}
    assert all(callable(getattr(T.Tensor, n + "_")) for n in inplace)


@pytest.mark.parametrize("name", sorted(METHODS))
def test_tensor_methods_match_reference(name):
    a, b = both(METHODS[name])
    same(a, b)


INPLACE = {
    "add_": lambda x, y: x.add_(y),
    "scale_": lambda x, y: x.scale_(2.0, 1.0),
    "clip_": lambda x, y: x.clip_(-0.5, 0.5),
    "exp_": lambda x, y: x.exp_(),
    "reshape_": lambda x, y: x.reshape_([2, 6]),
    "setitem": lambda x, y: x.__setitem__((0, slice(1, 3)), 7.0),
    "setitem_tensor": lambda x, y: x.__setitem__(x > 0, 0.0),
    "zero_": lambda x, y: x.zero_(),
    "fill_": lambda x, y: x.fill_(2.5),
    "masked_fill_": lambda x, y: x.masked_fill_(y > 0, -1.0),
}


@pytest.mark.parametrize("name", sorted(INPLACE))
def test_inplace_methods_rebind_like_reference(name):
    outs = []
    for M in (J, T):
        x, y = M.to_tensor(XV), M.to_tensor(YV)
        INPLACE[name](x, y)
        outs.append(x)
    same(*outs)


def test_inplace_on_leaf_keeps_the_graph():
    """An in-place op on a differentiable tensor records (the handle
    rebinds to the op's result), and gradients reach the leaf it read."""
    grads = []
    for M in (J, T):
        w = M.to_tensor(XV, stop_gradient=False)
        h = w * 1.0
        h.scale_(3.0)
        h.exp_()
        h.sum().backward()
        grads.append(w.grad)
    same(*grads)


# ------------------------------------------------- snapshot views (policy)
@pytest.fixture()
def strict():
    T.set_flags({"FLAGS_strict_view_semantics": True})
    yield
    T.set_flags({"FLAGS_strict_view_semantics": False})


def test_default_snapshot_semantics():
    a = T.zeros([2, 2])
    b = a.reshape([4])
    a[0] = 7.0
    assert float(b.numpy()[0]) == 0.0      # b keeps the old values
    c = a[1]
    a[1] = 3.0
    np.testing.assert_array_equal(c.numpy(), [0.0, 0.0])


def test_strict_base_mutation_raises(strict):
    a = T.zeros([2, 2])
    b = a.reshape([4])  # noqa: F841 — live view
    with pytest.raises(RuntimeError, match="strict_view_semantics"):
        a[0] = 7.0


def test_strict_view_mutation_raises(strict):
    a = T.zeros([4])
    c = a[1:3]
    with pytest.raises(RuntimeError, match="strict_view_semantics"):
        c.set_value(T.ones([2]))


def test_strict_allows_mutation_after_views_die(strict):
    a = T.zeros([2, 2])
    b = a.reshape([4])
    del b
    gc.collect()
    a[0] = 3.0
    np.testing.assert_allclose(a.numpy()[0], [3.0, 3.0])


def test_strict_transitive_chain_links_to_root(strict):
    a = T.zeros([2, 2])
    b = a.reshape([4])
    c = b[1:3]  # noqa: F841 — grandchild view
    del b
    gc.collect()
    with pytest.raises(RuntimeError, match="strict_view_semantics"):
        a[0] = 7.0


def test_strict_off_tracks_nothing():
    a = T.zeros([2, 2])
    b = a.reshape([4])
    assert a._views is None and b._views is None


def test_default_place_is_cuda():
    """With no device set the Paddle API puts tensors on CUDA: here, with
    no card, creation raises instead of falling back to the CPU."""
    from paddle_tpu_torch import device as D
    D._current = None
    assert T.get_device() == "gpu:0"
    if torch.cuda.is_available():
        assert T.to_tensor([1.0]).place.type == "cuda"
        return
    for make in (lambda: T.to_tensor([1.0]), lambda: T.zeros([2]),
                 lambda: T.nn.Linear(2, 2), lambda: T.randn([3])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.set_device("gpu")
    assert T.to_tensor([1.0], place="cpu").place.type == "cpu"
    assert T.to_tensor([1.0], place=T.CPUPlace()).place.type == "cpu"

