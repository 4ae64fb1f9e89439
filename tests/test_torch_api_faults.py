"""The bitwise operators and negative-step slices of the port's Tensor
against the reference's, through the public API of both packages.

- ``& | ^ ~`` are bitwise on int32 and int64 tensors and logical on bool
  ones, with a tensor or a Python int on the right; a float operand
  raises in both.
- ``x[::-1]``, ``x[:, ::-2]`` and ``x[:, ::-1] = t`` read and write as
  numpy's rules say, and their gradients (of sum(out * c)) agree.
Exact for the integer ops; f32 values and gradients within rtol 1e-6."""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from torch_op_parity import cpu_place, rng

_cpu = pytest.fixture(autouse=True)(cpu_place)

R = rng(21)
IV = R.integers(-9, 9, (3, 4))
IW = R.integers(-9, 9, (3, 4))
BV = R.random((3, 4)) > 0.5
BW = R.random((3, 4)) > 0.5
OPS = {"and": lambda a, b: a & b, "or": lambda a, b: a | b,
       "xor": lambda a, b: a ^ b}


def _same(a, b):
    assert a.dtype.name == b.dtype.name, (a.dtype, b.dtype)
    np.testing.assert_array_equal(b.numpy(), a.numpy())


@pytest.mark.parametrize("rhs", ["tensor", "py_int"])
@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("dt", ["int32", "int64", "bool"])
def test_bitwise_operators_follow_the_reference(dt, op, rhs):
    x, y = (BV, BW) if dt == "bool" else (IV.astype(dt), IW.astype(dt))
    outs = []
    for M in (J, T):
        right = M.to_tensor(y) if rhs == "tensor" else 6
        outs.append(OPS[op](M.to_tensor(x), right))
    _same(*outs)


@pytest.mark.parametrize("dt", ["int32", "int64", "bool"])
def test_invert_follows_the_reference(dt):
    x = BV if dt == "bool" else IV.astype(dt)
    _same(~J.to_tensor(x), ~T.to_tensor(x))
    _same(J.bitwise_not(J.to_tensor(x)), T.bitwise_not(T.to_tensor(x)))


@pytest.mark.parametrize("op", sorted(OPS) + ["invert"])
def test_bitwise_operators_raise_on_floats(op):
    for M in (J, T):
        x = M.to_tensor(IV.astype("float32"))
        with pytest.raises(TypeError):
            ~x if op == "invert" else OPS[op](x, x)


XF = R.standard_normal((2, 3, 4)).astype(np.float32)
TF = R.standard_normal((2, 3, 4)).astype(np.float32)
CF = R.standard_normal((2, 3, 4)).astype(np.float32)
READS = {"rows_reversed": np.s_[::-1], "cols_step_minus_2": np.s_[:, ::-2],
         "last_reversed": np.s_[..., ::-1],
         "mixed": np.s_[1, 2:0:-1, ::-3]}


@pytest.mark.parametrize("name", sorted(READS))
def test_negative_step_reads_and_their_grads(name):
    idx = READS[name]
    c = CF[idx]
    outs, grads = [], []
    for M in (J, T):
        x = M.to_tensor(XF, stop_gradient=False)
        y = x[idx]
        (y * M.to_tensor(c)).sum().backward()
        outs.append(y)
        grads.append(x.grad)
    _same(*outs)
    np.testing.assert_array_equal(outs[1].numpy(), XF[idx])
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(),
                               rtol=1e-6, atol=0)


WRITES = {"cols_reversed": np.s_[:, ::-1], "rows_step_minus_2": np.s_[::-2],
          "last_reversed": np.s_[..., 3:0:-2]}


@pytest.mark.parametrize("name", sorted(WRITES))
def test_negative_step_writes_and_their_grads(name):
    idx = WRITES[name]
    t = TF[idx]
    outs, grads = [], []
    for M in (J, T):
        a = M.to_tensor(XF, stop_gradient=False)
        v = M.to_tensor(t, stop_gradient=False)
        x = a * 1.0
        x[idx] = v
        (x * M.to_tensor(CF)).sum().backward()
        outs.append(x)
        grads.append((a.grad, v.grad))
    expect = XF.copy()
    expect[idx] = t
    np.testing.assert_array_equal(outs[1].numpy(), expect)
    _same(*outs)
    for r, g in zip(*grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-6, atol=0)
