"""``paddle_tpu_torch.ops.math`` and ``ops.comparison`` against the
reference's ``ops/math.py`` and ``ops/comparison.py``: every op's
forward (values and dtypes) and, where the reference differentiates,
its gradient, on seeded numpy inputs; f32 tolerance rtol 1e-5 /
atol 1e-6 unless a spec states its own.  The op inventories of the two
modules must be equal."""
import numpy as np
import pytest

from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch.ops.registry import OPS as TOPS
from torch_op_parity import Spec, check, cpu_place, ops_of, reference, rng

_cpu = pytest.fixture(autouse=True)(cpu_place)

R = rng(0)


def f(*shape, lo=None, hi=None):
    if lo is not None:
        return R.uniform(lo, hi, shape).astype(np.float32)
    return R.standard_normal(shape).astype(np.float32)


def i64(lo, hi, *shape):
    return R.integers(lo, hi, shape).astype(np.int64)


X = f(3, 4)
Y = f(3, 4)
POS = f(3, 4, lo=0.5, hi=2.0)
UNIT = f(3, 4, lo=-0.9, hi=0.9)

UNARY = {
    "neg": X, "abs": X, "exp": X, "expm1": X, "log": POS, "log2": POS,
    "log10": POS, "log1p": POS, "sqrt": POS, "rsqrt": POS, "square": X,
    "sin": X, "cos": X, "tan": UNIT, "asin": UNIT, "acos": UNIT,
    "atan": X, "sinh": X, "cosh": X, "tanh": X, "asinh": X,
    "acosh": f(3, 4, lo=1.2, hi=3.0), "atanh": UNIT, "erf": X,
    "erfinv": UNIT, "floor": X, "ceil": X, "round": X, "trunc": X,
    "sign": X, "reciprocal": POS, "sigmoid": X, "digamma": POS,
    "lgamma": POS, "i0": X, "frac": X, "deg2rad": X, "rad2deg": X,
    "angle": X, "conj": X, "real": X, "imag": X,
}
LOOSE = {"digamma": (1e-4, 1e-5), "lgamma": (1e-4, 1e-5),
         "i0": (1e-4, 1e-5), "erfinv": (1e-4, 1e-5), "tan": (1e-4, 1e-5),
         "polygamma": (1e-4, 1e-4)}

SPECS = {name: Spec(x, diff=(0,), tol=LOOSE.get(name, (1e-5, 1e-6)))
         for name, x in UNARY.items()}
SPECS.update({
    "add": Spec(X, Y, diff=(0, 1)),
    "subtract": Spec(X, 2.5, diff=(0,)),
    "multiply": Spec(X, f(4), diff=(0, 1)),
    "divide": Spec(X, POS, diff=(0, 1)),
    "floor_divide": Spec(i64(-9, 9, 3, 4), i64(1, 4, 3, 4)),
    "remainder": Spec(X, POS, diff=(0,)),
    "pow": Spec(POS, 3.0, diff=(0,)),
    "matmul": Spec(f(2, 3, 4), f(2, 5, 4), diff=(0, 1), transpose_y=True,
                   tol=(1e-5, 1e-5)),
    "scale": Spec(X, scale=2.0, bias=0.5, diff=(0,)),
    "clip": Spec(X, min=-0.5, max=0.7, diff=(0,)),
    "maximum": Spec(X, Y, diff=(0, 1)),
    "minimum": Spec(X, Y, diff=(0, 1)),
    "fmax": Spec(X, Y, diff=(0, 1)),
    "fmin": Spec(X, Y, diff=(0, 1)),
    "atan2": Spec(X, Y, diff=(0, 1)),
    "hypot": Spec(X, Y, diff=(0, 1)),
    "lerp": Spec(X, Y, f(3, 4, lo=0, hi=1), diff=(0, 1, 2)),
    "stanh": Spec(X, diff=(0,)),
    "logit": Spec(f(3, 4, lo=0.1, hi=0.9), diff=(0,)),
    "multiplex": Spec([X, Y], i64(0, 2, 3, 1)),
    "isnan": Spec(np.array([1.0, np.nan, np.inf], np.float32)),
    "isinf": Spec(np.array([1.0, np.nan, -np.inf], np.float32)),
    "isfinite": Spec(np.array([1.0, np.nan, np.inf], np.float32)),
    "nan_to_num": Spec(np.array([1.0, np.nan, np.inf, -np.inf],
                                np.float32)),
    "cumsum": Spec(X, axis=1, diff=(0,)),
    "cumprod": Spec(X, dim=0, diff=(0,)),
    "cummax": Spec(X, axis=1, diff=(0,)),
    "cummin": Spec(X, axis=0, diff=(0,)),
    "logcumsumexp": Spec(X, axis=1, diff=(0,)),
    "addmm": Spec(f(3, 5), f(3, 4), f(4, 5), beta=0.5, alpha=2.0,
                  diff=(0, 1, 2)),
    "inner": Spec(X, Y, diff=(0, 1)),
    "outer": Spec(f(3), f(4), diff=(0, 1)),
    "heaviside": Spec(X, Y),
    "gcd": Spec(i64(1, 30, 5), i64(1, 30, 5)),
    "lcm": Spec(i64(1, 30, 5), i64(1, 30, 5)),
    "diff": Spec(X, axis=1, diff=(0,)),
    "trace": Spec(f(4, 4), offset=1, diff=(0,)),
    "kron": Spec(f(2, 3), f(3, 2), diff=(0, 1)),
    "cross": Spec(f(4, 3), f(4, 3), axis=1, diff=(0, 1)),
    "dot": Spec(X, Y, diff=(0, 1)),
    "polygamma": Spec(POS, 1, diff=(0,), tol=LOOSE["polygamma"]),
    # comparison
    "equal": Spec(i64(0, 3, 5), i64(0, 3, 5)),
    "not_equal": Spec(i64(0, 3, 5), 1),
    "greater_than": Spec(X, Y),
    "greater_equal": Spec(X, 0.0),
    "less_than": Spec(X, Y),
    "less_equal": Spec(X, Y),
    "equal_all": Spec(X, X.copy()),
    "allclose": Spec(X, X + 1e-7),
    "isclose": Spec(X, Y),
    "logical_and": Spec(X > 0, Y > 0),
    "logical_or": Spec(X > 0, Y > 0),
    "logical_xor": Spec(X > 0, Y > 0),
    "logical_not": Spec(X > 0),
    "is_empty": Spec(np.zeros((2, 0), np.float32)),
})

MODULES = {"math": "paddle_tpu.ops.math",
           "comparison": "paddle_tpu.ops.comparison"}


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


def test_promotion_follows_the_reference():
    """Python scalars take the tensor's dtype (an int tensor plus 2.5 adds
    2); a 0-d f32 tensor widens an n-d f16 one (torch's own rule keeps
    f16)."""
    import paddle_tpu as J
    import paddle_tpu_torch as T
    xi = np.array([1, 2, 3], np.int64)
    for mod in (J, T):
        out = mod.to_tensor(xi) + 2.5
        assert out.dtype.name == "int64"
        np.testing.assert_array_equal(out.numpy(), xi + 2)
    h = np.ones(3, np.float16)
    outs = [mod.to_tensor(h, dtype="float16")
            + mod.to_tensor(np.float32(1.5), dtype="float32")
            for mod in (J, T)]
    assert outs[0].dtype.name == outs[1].dtype.name == "float32"
    ints = [mod.divide(mod.to_tensor(xi), mod.to_tensor(xi + 1))
            for mod in (J, T)]
    assert ints[1].dtype.name == ints[0].dtype.name == "float32"
    np.testing.assert_allclose(ints[1].numpy(), ints[0].numpy(), rtol=1e-6)
