"""``paddle_tpu_torch.ops.reduction`` and ``ops.creation`` against the
reference's modules: every op's forward (values and dtypes) and, where
the reference differentiates, its gradient, on seeded numpy inputs
(f32, rtol 1e-5 / atol 1e-6 unless stated); the op inventories must be
equal.  The random ops cannot reproduce JAX's streams: they are held to
the reference's output shape and dtype (traced, not run) and to the
distribution the reference draws from (sample mean and standard
deviation within 0.05 of its values over 20000 draws), and to
themselves under ``paddle.seed``."""
import jax
import numpy as np
import pytest

import paddle_tpu_torch as T
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch.ops.registry import OPS as TOPS
from torch_op_parity import Spec, check, cpu_place, ops_of, reference, rng

_cpu = pytest.fixture(autouse=True)(cpu_place)

R = rng(2)


def f(*shape):
    return R.standard_normal(shape).astype(np.float32)


X = f(3, 4)
X3 = f(2, 3, 4)
NAN = X.copy()
NAN[0, 1] = NAN[2, 3] = np.nan

SPECS = {
    "sum": Spec(X3, axis=[0, 2], keepdim=True, diff=(0,)),
    "mean": Spec(X3, axis=1, diff=(0,)),
    "max": Spec(X, axis=1, diff=(0,)),
    "min": Spec(X3, diff=(0,)),
    "amax": Spec(X, axis=0, keepdim=True, diff=(0,)),
    "amin": Spec(X, axis=1, diff=(0,)),
    "prod": Spec(X, axis=1, diff=(0,)),
    "all": Spec(X > -1, axis=0),
    "any": Spec(X > 1),
    "var": Spec(X3, axis=[1, 2], diff=(0,)),
    "std": Spec(X, axis=1, unbiased=False, diff=(0,)),
    "nansum": Spec(NAN, axis=1),
    "nanmean": Spec(NAN),
    "count_nonzero": Spec(np.array([[0, 1, 2], [0, 0, 3]], np.int64),
                          axis=1),
    "logsumexp": Spec(X3, axis=2, diff=(0,)),
    "argmax": Spec(X, axis=1, keepdim=True),
    "argmin": Spec(X3),
    "median": Spec(X, axis=1, diff=(0,)),
    "nanmedian": Spec(NAN, axis=1),
    "quantile": Spec(X, 0.3, axis=0, diff=(0,)),
    "kthvalue": Spec(X, 2, axis=1, diff=(0,)),
    "mode": Spec(np.array([[1, 2, 2, 3, 3], [4, 4, 1, 1, 0]], np.int64)),
    # creation
    "zeros": Spec([2, 3], "int32"),
    "ones": Spec([2, 3]),
    "full": Spec([2, 2], 1.5),
    "empty": Spec([3], "float32"),
    "zeros_like": Spec(X, "int64"),
    "ones_like": Spec(X),
    "full_like": Spec(X, 2.0),
    "empty_like": Spec(X),
    "arange": Spec(1, 10, 3),
    "linspace": Spec(0.0, 1.0, 5),
    "logspace": Spec(0.0, 2.0, 4),
    "eye": Spec(3, 4),
    "clone": Spec(X, diff=(0,)),
    "complex": Spec(f(3), f(3)),
    "polar": Spec(np.abs(f(3)), f(3), tol=(1e-5, 1e-5)),
}

RANDOM = {  # name -> (reference args, kwargs, expected (mean, std))
    "rand": (([20000],), {}, (0.5, (1 / 12) ** 0.5)),
    "randn": (([20000],), {}, (0.0, 1.0)),
    "uniform": (([20000],), {"min": -2.0, "max": 2.0}, (0.0, (16 / 12) ** 0.5)),
    "normal": ((1.0, 2.0, [20000]), {}, (1.0, 2.0)),
    "gaussian": (([20000],), {"mean": -1.0, "std": 0.5}, (-1.0, 0.5)),
    "randint": ((0, 10, [20000]), {}, (4.5, (99 / 12) ** 0.5)),
    "randperm": ((20000,), {}, (9999.5, 5773.5)),
    "standard_normal": (([20000],), {}, (0.0, 1.0)),
}
LIKE = {  # input-taking random ops: name -> (input, kwargs, (mean, std))
    "randint_like": (np.zeros(20000, np.int64), {"low": 0, "high": 4},
                     (1.5, (15 / 12) ** 0.5)),
    "multinomial": (np.array([0.2, 0.8], np.float32),
                    {"num_samples": 20000, "replacement": True},
                    (0.8, 0.4)),
    "bernoulli": (np.full(20000, 0.3, np.float32), {}, (0.3, 0.21 ** 0.5)),
    "poisson": (np.full(20000, 4.0, np.float32), {}, (4.0, 2.0)),
    "standard_gamma": (np.full(20000, 2.0, np.float32), {},
                       (2.0, 2.0 ** 0.5)),
    "exponential_": (np.zeros(20000, np.float32), {"lam": 2.0}, (0.5, 0.5)),
}

MODULES = {"reduction": "paddle_tpu.ops.reduction",
           "creation": "paddle_tpu.ops.creation"}


@pytest.mark.parametrize("mod", sorted(MODULES))
def test_op_inventory_matches_reference(mod):
    ref = ops_of(JOPS, MODULES[mod])
    port = ops_of(TOPS, "paddle_tpu_torch.ops." + mod)
    assert port == ref
    assert set(ref) <= set(SPECS) | set(RANDOM) | set(LIKE)


@pytest.fixture(scope="module")
def ref():
    return reference({n: JOPS[n].__op_body__ for n in SPECS}, SPECS)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_op_matches_reference(name, ref):
    check(ref[name], TOPS[name], SPECS[name], name)


@pytest.mark.parametrize("name", sorted(RANDOM) + sorted(LIKE))
def test_random_op_matches_reference_in_distribution(name):
    from paddle_tpu.framework.random import trace_key_guard
    if name in RANDOM:
        args, kw, (mu, sd) = RANDOM[name]
        targs = args
    else:
        x, kw, (mu, sd) = LIKE[name]
        args, targs = (x,), (T.to_tensor(x, dtype=str(x.dtype)),)
    arrays = [a for a in args if isinstance(a, np.ndarray)]
    with trace_key_guard(jax.random.key(0)):
        want = jax.eval_shape(
            lambda *a: JOPS[name].__op_body__(*(a or args), **kw), *arrays)
    out = TOPS[name](*targs, **kw)
    assert out.shape == list(want.shape) and \
        out.dtype.name == want.dtype.name, (name, out.shape, out.dtype)
    a = out.numpy().astype(np.float64)
    assert abs(a.mean() - mu) <= 0.05 * max(1.0, sd), (name, a.mean(), mu)
    assert abs(a.std() - sd) <= 0.05 * max(1.0, sd), (name, a.std(), sd)


def test_seed_reproduces_the_port_stream():
    T.seed(7)
    a = T.randn([5]).numpy()
    T.seed(7)
    np.testing.assert_array_equal(T.randn([5]).numpy(), a)
    state = T.get_rng_state()
    b = T.rand([3]).numpy()
    T.set_rng_state(state)
    np.testing.assert_array_equal(T.rand([3]).numpy(), b)
