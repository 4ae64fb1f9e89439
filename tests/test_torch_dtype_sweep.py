"""Bool, integer and float inputs through the public API of both
packages: the operator dunders (the bitwise ``& | ^ ~`` among them),
the elementwise math and the reductions, on bool, int32, int64,
float16, float32 and float64 tensors, with tensor and Python-scalar
operands.  Each case compares the result dtype's name and the values
(rtol 1e-3, atol 1e-3: float16 rounds; NaN equals NaN), or that both
packages raise.

Left out, as undefined in both packages: integer division by zero
(``YV`` has no zero, and a bool divisor of ``//`` or ``%`` is all
True) and integer power overflow (small operands).

The reference side of all cases is one ``jax.jit`` (op-by-op eager JAX
compiles a program per primitive and dtype: ~50 s for these cases);
the few cases whose ops read values on the host run eagerly."""
import operator

import jax
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from torch_op_parity import cpu_place

_cpu = pytest.fixture(autouse=True)(cpu_place)

DTYPES = ["bool", "int32", "int64", "float16", "float32", "float64"]
XV = np.array([[3, -2, 0, 5], [1, 4, -1, 2]])
YV = np.array([[2, 1, 3, 1], [2, 3, 1, 2]])
XB = np.array([[True, False, True, True], [False, True, False, True]])
YB = np.array([[True, True, False, True], [False, False, True, True]])
INT_DIV = ("floordiv", "mod")


def _arr(v, b, dt):
    return (b if dt == "bool" else v).astype(dt)


def _divisor(on, b):
    """A bool divisor of ``//`` and ``%`` holds no False (a zero)."""
    return np.ones_like(b) if on in INT_DIV else b


BINARY = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "truediv": operator.truediv, "floordiv": operator.floordiv,
    "mod": operator.mod, "pow": operator.pow, "and": operator.and_,
    "or": operator.or_, "xor": operator.xor, "eq": operator.eq,
    "ne": operator.ne, "lt": operator.lt, "le": operator.le,
    "gt": operator.gt, "ge": operator.ge,
    "maximum": lambda a, b: _mod(a).maximum(a, b),
    "minimum": lambda a, b: _mod(a).minimum(a, b),
}


def _mod(t):
    return J if isinstance(t, J.Tensor) else T


# right-hand operands: name -> builder(M, dt, op name)
RHS = {
    "same": lambda M, dt, on: M.to_tensor(_arr(YV, _divisor(on, YB), dt)),
    "int64": lambda M, dt, on: M.to_tensor(YV.astype("int64")),
    "float32": lambda M, dt, on: M.to_tensor(YV.astype("float32")),
    "bool": lambda M, dt, on: M.to_tensor(_divisor(on, YB)),
    "py_int": lambda M, dt, on: 2,
    "py_float": lambda M, dt, on: 2.5,
    "py_bool": lambda M, dt, on: True,
}

UNARY = {
    "abs": lambda M, x: M.abs(x), "neg": lambda M, x: -x,
    "invert": lambda M, x: ~x, "floor": lambda M, x: M.floor(x),
    "ceil": lambda M, x: M.ceil(x), "round": lambda M, x: M.round(x),
    "trunc": lambda M, x: M.trunc(x), "sign": lambda M, x: M.sign(x),
    "square": lambda M, x: M.square(x),
    "sqrt": lambda M, x: M.sqrt(M.abs(x)), "exp": lambda M, x: M.exp(x),
    "log": lambda M, x: M.log(M.abs(x) + 1),
    "log1p": lambda M, x: M.log1p(M.abs(x)),
    "rsqrt": lambda M, x: M.rsqrt(M.abs(x) + 1),
    "sin": lambda M, x: M.sin(x), "tanh": lambda M, x: M.tanh(x),
    "erf": lambda M, x: M.erf(x), "sigmoid": lambda M, x: M.sigmoid(x),
    "reciprocal": lambda M, x: M.reciprocal(x),
    "logit": lambda M, x: M.logit(x),
    "clip": lambda M, x: M.clip(x, 0, 2),
    "cumsum": lambda M, x: M.cumsum(x, axis=1),
    "cumsum_flat": lambda M, x: M.cumsum(x),
    "cumprod": lambda M, x: M.cumprod(x, dim=1),
    "diff": lambda M, x: M.diff(x),
    "sum": lambda M, x: M.sum(x), "sum_1": lambda M, x: M.sum(x, axis=1),
    "mean": lambda M, x: M.mean(x), "mean_1": lambda M, x: M.mean(x, axis=1),
    "nanmean": lambda M, x: M.nanmean(x), "nansum": lambda M, x: M.nansum(x),
    "prod": lambda M, x: M.prod(x), "max": lambda M, x: M.max(x),
    "min": lambda M, x: M.min(x), "amax": lambda M, x: M.amax(x, axis=0),
    "std": lambda M, x: M.std(x), "var": lambda M, x: M.var(x, axis=1),
    "logsumexp": lambda M, x: M.logsumexp(x),
    "argmax": lambda M, x: M.argmax(x, axis=1),
    "argmin": lambda M, x: M.argmin(x),
    "topk": lambda M, x: M.topk(x, 1, axis=1)[0],
    "sort": lambda M, x: M.sort(x, axis=1),
    "all": lambda M, x: M.all(x), "any": lambda M, x: M.any(x, axis=0),
    "count_nonzero": lambda M, x: M.count_nonzero(x),
    "isnan": lambda M, x: M.isnan(x), "isfinite": lambda M, x: M.isfinite(x),
    "zeros_like": lambda M, x: M.zeros_like(x),
    "full_like": lambda M, x: M.full_like(x, 2),
    "cast": lambda M, x: x.astype("float32"),
    "flip": lambda M, x: M.flip(x, [1]),
    "where": lambda M, x: M.where(x > 0, x, x),
}
# ops whose reference reads values on the host: run eagerly
HOST_READS = {"median": lambda M, x: M.median(x),
              "quantile": lambda M, x: M.quantile(x, 0.5),
              "kthvalue": lambda M, x: M.kthvalue(x, 2)[0],
              "mode": lambda M, x: M.mode(x)[0]}

FLOATS = ["float16", "float32", "float64"]
ZERO_DIV = {
    "floordiv_zero_tensor": lambda M, dt: M.to_tensor(
        np.array([1., -1., 0., 2.5], dt)) // M.to_tensor(np.zeros(4, dt)),
    "floordiv_zero_scalar": lambda M, dt: M.to_tensor(
        np.array([1., -1., 0., 2.5], dt)) // 0,
    "mod_zero": lambda M, dt: M.to_tensor(
        np.array([1., -1., 0., 2.5], dt)) % 0.0,
}


def _cases(dt):
    """name -> fn(M) for one dtype."""
    cases = {}
    for on, f in BINARY.items():
        for rn, r in RHS.items():
            cases[f"{on}/{rn}"] = (lambda M, f=f, r=r, on=on: f(
                M.to_tensor(_arr(XV, XB, dt)), r(M, dt, on)))
        if on in ("maximum", "minimum"):
            continue
        for sv in (3, 2.5, False):
            cases[f"r{on}/{sv!r}"] = (lambda M, f=f, sv=sv, on=on: f(
                sv, M.to_tensor(_arr(YV, _divisor(on, YB), dt))))
    for un, f in {**UNARY, **HOST_READS}.items():
        cases[un] = lambda M, f=f: f(M, M.to_tensor(_arr(XV, XB, dt)))
    if dt in FLOATS:
        for zn, f in ZERO_DIV.items():
            cases[zn] = lambda M, f=f: f(M, dt)
    return cases


CASES = {dt: _cases(dt) for dt in DTYPES}


def _unwrap(o):
    if isinstance(o, (list, tuple)):
        return [_unwrap(i) for i in o]
    return o._data if isinstance(o, J.Tensor) else o


def _raised(e):
    return ("raise", type(e).__name__)


def _run_ref(fn):
    try:
        return _unwrap(fn(J))
    except Exception as e:  # noqa: BLE001 - a raise is a result here
        return _raised(e)


_REF = {}


def _reference():
    """dtype -> case -> numpy result (or ``("raise", name)``)."""
    if _REF:
        return _REF
    names = [(dt, n) for dt in DTYPES for n in CASES[dt]
             if n not in HOST_READS]

    raised = {}

    def run_all():
        outs = []
        for i, (dt, n) in enumerate(names):
            out = _run_ref(CASES[dt][n])
            if isinstance(out, tuple):       # a raise: not a jit output
                raised[i], out = out, None
            outs.append(out)
        return outs

    traced = jax.jit(run_all)()
    for i, ((dt, n), out) in enumerate(zip(names, traced)):
        _REF.setdefault(dt, {})[n] = raised.get(i, out)
    for dt in DTYPES:
        for n in HOST_READS:
            _REF[dt][n] = _run_ref(CASES[dt][n])
    return _REF


def _same(ref, got, where):
    if isinstance(ref, tuple) or isinstance(got, tuple):
        assert isinstance(ref, tuple) and isinstance(got, tuple), \
            (where, "reference", ref, "port",
             got if isinstance(got, tuple) else got.dtype)
        return
    if isinstance(ref, list):
        assert isinstance(got, list) and len(ref) == len(got), where
        for i, (r, g) in enumerate(zip(ref, got)):
            _same(r, g, f"{where}[{i}]")
        return
    r = np.asarray(ref)
    g = got.numpy()
    assert r.dtype.name == g.dtype.name, (where, r.dtype, g.dtype)
    assert r.shape == g.shape, (where, r.shape, g.shape)
    np.testing.assert_allclose(g.astype(np.float64), r.astype(np.float64),
                               rtol=1e-3, atol=1e-3, equal_nan=True,
                               err_msg=where)


def _run_port(fn):
    try:
        out = fn(T)
    except Exception as e:  # noqa: BLE001 - a raise is a result here
        return _raised(e)
    return list(out) if isinstance(out, (list, tuple)) else out


@pytest.mark.parametrize("kind", ["binary", "unary"])
@pytest.mark.parametrize("dt", DTYPES)
def test_public_api_follows_the_reference_per_dtype(dt, kind):
    ref = _reference()[dt]
    bad = []
    for name, fn in CASES[dt].items():
        is_binary = "/" in name
        if is_binary != (kind == "binary"):
            continue
        try:
            _same(ref[name], _run_port(fn), f"{dt} {name}")
        except AssertionError as e:
            bad.append(str(e).strip().splitlines()[0][:200])
    assert not bad, "\n".join(bad)
