"""Shared harness of the op parity tests (NOT a test module).

Each op runs on the same seeded numpy inputs in the JAX reference (its
registered body, on jnp arrays) and in the port (its public op, on
Tensor handles after ``set_device("cpu")``); the outputs (values and
dtypes) and, for the float inputs a spec names in ``diff``, the
gradients of sum(out * cotangent) are compared.  The reference side of
a whole module's specs is ONE ``jax.jit`` (forward and gradients of
every op; one compile instead of one per primitive), except the specs
marked ``eager`` (bodies that read values on the host, as ``unique``
does), which run op by op.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu_torch as P


class Spec:
    """args: numpy arrays / python values / lists of arrays; diff: the
    positions of args to differentiate; tol: (rtol, atol)."""

    def __init__(self, *args, diff=(), tol=(1e-5, 1e-6), grad_tol=None,
                 eager=False, **kwargs):
        self.args, self.kwargs, self.diff = args, kwargs, tuple(diff)
        self.tol = tol
        self.grad_tol = grad_tol or tol
        self.eager = eager


def rng(seed=0):
    return np.random.default_rng(seed)


def _flat(x):
    if isinstance(x, (list, tuple)):
        out = []
        for i in x:
            out.extend(_flat(i))
        return out
    return [x]


def _is_arrays(a):
    return isinstance(a, (list, tuple)) and a and isinstance(a[0], np.ndarray)


def _to_port(a, diff=False):
    if isinstance(a, np.ndarray):
        return P.to_tensor(a, dtype=str(a.dtype), stop_gradient=not diff)
    if _is_arrays(a):
        return type(a)(_to_port(x) for x in a)
    return a


def _leaves(spec):
    """The array arguments of a spec, flat (what the jitted reference
    takes as inputs)."""
    out = []
    for a in spec.args:
        if isinstance(a, np.ndarray):
            out.append(a)
        elif _is_arrays(a):
            out.extend(a)
    return out


def _rebuild(spec, vals):
    it = iter(vals)
    args = []
    for a in spec.args:
        if isinstance(a, np.ndarray):
            args.append(next(it))
        elif _is_arrays(a):
            args.append(type(a)(next(it) for _ in a))
        else:
            args.append(a)
    return args


def _np(x):
    if isinstance(x, P.Tensor):
        return x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _dtype_name(x):
    if isinstance(x, P.Tensor):
        return x.dtype.name
    return np.asarray(x).dtype.name


def _is_float(dt):
    return jnp.issubdtype(dt, jnp.floating)


def _run_one(body, spec, vals, cots):
    """(outs, grads) of one spec on jnp values ``vals`` (its array
    leaves)."""
    args = _rebuild(spec, vals)
    outs = _flat(body(*args, **spec.kwargs))
    if not spec.diff:
        return outs, []
    pos = [_leaf_index(spec, i) for i in spec.diff]

    def loss(*dvals):
        v = list(vals)
        for p, d in zip(pos, dvals):
            v[p] = d
        o = _flat(body(*_rebuild(spec, v), **spec.kwargs))
        return sum(jnp.sum(a.astype(jnp.float32) * c)
                   for a, c in zip(o, cots) if c is not None)

    grads = jax.grad(loss, argnums=tuple(range(len(pos))))(
        *[vals[p] for p in pos])
    return outs, list(grads)


def _leaf_index(spec, arg_pos):
    n = 0
    for i, a in enumerate(spec.args[:arg_pos]):
        if isinstance(a, np.ndarray):
            n += 1
        elif _is_arrays(a):
            n += len(a)
    return n


def reference(bodies: dict, specs: dict) -> dict:
    """name -> (outs, grads, cots) of the reference, as numpy.  A spec's
    name may carry a variant after ``#`` (``"conv2d#same"``); ``bodies``
    is keyed by the full name."""
    cots, jit_names, res = {}, [], {}
    for name, spec in specs.items():
        vals = [jnp.asarray(a) for a in _leaves(spec)]
        if spec.eager:
            outs = _flat(bodies[name](*_rebuild(spec, vals), **spec.kwargs))
            shapes = [(np.shape(o), np.asarray(o).dtype) for o in outs]
        else:
            shapes = [(o.shape, o.dtype) for o in _flat(jax.eval_shape(
                lambda *v, s=spec, b=bodies[name]: b(*_rebuild(s, v),
                                                     **s.kwargs), *vals))]
            jit_names.append(name)
        gen = rng(99)
        cots[name] = [gen.standard_normal(s).astype(np.float32)
                      if spec.diff and _is_float(dt) else None
                      for s, dt in shapes]
        if spec.eager:
            res[name] = _run_one(bodies[name], spec, vals, cots[name])

    def run_all(all_vals):
        return {n: _run_one(bodies[n], specs[n], all_vals[n], cots[n])
                for n in jit_names}

    if jit_names:
        res.update(jax.jit(run_all)(
            {n: [jnp.asarray(a) for a in _leaves(specs[n])]
             for n in jit_names}))
    return {n: ([np.asarray(o) for o in outs], [np.asarray(g) for g in gr],
                cots[n]) for n, (outs, gr) in res.items()}


def check(ref, port_fn, spec: Spec, name=""):
    """The port's op against the reference's result ``ref`` (from
    :func:`reference`): forward values and dtypes, then gradients."""
    ref_out, ref_grads, cots = ref
    port_args = [_to_port(a, i in spec.diff)
                 for i, a in enumerate(spec.args)]
    port_out = _flat(port_fn(*port_args, **spec.kwargs))
    assert len(ref_out) == len(port_out), (name, len(ref_out),
                                           len(port_out))
    rtol, atol = spec.tol
    for k, (r, t) in enumerate(zip(ref_out, port_out)):
        assert _dtype_name(t) == _dtype_name(r), \
            (name, k, _dtype_name(t), _dtype_name(r))
        np.testing.assert_allclose(_np(t), _np(r), rtol=rtol, atol=atol,
                                   err_msg=f"{name} output {k}")
    if not spec.diff:
        return
    terms = [(o._data.float() * torch.from_numpy(c)).sum()
             for o, c in zip(port_out, cots)
             if c is not None and not o.stop_gradient]
    leaves = [port_args[i]._data for i in spec.diff]
    got = torch.autograd.grad(sum(terms), leaves, allow_unused=True) \
        if terms else [None] * len(leaves)
    grtol, gatol = spec.grad_tol
    for i, g, r in zip(spec.diff, got, ref_grads):
        g = np.zeros(np.shape(r), np.float32) if g is None else _np(g)
        np.testing.assert_allclose(g, _np(r), rtol=grtol, atol=gatol,
                                   err_msg=f"{name} grad of arg {i}")


def cpu_place():
    """Generator body of a fixture: the CPU as the current device for the
    test, the previous device back after it."""
    from paddle_tpu_torch import device as D
    prev = D._current
    P.set_device("cpu")
    try:
        yield
    finally:
        D._current = prev


def ops_of(registry_ops, module_name):
    """The names of the registered ops whose body lives in the module."""
    return sorted(n for n, f in registry_ops.items()
                  if f.__op_body__.__module__ == module_name)


def same(a, b, rtol=1e-5, atol=1e-6):
    """Handles (or nested lists of them, or plain values) of the
    reference and the port: equal dtypes and shapes, close values."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for i, j in zip(a, b):
            same(i, j, rtol, atol)
        return
    if hasattr(a, "numpy") and hasattr(a, "dtype"):
        assert a.dtype.name == b.dtype.name, (a.dtype, b.dtype)
        assert a.shape == b.shape
        np.testing.assert_allclose(np.asarray(b.numpy(), np.float64),
                                   np.asarray(a.numpy(), np.float64),
                                   rtol=rtol, atol=atol)
    else:
        assert a == b, (a, b)
