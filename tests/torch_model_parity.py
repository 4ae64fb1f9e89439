"""Shared harness of the Layer-model parity tests (NOT a test module).

A model is built in both packages; the reference's ``state_dict()``
(as numpy) is carried into the port's with
``models/convert.py:layer_state_from_numpy``, and both train on the same
seeded batch.  Closeness is the relative norm ‖port − ref‖ / ‖ref‖ of
each leaf.

The reference's steps run as ONE ``jax.jit`` of the unrolled steps
(``reference_steps``: the reference's own ``TrainStep`` recipe, which
also hands out each step's output and gradients): eager JAX compiles
each op of each shape, several times slower here.  While a
reference model is built, its initializers draw from numpy
(``reference_init``): an eager ``jax.random`` draw compiles for every
new shape (0.3-1.4 s each on a CPU), and the weights go to the port
anyway, so which random values they hold does not matter."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch.models import convert as TC


class _NumpyRandom:
    """The ``jax.random`` draws of ``paddle_tpu/nn/initializer.py``,
    from a seeded numpy generator."""

    def __init__(self, seed):
        self._rng = np.random.default_rng(seed)

    def uniform(self, key, shape, dtype=jnp.float32, minval=0.0,
                maxval=1.0):
        return jnp.asarray(self._rng.uniform(minval, maxval, shape), dtype)

    def normal(self, key, shape, dtype=jnp.float32):
        return jnp.asarray(self._rng.standard_normal(shape), dtype)

    def truncated_normal(self, key, lower, upper, shape, dtype=jnp.float32):
        return jnp.asarray(np.clip(self._rng.standard_normal(shape), lower,
                                   upper), dtype)


class _JaxWithNumpyRandom:
    def __init__(self, seed):
        self.random = _NumpyRandom(seed)

    def __getattr__(self, name):
        return getattr(jax, name)


@contextlib.contextmanager
def reference_init(seed=0):
    """Build reference models with initializers that draw from numpy."""
    from paddle_tpu.nn import initializer
    saved = initializer.jax
    initializer.jax = _JaxWithNumpyRandom(seed)
    try:
        yield
    finally:
        initializer.jax = saved


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def numpy_state(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


def carry(jm, tm):
    """The reference model's weights and buffers into the port's; the
    keys must be equal letter for letter."""
    assert list(tm.state_dict()) == list(jm.state_dict())
    TC.layer_state_from_numpy(tm, numpy_state(jm))


def step(M, model, opt, loss_fn, batch):
    """One eager step: (model output, loss, {name: grad})."""
    out, loss = loss_fn(M, model, *[M.to_tensor(b) for b in batch])
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()
             if p.grad is not None}
    opt.step()
    opt.clear_grad()
    return out.numpy(), float(loss), grads


def check_runs(jrun, trun, tol):
    """Per step: output, loss and every gradient within ``tol``.  A
    gradient that is zero in exact arithmetic (an attention key bias:
    softmax ignores a shift common to all keys) is rounding noise on
    both sides, so each leaf's error is measured against the larger of
    its own norm and 1e-4 of the step's whole gradient norm."""
    for k, ((jo, jl, jg), (to, tl, tg)) in enumerate(zip(jrun, trun)):
        assert rel(to, jo) <= tol, (k, "output", rel(to, jo))
        assert abs(tl - jl) <= tol * abs(jl), (k, "loss", tl, jl)
        assert sorted(tg) == sorted(jg), k
        whole = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                            for g in jg.values()))
        for n in jg:
            err = np.linalg.norm(np.asarray(tg[n], np.float64) - jg[n])
            scale = max(np.linalg.norm(np.asarray(jg[n], np.float64)),
                        1e-4 * whole)
            assert err <= tol * scale, (k, n, err / scale)


def check_state(jm, tm, tol, noise=None):
    """Every param and buffer (BatchNorm's running stats) within
    ``tol``.  ``noise`` maps a key suffix to an absolute bound for the
    leaves whose gradient is rounding noise (``check_runs``): Adam turns
    a noise gradient into steps of about lr in either direction, so
    those leaves can only be held within a few lr."""
    js = numpy_state(jm)
    for n, v in numpy_state(tm).items():
        bound = next((b for k, b in (noise or {}).items()
                      if n.endswith(k)), None)
        if bound is None:
            assert rel(v, js[n]) <= tol, (n, rel(v, js[n]))
        else:
            assert np.abs(v - js[n]).max() <= bound, (n, bound)


def reference_steps(jm, opt, loss_fn, batch, steps):
    """``steps`` eager-semantics steps of the reference model in one jit:
    the first step unrolled (it creates the optimizer's accumulators),
    the rest one ``lax.scan`` body, as the reference's ``multi_step``
    does.  Returns per step (output, loss, grads); the model and the
    optimizer hold the new state afterwards."""
    from paddle_tpu.autograd import tape
    from paddle_tpu.framework import random as jrandom
    from paddle_tpu.framework.tensor import Tensor as JTensor

    names = [n for n, _ in jm.named_parameters()]

    def one(state, opt_state, key, arrays):
        saved = jm.functional_state()
        jm.load_functional_state(state)
        opt.load_opt_state(opt_state)
        objs = dict(jm.named_parameters())
        try:
            with jrandom.trace_key_guard(key):
                inputs = [JTensor(a, stop_gradient=True) for a in arrays]
                with tape.enable_grad():
                    o, loss = loss_fn(J, jm, *inputs)
                    loss.backward()
                grads = {n: objs[n].grad._data for n in names
                         if objs[n].grad is not None}
                opt.step()
                opt.clear_grad()
                return ((o._data, loss._data, grads),
                        jm.functional_state(), opt.opt_state())
        finally:
            jm.load_functional_state(saved)

    def run(state, opt_state, key, *arrays):
        keys = jax.random.split(key, steps)
        first, state, opt_state = one(state, opt_state, keys[0], arrays)
        if steps == 1:
            return [first], state, opt_state

        def body(carry, k):
            out, st, os_ = one(*carry, k, arrays)
            return (st, os_), out

        (state, opt_state), rest = jax.lax.scan(body, (state, opt_state),
                                                keys[1:])
        outs = [first] + [jax.tree.map(lambda a, i=i: a[i], rest)
                          for i in range(steps - 1)]
        return outs, state, opt_state

    out, new_state, new_opt = jax.jit(run)(
        jm.functional_state(), opt.opt_state(), jrandom.split_key(),
        *[np.asarray(b) for b in batch])
    jm.load_functional_state(new_state)
    opt.load_opt_state(new_opt)
    return [(np.asarray(o), float(lo), {n: np.asarray(g)
                                        for n, g in gr.items()})
            for o, lo, gr in out]


def train_both(jm, tm, make_opt, loss_fn, batch, steps):
    jrun = reference_steps(jm, make_opt(J, jm), loss_fn, batch, steps)
    opt = make_opt(T, tm)
    return jrun, [step(T, tm, opt, loss_fn, batch) for _ in range(steps)]
