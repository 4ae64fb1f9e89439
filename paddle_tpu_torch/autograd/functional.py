"""Functional higher-order autodiff and saved-tensor hooks.

Ports ``paddle_tpu/autograd/functional.py``: ``jacobian`` (of a callable,
or of a recorded tensor with respect to its inputs), ``hessian`` of a
scalar callable — here through ``torch.func.jacrev``/``hessian`` (and
``vmap`` for ``batch_axis=0``) — and ``saved_tensors_hooks``, which is
``torch.autograd.graph.saved_tensors_hooks`` with the hooks seeing
Tensor handles.
"""
from __future__ import annotations

import torch

from ..framework.tensor import Tensor

__all__ = ["jacobian", "hessian", "saved_tensors_hooks"]


def _unwrap(x):
    return x._data if isinstance(x, Tensor) else torch.as_tensor(x)


def _wrapped(func, reduce_sum=False):
    from ..ops.registry import wrap

    def wrapped(*arrs):
        # wrap, not Tensor(): the functorch tensors must keep tracking
        args = [wrap(a) for a in arrs]
        out = _unwrap(func(*args))
        return out.sum() if reduce_sum else out
    return wrapped


def jacobian(ys, xs, batch_axis=None):
    """d(ys)/d(xs): ``ys`` a callable of ``xs``, or a recorded Tensor
    (one backward sweep per output element, bounded to 512)."""
    xs_list = list(xs) if isinstance(xs, (list, tuple)) else [xs]
    if not callable(ys):
        from . import tape
        y = ys
        if not isinstance(y, Tensor) or y.stop_gradient:
            raise TypeError(
                "jacobian(ys, xs): ys must be a callable or a RECORDED "
                "Tensor (created under autograd from xs)")
        if y.size > 512:
            raise ValueError(
                f"jacobian over a recorded tensor runs one backward "
                f"sweep per output element; y.size={y.size} is too large "
                "— use the callable form")
        yf = y._data.reshape(-1)
        rows = []
        for i in range(int(y.size)):
            gs = tape.grad([Tensor(yf[i], stop_gradient=False)], xs_list,
                           retain_graph=True)
            rows.append([g._data.reshape(-1) for g in gs])
        jacs = [Tensor(torch.stack([r[j] for r in rows]).reshape(
            tuple(y.shape) + tuple(xs_list[j].shape)))
            for j in range(len(xs_list))]
        return jacs if isinstance(xs, (list, tuple)) else jacs[0]
    arrays = [_unwrap(x).detach() for x in xs_list]
    fn = torch.func.jacrev(_wrapped(ys), argnums=tuple(range(len(arrays))))
    if batch_axis is not None:
        if batch_axis != 0:
            raise ValueError("batch_axis must be 0 or None")
        fn = torch.func.vmap(fn)
    jac = fn(*arrays)
    if isinstance(xs, (list, tuple)):
        return [Tensor(j) for j in jac]
    return Tensor(jac[0])


def hessian(func, xs, batch_axis=None):
    """d2(func)/d(xs)2 for a scalar-output callable."""
    if not callable(func):
        raise TypeError("hessian needs a callable (see jacobian)")
    xs_list = list(xs) if isinstance(xs, (list, tuple)) else [xs]
    arrays = [_unwrap(x).detach() for x in xs_list]
    fn = torch.func.hessian(_wrapped(func, reduce_sum=True),
                            argnums=tuple(range(len(arrays))))
    if batch_axis is not None:
        if batch_axis != 0:
            raise ValueError("batch_axis must be 0 or None")
        fn = torch.func.vmap(fn)
    h = fn(*arrays)
    if isinstance(xs, (list, tuple)):
        return [[Tensor(h[i][j]) for j in range(len(arrays))]
                for i in range(len(arrays))]
    return Tensor(h[0][0])


class saved_tensors_hooks:
    """Context manager transforming tensors saved for backward (reference
    ``autograd/saved_tensors_hooks.py``): ``pack_hook(tensor)`` runs when
    an op saves a tensor for its backward, ``unpack_hook(packed)`` when
    the backward reads it back; both see Tensor handles."""

    def __init__(self, pack_hook, unpack_hook):
        self.pack_hook = pack_hook
        self.unpack_hook = unpack_hook

    def _pack(self, t):
        return self.pack_hook(Tensor(t))

    def _unpack(self, packed):
        out = self.unpack_hook(packed)
        return out._data if isinstance(out, Tensor) else out

    def __enter__(self):
        self._ctx = torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                             self._unpack)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)
