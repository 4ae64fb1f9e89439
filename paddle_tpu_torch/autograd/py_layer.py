"""PyLayer: user-defined autograd ops.

Ports ``paddle_tpu/autograd/py_layer.py`` (``:44``) as a
``torch.autograd.Function``: the user's ``forward(ctx, *args)`` runs on
Tensor handles without recording, and ``backward(ctx, *grads)`` returns
one gradient (or None) per Tensor input, as in the reference.
"""
from __future__ import annotations

import torch

__all__ = ["PyLayer", "PyLayerContext", "once_differentiable"]


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self._materialize_grads = True
        self._non_diff = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        return self._saved

    def mark_not_inplace(self, *args):
        pass

    def mark_non_differentiable(self, *args):
        self._non_diff = args

    def set_materialize_grads(self, value):
        self._materialize_grads = bool(value)


def _flatten(obj, is_leaf):
    """(leaves, rebuild) over nested lists/tuples/dicts."""
    leaves = []

    def walk(o):
        if is_leaf(o):
            leaves.append(o)
            return ("leaf",)
        if isinstance(o, (list, tuple)):
            return (type(o), [walk(x) for x in o])
        if isinstance(o, dict):
            return (dict, [(k, walk(v)) for k, v in o.items()])
        leaves.append(o)
        return ("leaf",)

    spec = walk(obj)

    def rebuild(vals):
        it = iter(vals)

        def build(s):
            if s[0] == "leaf":
                return next(it)
            if s[0] is dict:
                return {k: build(v) for k, v in s[1]}
            return s[0](build(x) for x in s[1])
        return build(spec)
    return leaves, rebuild


class _Bridge(torch.autograd.Function):
    """One PyLayer call: the tensor inputs' data go through torch's
    Function machinery; the user's forward and backward see handles."""

    @staticmethod
    def forward(ctx, layer, pctx, args, kwargs, positions, *datas):
        from ..framework.tensor import Tensor

        flat, rebuild = _flatten((args, kwargs),
                                 lambda x: isinstance(x, Tensor))
        flat = list(flat)
        for p, d in zip(positions, datas):
            flat[p] = Tensor(d, stop_gradient=flat[p].stop_gradient)
        a, k = rebuild(flat)
        outs = layer.forward(pctx, *a, **k)
        out_flat, out_rebuild = _flatten(outs,
                                         lambda x: isinstance(x, Tensor))
        ctx.layer, ctx.pctx = layer, pctx
        # the output structure, for PyLayer.apply to rebuild around the
        # Function's outputs (kept on the PyLayer context, which apply
        # holds whether or not a graph was recorded)
        pctx._out_rebuild = out_rebuild
        pctx._out_flat = [None if isinstance(x, Tensor) else x
                          for x in out_flat]
        ctx.n_in = len(datas)
        res = tuple(x._data for x in out_flat if isinstance(x, Tensor))
        non_diff = {id(t._data) for t in pctx._non_diff}
        ctx.mark_non_differentiable(*[r for r in res if id(r) in non_diff])
        ctx.set_materialize_grads(pctx._materialize_grads)
        return res

    @staticmethod
    def backward(ctx, *grads):
        from ..framework.tensor import Tensor

        cots = [None if g is None else Tensor(g) for g in grads]
        got = ctx.layer.backward(ctx.pctx, *cots)
        if not isinstance(got, (tuple, list)):
            got = (got,)
        got = list(got) + [None] * (ctx.n_in - len(got))
        return (None, None, None, None, None) + tuple(
            None if g is None else (g._data if isinstance(g, Tensor)
                                    else g) for g in got[:ctx.n_in])


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        from ..framework.tensor import Tensor

        flat, _ = _flatten((args, kwargs), lambda x: isinstance(x, Tensor))
        positions = [i for i, x in enumerate(flat) if isinstance(x, Tensor)]
        datas = [flat[i]._data for i in positions]
        pctx = PyLayerContext()
        res = _Bridge.apply(cls, pctx, args, kwargs, positions, *datas)
        vals, k = [], 0
        for x in pctx._out_flat:
            if x is None:
                vals.append(Tensor(res[k],
                                   stop_gradient=not res[k].requires_grad))
                k += 1
            else:
                vals.append(x)
        return pctx._out_rebuild(vals)


once_differentiable = staticmethod  # compat alias used by some paddle code
