"""The framework Tensor: a Paddle-shaped handle over a ``torch.Tensor``.

Ports ``paddle_tpu/framework/tensor.py``, whose handle is over a
``jax.Array``.  The handle does not subclass ``torch.Tensor``: Paddle's
method names clash with torch's (``shape`` is a list, ``size`` a
property, ``reshape`` takes a list, ``transpose`` a permutation).

Autograd is ``torch.autograd``: a tensor with ``stop_gradient=False``
holds a ``_data`` that requires grad, and op outputs carry torch's
graph.  The handle owns ``.grad``: backward accumulates into the torch
leaf's ``.grad``, which the handle moves into its own ``_grad`` before it
reads it and before anything rebinds ``_data`` (an optimizer step, a
dtype cast), so gradients always land on the handle, never on a
dropped leaf.

In-place APIs rebind the handle: they compute out of place and point
``_data`` at the result, as the reference does.  So a reshape or slice
is a value snapshot, not an alias: after ``b = a.reshape(...)``,
``a[0] = 7`` rebinds ``a`` and ``b`` keeps the old values (README
"Compatibility policy").  With ``FLAGS_strict_view_semantics`` such a
mutation raises instead, as in the reference.

Creation follows the reference's dtype rules (python ints -> int64,
floats and float64 numpy -> float32) and puts the tensor on the current
device (``device.set_device``; CUDA unless the CPU was asked for).
"""
from __future__ import annotations

import weakref as _weakref
from typing import Any

import numpy as np
import torch

from . import dtype as dtypes
from ..flags import FLAGS as _FLAGS

__all__ = ["Tensor", "to_tensor", "is_tensor"]


# ------------------------------------------------- strict view semantics
def _strict_views_on():
    return bool(_FLAGS.get("FLAGS_strict_view_semantics", False))


def _link_view(base, view):
    """Record the view relation so either side's in-place mutation can
    be flagged while the other is alive.  Views link to their ROOT base
    (chains like a.reshape(...)[1:3] stay linked to ``a``)."""
    if base is view:
        return view
    root = base
    if base._views is not None and base._views[0] is not None:
        rt = base._views[0]()
        if rt is not None:
            root = rt
    view._views = (_weakref.ref(root),
                   [] if view._views is None else view._views[1])
    if root._views is None:
        root._views = (None, [])
    root._views[1].append(_weakref.ref(view))
    view._views[1].append(_weakref.ref(root))
    return view


def _check_view_mutation(t):
    if t._views is None or not _strict_views_on():
        return
    if any(r() is not None for r in t._views[1]):
        raise RuntimeError(
            "FLAGS_strict_view_semantics: in-place mutation of a tensor "
            "with live views (or of a view whose base is alive). "
            "Reference Paddle aliases storage here; paddle_tpu_torch "
            "views are value snapshots (README 'Compatibility policy') — "
            "re-derive the view after mutating, or drop the strict flag "
            "to accept snapshot semantics.")


# ------------------------------------------------------------- creation
def _differentiable(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


def _numpy_to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.require(arr, requirements="C")
    if arr.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16 (a JAX bf16 array in numpy): same bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    if not arr.flags.writeable or any(st < 0 for st in arr.strides):
        # a size-1 dim may keep a negative stride in a "contiguous"
        # array, which torch.from_numpy refuses
        arr = arr.copy()
    return torch.from_numpy(arr)


def _default_array(data):
    """The reference's creation rule: python bool -> bool, int -> int64,
    float -> float32, float64 arrays and lists -> float32."""
    if isinstance(data, bool):
        return np.asarray(data, np.bool_)
    if isinstance(data, int):
        return np.asarray(data, np.int64)
    if isinstance(data, float):
        return np.asarray(data, np.float32)
    if isinstance(data, (list, tuple)) and any(
            isinstance(x, Tensor) for x in data):
        data = [x.numpy() if isinstance(x, Tensor) else x for x in data]
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return arr


def _as_torch(data, dtype=None, device=None) -> torch.Tensor:
    """``data`` (python scalar, list, numpy array, torch tensor) as a
    torch tensor of ``dtype`` on ``device``."""
    from ..device import to_torch_device
    if isinstance(data, torch.Tensor):
        t = data
    elif isinstance(data, np.ndarray) and dtype is not None:
        t = _numpy_to_torch(data)
    elif dtype is not None and isinstance(data, (bool, int, float,
                                                 complex)):
        t = torch.tensor(data)
    else:
        t = _numpy_to_torch(_default_array(data))
    if dtype is not None:
        t = t.to(dtypes.to_torch_dtype(dtype))
    dev = to_torch_device(device) if (
        device is not None or not isinstance(data, torch.Tensor)) else None
    if dev is not None and t.device != dev:
        t = t.to(dev)
    return t


class Tensor:
    """Eager tensor handle (paddle.Tensor API shape)."""

    __slots__ = ("_data", "_grad", "_sg", "name", "persistable",
                 "trainable", "_views", "__weakref__")

    _next_name_id = 0

    def __init__(self, data: Any, dtype=None, place=None, stop_gradient=True,
                 name=None):
        if isinstance(data, Tensor):
            data = data._data
        self._data = _as_torch(data, dtype, place)
        self._grad = None           # torch tensor or None
        self._views = None          # strict-view-mode link list
        self._sg = True             # stop_gradient of a non-float tensor
        self.stop_gradient = stop_gradient
        self.persistable = False
        self.trainable = not stop_gradient
        if name is None:
            name = f"generated_tensor_{Tensor._next_name_id}"
            Tensor._next_name_id += 1
        self.name = name

    # ------------------------------------------------------------- metadata
    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    dim = ndim

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def dtype(self) -> dtypes.DType:
        return dtypes.dtype(self._data.dtype)

    @property
    def place(self):
        return self._data.device

    @property
    def is_leaf(self):
        return self._data.grad_fn is None

    # ------------------------------------------------------------- autograd
    @property
    def stop_gradient(self):
        if _differentiable(self._data):
            return not self._data.requires_grad
        return self._sg

    @stop_gradient.setter
    def stop_gradient(self, value):
        value = bool(value)
        d = self._data
        if not _differentiable(d):
            self._sg = value
            return
        if value == (not d.requires_grad):
            return
        self._drain()
        # detach: never flip the flag on a torch tensor another handle
        # may share
        self._data = d.detach() if value else \
            d.detach().requires_grad_(True)

    def _drain(self):
        """Move the torch leaf's accumulated ``.grad`` onto the handle."""
        d = self._data
        if d.requires_grad and d.grad_fn is None and d.grad is not None:
            g = d.grad
            d.grad = None
            self._grad = g if self._grad is None else self._grad + g

    def _grad_data(self):
        """The accumulated gradient as a torch tensor (or None)."""
        self._drain()
        return self._grad

    @property
    def grad(self):
        g = self._grad_data()
        return None if g is None else Tensor(g)

    @grad.setter
    def grad(self, value):
        self._drain()
        if value is None:
            self._grad = None
        else:
            self._grad = value._data if isinstance(value, Tensor) else \
                torch.as_tensor(value, device=self._data.device)

    def clear_grad(self, set_to_zero=False):
        g = self._grad_data()
        self._grad = torch.zeros_like(g) if (set_to_zero and g is not None) \
            else None

    clear_gradient = clear_grad

    def _set_data(self, new: torch.Tensor):
        """Rebind ``_data`` to a new value of the same handle: the
        gradient stays on the handle and a differentiable leaf stays one
        (what the optimizer and dtype casts use)."""
        self._drain()
        want_grad = not self.stop_gradient and _differentiable(new)
        new = new.detach()
        self._data = new.requires_grad_(True) if want_grad else new

    def backward(self, grad_tensor=None, retain_graph=False):
        from ..autograd import tape
        tape.backward([self], [grad_tensor], retain_graph=retain_graph)

    def detach(self):
        t = Tensor(self._data.detach())
        t.name = self.name + ".detach"
        return t

    def detach_(self):
        self._drain()
        self._data = self._data.detach()
        self._sg = True
        return self

    def register_hook(self, hook):
        """``hook(grad) -> grad or None`` on this tensor's gradient."""
        def torch_hook(g):
            out = hook(Tensor(g))
            return out._data if isinstance(out, Tensor) else out

        return self._data.register_hook(torch_hook)

    # ----------------------------------------------------------- rebinding
    def _rebind_(self, other: "Tensor"):
        """In-place semantics: point this handle at another result."""
        _check_view_mutation(self)
        self._drain()
        sg = self.stop_gradient and other.stop_gradient
        new = other._data
        if not sg and _differentiable(new) and not new.requires_grad:
            new = new.detach().requires_grad_(True)
        self._data = new
        if not _differentiable(new):
            self._sg = sg
        return self

    def copy_(self, other, blocking=True):
        _check_view_mutation(self)
        other = other._data if isinstance(other, Tensor) else \
            _as_torch(other, device=self._data.device)
        self._set_data(other.to(self._data.device, self._data.dtype))
        return self

    def set_value(self, value):
        _check_view_mutation(self)
        value = value._data if isinstance(value, Tensor) else \
            _as_torch(value, device=self._data.device)
        self._set_data(torch.broadcast_to(
            value.to(self._data.device, self._data.dtype),
            self._data.shape).clone())
        return self

    # ------------------------------------------------------------ conversion
    def numpy(self):
        """The values as numpy (bfloat16, which numpy lacks, as float32)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._data.item()

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __bool__(self):
        return bool(self._data)

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __index__(self):
        return int(self.item())

    def __hash__(self):
        return id(self)

    # ------------------------------------------------------------- printing
    def __repr__(self):
        prefix = "Tensor(shape={}, dtype={}, place={}, stop_gradient={},\n" \
                 "       ".format(self.shape, self.dtype.name, self.place,
                                  self.stop_gradient)
        body = np.array2string(self.numpy(), separator=", ",
                               prefix="       ")
        return prefix + body + ")"

    __str__ = __repr__

    # ------------------------------------------------------ device movement
    def cpu(self):
        return Tensor(self._data.cpu(), stop_gradient=self.stop_gradient)

    def cuda(self, device_id=None, blocking=True):
        from ..device import to_torch_device
        dev = to_torch_device("gpu" if device_id is None
                              else f"gpu:{device_id}")
        return Tensor(self._data.to(dev), stop_gradient=self.stop_gradient)

    def to(self, *args, **kwargs):
        """to(dtype) / to(device) / to(device, dtype)."""
        from ..device import to_torch_device
        dt = kwargs.get("dtype")
        dev = kwargs.get("device")
        for a in args:
            if isinstance(a, dtypes.DType) or isinstance(a, torch.dtype):
                dt = a
            elif isinstance(a, str):
                try:
                    dt = dtypes.dtype(a)
                except TypeError:
                    dev = a
            else:
                dev = a
        out = self
        if dt is not None:
            out = out.astype(dt)
        if dev is not None:
            d = to_torch_device(dev)
            if d != out._data.device:
                out = Tensor(out._data.to(d),
                             stop_gradient=out.stop_gradient)
        return out

    def pin_memory(self):
        return self

    def contiguous(self):
        return self

    def is_contiguous(self):
        return True

    @property
    def T(self):
        from ..ops import manipulation
        return manipulation.transpose(self, list(range(self.ndim))[::-1])

    @property
    def mT(self):
        from ..ops import manipulation
        perm = list(range(self.ndim))
        perm[-2], perm[-1] = perm[-1], perm[-2]
        return manipulation.transpose(self, perm)


def is_tensor(x):
    return isinstance(x, Tensor)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor (on ``place``, default the current device)."""
    if isinstance(data, Tensor):
        if dtype is not None and dtypes.dtype(dtype) != data.dtype:
            data = data.astype(dtype)
        d = data._data if not stop_gradient else data._data.detach()
        return Tensor(d, place=place, stop_gradient=stop_gradient)
    return Tensor(data, dtype=dtype, place=place,
                  stop_gradient=stop_gradient)
