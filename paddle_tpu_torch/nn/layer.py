"""nn.Layer base class.

Ports ``paddle_tpu/nn/layer.py`` (reference: python/paddle/nn/layer/
layers.py): parameter / sublayer / buffer registries, hooks,
state_dict, train/eval, dtype casts, and the functional bridge
``functional_state`` / ``load_functional_state`` (``:440-460``), a flat
``{name: torch.Tensor}`` of parameters and buffers — the state the
serving engine and ``generate`` read.  The reference's eager segment
tracing (one jitted dispatch per composite forward) amortises JAX
tracing and has no counterpart here.
"""
from __future__ import annotations

import collections
from typing import Iterator

from ..framework.tensor import Tensor
from ..framework import dtype as dtypes

__all__ = ["Layer", "Parameter", "ParamAttr"]


class Parameter(Tensor):
    """Trainable tensor (reference: python/paddle/base/framework.py Parameter)."""

    def __init__(self, data, dtype=None, stop_gradient=False, name=None):
        super().__init__(data, dtype=dtype, stop_gradient=stop_gradient,
                         name=name)
        self.persistable = True
        self.trainable = not stop_gradient
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


class ParamAttr:
    """Reference: python/paddle/base/param_attr.py."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if arg is False:
            return False
        # an Initializer instance
        return ParamAttr(initializer=arg)


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self.training = True
        self._dtype = dtypes.dtype(dtype).name if dtype else "float32"
        self._parameters: dict[str, Parameter] = collections.OrderedDict()
        self._sub_layers: dict[str, "Layer"] = collections.OrderedDict()
        self._buffers: dict[str, Tensor] = collections.OrderedDict()
        self._non_persistable_buffer_names = set()
        self._forward_pre_hooks = collections.OrderedDict()
        self._forward_post_hooks = collections.OrderedDict()
        self._casted_by_pure_fp16 = False
        self._name_scope = name_scope or type(self).__name__.lower()

    # ------------------------------------------------------------ creation
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        from .initializer import Constant, XavierUniform
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = dtype or self._dtype
        from . import initializer as _init_mod
        glob = _init_mod._global_initializer
        glob_init = None
        if glob is not None:
            glob_init = glob[1] if is_bias else glob[0]
        init = attr.initializer or default_initializer or glob_init or \
            (Constant(0.0) if is_bias else XavierUniform())
        data = init(shape, dtype)
        p = Parameter(data, stop_gradient=not attr.trainable, name=attr.name)
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name, parameter):
        if parameter is None:
            self._parameters[name] = None
        else:
            self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        return tensor

    # ------------------------------------------------------------ attr magic
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call Layer.__init__ first")
            params[name] = value
            buffers and buffers.pop(name, None)
            object.__setattr__(self, name, value)
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError("call Layer.__init__ first")
            layers[name] = value
            object.__setattr__(self, name, value)
        elif params is not None and name in params:
            params[name] = value
            object.__setattr__(self, name, value)
        elif buffers is not None and name in buffers:
            buffers[name] = value
            object.__setattr__(self, name, value)
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        # only called when normal lookup fails
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    # ------------------------------------------------------------ iteration
    def named_parameters(self, prefix="", include_sublayers=True):
        seen = set()
        for lname, layer in self.named_sublayers(prefix=prefix,
                                                 include_self=True):
            for pname, p in layer._parameters.items():
                if p is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield (f"{lname}.{pname}" if lname else pname), p

    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters()]

    def named_sublayers(self, prefix="", include_self=False):
        if include_self:
            yield prefix, self
        for name, layer in self._sub_layers.items():
            if layer is None:
                continue
            sub_prefix = f"{prefix}.{name}" if prefix else name
            yield from layer.named_sublayers(prefix=sub_prefix,
                                             include_self=True)

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def children(self) -> Iterator["Layer"]:
        for _, l in self._sub_layers.items():
            if l is not None:
                yield l

    def named_children(self):
        for n, l in self._sub_layers.items():
            if l is not None:
                yield n, l

    def named_buffers(self, prefix="", include_sublayers=True):
        seen = set()
        for lname, layer in self.named_sublayers(prefix=prefix,
                                                 include_self=True):
            for bname, b in layer._buffers.items():
                if b is None or id(b) in seen:
                    continue
                seen.add(id(b))
                yield (f"{lname}.{bname}" if lname else bname), b

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers()]

    # ------------------------------------------------------------- modes
    def train(self):
        self.training = True
        for l in self.children():
            l.train()
        return self

    def eval(self):
        self.training = False
        for l in self.children():
            l.eval()
        return self

    def apply(self, fn):
        for l in self.children():
            l.apply(fn)
        fn(self)
        return self

    # ------------------------------------------------------------- forward
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            out = hook(self, inputs)
            if out is not None:
                inputs = out if isinstance(out, tuple) else (out,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            out = hook(self, inputs, outputs)
            if out is not None:
                outputs = out
        return outputs

    def register_forward_pre_hook(self, hook):
        handle = _HookRemoveHelper(self._forward_pre_hooks)
        self._forward_pre_hooks[handle.id] = hook
        return handle

    def register_forward_post_hook(self, hook):
        handle = _HookRemoveHelper(self._forward_post_hooks)
        self._forward_post_hooks[handle.id] = hook
        return handle

    # ------------------------------------------------------------ state
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        dest = destination if destination is not None else collections.OrderedDict()
        for name, p in self.named_parameters():
            dest[structured_name_prefix + name] = p
        for name, b in self.named_buffers():
            if name.split(".")[-1] not in self._non_persistable_buffer_names:
                dest[structured_name_prefix + name] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        own = self.state_dict()
        missing, unexpected = [], []
        for name, t in own.items():
            if name in state_dict:
                src = state_dict[name]
                src = src._data if isinstance(src, Tensor) else src
                if list(src.shape) != t.shape:
                    raise ValueError(
                        f"shape mismatch for {name}: {list(src.shape)} vs {t.shape}")
                t.set_value(src)
            else:
                missing.append(name)
        for name in state_dict:
            if name not in own:
                unexpected.append(name)
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # ------------------------------------------------------------ dtype/device
    def to(self, device=None, dtype=None, blocking=None):
        if device is not None:
            from ..device import to_torch_device
            dev = to_torch_device(device)
            for t in self._tensors():
                t._set_data(t._data.to(dev))
        if dtype is not None:
            self._to_dtype(dtypes.dtype(dtype))
        return self

    def _tensors(self):
        return [p for _, p in self.named_parameters()] + \
            [b for _, b in self.named_buffers()]

    def astype(self, dtype):
        self._to_dtype(dtypes.dtype(dtype))
        return self

    def _to_dtype(self, dt):
        for t in self._tensors():
            if t.dtype.is_floating_point:
                t._set_data(t._data.to(dt.torch_dtype))
        for l in self.sublayers(include_self=True):
            l._dtype = dt.name

    def float(self):
        return self.astype("float32")

    def half(self):
        return self.astype("float16")

    def bfloat16(self):
        return self.astype("bfloat16")

    # --------------------------------------------------- functional bridge
    def functional_state(self, trainable_only=False):
        """Flat {name: torch.Tensor} of parameters (+buffers, under
        ``buffers.<name>``, unless trainable_only) — the state the
        serving engine and ``generate`` read.  The tensors are the
        parameters' own (detached views of the same storage)."""
        state = {}
        for name, p in self.named_parameters():
            if not trainable_only or p.trainable:
                state[name] = p._data.detach()
        if not trainable_only:
            for name, b in self.named_buffers():
                state["buffers." + name] = b._data.detach()
        return state

    def load_functional_state(self, state):
        """Point parameters/buffers at the given tensors (zero-copy
        rebind; a parameter stays a differentiable leaf)."""
        params = dict(self.named_parameters())
        bufs = dict(self.named_buffers())
        for name, arr in state.items():
            if name.startswith("buffers."):
                bufs[name[len("buffers."):]]._set_data(arr)
            else:
                params[name]._set_data(arr)

    def clear_gradients(self, set_to_zero=True):
        for p in self.parameters():
            p.clear_grad(set_to_zero=False)

    def __repr__(self):
        extra = self.extra_repr()
        lines = []
        for name, child in self._sub_layers.items():
            child_repr = repr(child).split("\n")
            child_repr = "\n".join("  " + l for l in child_repr)
            lines.append(f"({name}): " + child_repr.lstrip())
        main = type(self).__name__ + "(" + extra
        if lines:
            main += "\n  " + "\n  ".join(lines) + "\n"
        return main + ")"

    def extra_repr(self):
        return ""

    def full_name(self):
        return self._name_scope


class _HookRemoveHelper:
    _next_id = 0

    def __init__(self, hooks):
        self._hooks = hooks
        self.id = _HookRemoveHelper._next_id
        _HookRemoveHelper._next_id += 1

    def remove(self):
        self._hooks.pop(self.id, None)
