"""Autograd package (ports ``paddle_tpu/autograd``), on torch.autograd."""
from . import tape
from .tape import no_grad, enable_grad, is_grad_enabled, set_grad_enabled, \
    backward, grad
from .py_layer import PyLayer, PyLayerContext
from .functional import jacobian, hessian, saved_tensors_hooks

__all__ = ["no_grad", "enable_grad", "is_grad_enabled", "set_grad_enabled",
           "backward", "grad", "PyLayer", "PyLayerContext", "jacobian",
           "hessian", "saved_tensors_hooks"]
