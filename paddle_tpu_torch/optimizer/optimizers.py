"""Concrete optimizers (ports ``paddle_tpu/optimizer/optimizers.py``;
reference: python/paddle/optimizer/{sgd,momentum,adam,adamw,adagrad,
adadelta,rmsprop,lamb}.py).  Math matches the reference's, including
AdamW's decoupled decay (``:120-150``) and Lamb's trust ratio; the
row-sparse updates wait with ``selected_rows``."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adagrad", "Adadelta",
           "RMSProp", "Lamb"]


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _update_param(self, p, g, lr):
        x = self._param_f32(p)
        if self._coeff:
            g = g + self._coeff * x
        self._write_back(p, x - lr * g)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update_param(self, p, g, lr):
        x = self._param_f32(p)
        if self._coeff:
            g = g + self._coeff * x
        v = self._acc(p, "velocity")
        v = self._momentum * v + g
        self._set_acc(p, "velocity", v)
        if self._nesterov:
            update = g + self._momentum * v
        else:
            update = v
        self._write_back(p, x - lr * update)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lazy_mode = bool(lazy_mode)

    def _update_param(self, p, g, lr):
        x = self._param_f32(p)
        if self._coeff:  # L2 regularization folded into grad (Adam semantics)
            g = g + self._coeff * x
        m = self._acc(p, "moment1")
        v = self._acc(p, "moment2")
        t = self._step_count + 1
        m = self._beta1 * m + (1 - self._beta1) * g
        v = self._beta2 * v + (1 - self._beta2) * torch.square(g)
        self._set_acc(p, "moment1", m)
        self._set_acc(p, "moment2", v)
        mhat = m / (1 - self._beta1 ** t)
        vhat = v / (1 - self._beta2 ** t)
        self._write_back(p, x - lr * mhat / (torch.sqrt(vhat) + self._epsilon))


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._wd = float(weight_decay) if isinstance(weight_decay, (int, float)) \
            else float(getattr(weight_decay, "_coeff", 0.01))
        self._apply_decay_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _update_param(self, p, g, lr):
        x = self._param_f32(p)
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        # decoupled weight decay (reference adamw kernel: param *= 1 - lr*wd)
        if self._wd and (self._apply_decay_fun is None or
                         self._apply_decay_fun(p.name)):
            x = x * (1.0 - lr * self._wd)
        m = self._acc(p, "moment1")
        v = self._acc(p, "moment2")
        t = self._step_count + 1
        m = self._beta1 * m + (1 - self._beta1) * g
        v = self._beta2 * v + (1 - self._beta2) * torch.square(g)
        self._set_acc(p, "moment1", m)
        self._set_acc(p, "moment2", v)
        mhat = m / (1 - self._beta1 ** t)
        vhat = v / (1 - self._beta2 ** t)
        self._write_back(p, x - lr * mhat / (torch.sqrt(vhat) + self._epsilon))


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _update_param(self, p, g, lr):
        x = self._param_f32(p)
        if self._coeff:
            g = g + self._coeff * x
        acc = self._acc(p, "moment", torch.full(
            p._data.shape, self._init_acc, dtype=torch.float32,
            device=p._data.device))
        acc = acc + torch.square(g)
        self._set_acc(p, "moment", acc)
        self._write_back(p, x - lr * g / (torch.sqrt(acc) + self._epsilon))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._rho = rho

    def _update_param(self, p, g, lr):
        x = self._param_f32(p)
        if self._coeff:
            g = g + self._coeff * x
        avg_sq = self._acc(p, "avg_squared_grad")
        avg_upd = self._acc(p, "avg_squared_update")
        avg_sq = self._rho * avg_sq + (1 - self._rho) * torch.square(g)
        update = -torch.sqrt((avg_upd + self._epsilon) /
                           (avg_sq + self._epsilon)) * g
        avg_upd = self._rho * avg_upd + (1 - self._rho) * torch.square(update)
        self._set_acc(p, "avg_squared_grad", avg_sq)
        self._set_acc(p, "avg_squared_update", avg_upd)
        self._write_back(p, x + lr * update)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _update_param(self, p, g, lr):
        x = self._param_f32(p)
        if self._coeff:
            g = g + self._coeff * x
        ms = self._acc(p, "mean_square")
        mom = self._acc(p, "momentum")
        ms = self._rho * ms + (1 - self._rho) * torch.square(g)
        self._set_acc(p, "mean_square", ms)
        if self._centered:
            mg = self._acc(p, "mean_grad")
            mg = self._rho * mg + (1 - self._rho) * g
            self._set_acc(p, "mean_grad", mg)
            denom = torch.sqrt(ms - torch.square(mg) + self._epsilon)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * mom + lr * g / denom
        self._set_acc(p, "momentum", mom)
        self._write_back(p, x - mom)


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._wd = lamb_weight_decay
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update_param(self, p, g, lr):
        x = self._param_f32(p)
        m = self._acc(p, "moment1")
        v = self._acc(p, "moment2")
        t = self._step_count + 1
        m = self._beta1 * m + (1 - self._beta1) * g
        v = self._beta2 * v + (1 - self._beta2) * torch.square(g)
        self._set_acc(p, "moment1", m)
        self._set_acc(p, "moment2", v)
        mhat = m / (1 - self._beta1 ** t)
        vhat = v / (1 - self._beta2 ** t)
        r = mhat / (torch.sqrt(vhat) + self._epsilon)
        wd = 0.0 if (self._exclude_fn is not None and self._exclude_fn(p)) \
            else self._wd
        update = r + wd * x
        w_norm = torch.linalg.vector_norm(x)
        u_norm = torch.linalg.vector_norm(update)
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        self._write_back(p, x - lr * trust * update)
