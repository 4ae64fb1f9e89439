"""Optimizer base (ports ``paddle_tpu/optimizer/optimizer.py``).

State (accumulators, master weights) is a dict of float32 torch tensors
keyed by parameter name.  Updates compute in float32 — from a float32
master copy for low-precision params when ``multi_precision`` (the
reference's ``_master_weights``, ``:50-76``) — and write back in the
param's dtype by rebinding the param's handle (``Tensor._set_data``),
which keeps the accumulated ``.grad`` on the handle and the param a
differentiable leaf.  The reference's fused jitted step amortises JAX
dispatch; here each update runs its torch ops eagerly.
"""
from __future__ import annotations

import torch

from ..framework.tensor import Tensor
from ..autograd import no_grad

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        from .lr import LRScheduler
        if parameters is None:
            raise ValueError(
                "parameters is required in dygraph mode (pass model.parameters())")
        self._parameter_list = list(parameters)
        if not self._parameter_list:
            raise ValueError("optimizer got an empty parameter list")
        self._lr = learning_rate
        self._lr_scheduler = learning_rate if isinstance(
            learning_rate, LRScheduler) else None
        self._l1_coeff = 0.0
        if isinstance(weight_decay, float):
            self._coeff = weight_decay
        elif weight_decay is None:
            self._coeff = 0.0
        else:  # L1Decay/L2Decay-like object with a coeff
            coeff = float(getattr(weight_decay, "_coeff",
                                  getattr(weight_decay, "coeff", 0.0)))
            if type(weight_decay).__name__ == "L1Decay":
                self._l1_coeff = coeff
                self._coeff = 0.0
            else:
                self._coeff = coeff
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._accumulators: dict[str, dict[str, torch.Tensor]] = {}
        self._master_weights: dict[str, torch.Tensor] = {}
        self._step_count = 0
        self._name = name

    # ------------------------------------------------------------ lr
    def get_lr(self):
        if self._lr_scheduler is not None:
            return self._lr_scheduler()
        return float(self._lr)

    def set_lr(self, value):
        self._lr = float(value)
        self._lr_scheduler = None

    # ------------------------------------------------------------ state
    def _param_key(self, p):
        return p.name

    def _get_master(self, p):
        key = self._param_key(p)
        if not self._multi_precision or p._data.dtype == torch.float32:
            return None
        if key not in self._master_weights:
            self._master_weights[key] = p._data.detach().float()
        return self._master_weights[key]

    def _acc(self, p, name, init=None):
        key = self._param_key(p)
        slot = self._accumulators.setdefault(key, {})
        if name not in slot:
            slot[name] = init if init is not None else torch.zeros(
                p._data.shape, dtype=torch.float32, device=p._data.device)
        return slot[name]

    def _set_acc(self, p, name, value):
        self._accumulators[self._param_key(p)][name] = value

    # ------------------------------------------------------------ step
    @no_grad()
    def step(self):
        params_grads = []
        for p in self._parameter_list:
            g = p._grad_data()
            if p.stop_gradient or g is None:
                continue
            params_grads.append((p, g))
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        for p, g in params_grads:
            if g is None:
                continue
            g32 = g.float()
            if self._l1_coeff:  # L1 regularization: grad += c * sign(param)
                g32 = g32 + self._l1_coeff * torch.sign(self._param_f32(p))
            self._update_param(p, g32, lr)
        self._step_count += 1

    def _update_param(self, p, grad_f32, lr):
        raise NotImplementedError

    def _write_back(self, p, new_f32):
        key = self._param_key(p)
        if key in self._master_weights:
            self._master_weights[key] = new_f32
        p._set_data(new_f32.to(p._data.dtype))

    def _param_f32(self, p):
        master = self._get_master(p)
        return master if master is not None else p._data.detach().float()

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.clear_grad(set_to_zero=False)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    # ------------------------------------------------------------ ckpt
    def state_dict(self):
        state = {}
        for pkey, slots in self._accumulators.items():
            for sname, arr in slots.items():
                state[f"{pkey}.{sname}"] = Tensor(arr)
        for pkey, arr in self._master_weights.items():
            state[f"{pkey}.master_weight"] = Tensor(arr)
        if self._lr_scheduler is not None:
            state["LR_Scheduler"] = self._lr_scheduler.state_dict()
        state["@step"] = self._step_count
        return state

    def set_state_dict(self, state):
        for key, val in state.items():
            if key == "LR_Scheduler":
                if self._lr_scheduler is not None:
                    self._lr_scheduler.set_state_dict(val)
                continue
            if key == "@step":
                self._step_count = int(val)
                continue
            pkey, sname = key.rsplit(".", 1)
            arr = val._data if isinstance(val, Tensor) else torch.as_tensor(val)
            if sname == "master_weight":
                self._master_weights[pkey] = arr
            else:
                self._accumulators.setdefault(pkey, {})[sname] = arr
