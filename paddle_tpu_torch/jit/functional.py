"""The training-step API of ``paddle_tpu/jit/functional.py``
(``TrainStep``, ``train_step``) in plain PyTorch.

The reference compiles forward, backward and the optimizer update into
one XLA program (and ``multi_step(n)`` into one scan of n steps); the
port runs the same step eagerly on the model's own tensors:
``loss_fn(model, *batch)``, ``backward``, ``optimizer.step()`` and
``clear_grad()``.  BatchNorm's running buffers update in the forward,
as the reference's ``bufs`` write-back does (``:136-138``).  A CUDA
graph or ``torch.compile`` of the step is a later speed item.

The batch goes to the current device (CUDA unless ``set_device("cpu")``
asks for the CPU: with no card, a call raises).
"""
from __future__ import annotations

from typing import Callable

from ..autograd import enable_grad
from ..device import current_device
from ..framework.tensor import Tensor, to_tensor

__all__ = ["TrainStep", "train_step"]


def _as_tensors(batch, device):
    """Tensors stay; arrays and nested lists / tuples / dicts of them
    become Tensors (no gradient) on ``device``."""
    if isinstance(batch, Tensor):
        return batch
    if isinstance(batch, (list, tuple)):
        return type(batch)(_as_tensors(b, device) for b in batch)
    if isinstance(batch, dict):
        return {k: _as_tensors(v, device) for k, v in batch.items()}
    return to_tensor(batch, place=device)


class TrainStep:
    def __init__(self, model, optimizer, loss_fn: Callable, donate=True):
        # ``donate`` is the reference's (its state buffers go to XLA);
        # the port steps the model's own tensors, so it has no effect
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn

    def _step(self, inputs):
        with enable_grad():
            loss = self.loss_fn(self.model, *inputs)
            loss.backward()
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss

    def _inputs(self, batch):
        return _as_tensors(list(batch), current_device())

    def multi_step(self, n):
        """n training steps per call on the same batch (the reference's
        scan, ``:70-117``); returns the last step's loss.

            many = paddle.jit.train_step(model, opt, loss_fn).multi_step(10)
            loss = many(x, y)     # 10 steps
        """
        def run(*batch):
            inputs = self._inputs(batch)
            for _ in range(n):
                loss = self._step(inputs)
            return Tensor(loss._data.detach(), stop_gradient=True)

        return run

    def __call__(self, *batch):
        """Run one step; returns the loss Tensor (no gradient)."""
        loss = self._step(self._inputs(batch))
        return Tensor(loss._data.detach(), stop_gradient=True)


def train_step(model, optimizer, loss_fn):
    """Build a train step:

        step = paddle_tpu_torch.jit.train_step(model, opt,
                    lambda m, x, y: F.cross_entropy(m(x), y))
        loss = step(x_batch, y_batch)
    """
    return TrainStep(model, optimizer, loss_fn)
