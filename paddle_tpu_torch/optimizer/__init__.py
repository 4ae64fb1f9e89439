"""paddle.optimizer namespace of the port (the ``optimizers_extra``
optimizers wait)."""
from .optimizer import Optimizer
from .optimizers import SGD, Momentum, Adam, AdamW, Adagrad, Adadelta, \
    RMSProp, Lamb
from . import lr

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "Adadelta", "RMSProp", "Lamb", "lr"]
