"""paddle.jit of the port (ports ``paddle_tpu/jit/__init__.py``): the
training-step API (``TrainStep``, ``train_step``) and the logging
levels.  ``to_static``, ``save``/``load``, ``InputSpec`` and the rest
wait (ROADMAP queue 1 item 5.7)."""
from .functional import TrainStep, train_step  # noqa: F401

__all__ = ["TrainStep", "train_step", "set_verbosity", "set_code_level"]

_verbosity = 0
_code_level = 0


def set_verbosity(level=0, also_to_stdout=False):
    """(reference jit/dy2static/logging_utils.py set_verbosity): the
    port traces nothing, so this records the level for API parity."""
    global _verbosity
    _verbosity = int(level)


def set_code_level(level=100, also_to_stdout=False):
    """(reference jit/dy2static/logging_utils.py set_code_level)."""
    global _code_level
    _code_level = int(level)
