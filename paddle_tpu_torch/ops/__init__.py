"""Operators of the port: the op registry and its core op modules
(``math``, ``reduction``, ``manipulation``, ``creation``,
``comparison``, ``indexing``; the bitwise ops of ``linalg``), the
attention dispatch and the CUDA kernel wrappers (``pallas/``)."""
from . import registry  # noqa: F401
from .registry import op, OPS  # noqa: F401

from . import math  # noqa: F401
from . import reduction  # noqa: F401
from . import manipulation  # noqa: F401
from . import creation  # noqa: F401
from . import comparison  # noqa: F401
from . import indexing  # noqa: F401
from . import linalg  # noqa: F401

__all__ = ["op", "OPS", "math", "reduction", "manipulation", "creation",
           "comparison", "indexing", "linalg"]
