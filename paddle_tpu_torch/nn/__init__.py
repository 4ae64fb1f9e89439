"""paddle.nn namespace of the port: ``Layer`` and its core layers
(``layer_common``, ``layer_norm``), ``functional``, ``initializer`` and
the gradient clips; the weight-only quantization helpers the serving
engine needs (``quant``) and ``flashmask_attention``
(``functional_extra2``).  Convolution, pooling, loss, recurrent and
transformer layers wait (ROADMAP item 9)."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .layer import Layer, Parameter, ParamAttr  # noqa: F401
from .layer_common import *  # noqa: F401,F403
from .layer_norm import *  # noqa: F401,F403
from .clip import ClipGradByNorm, ClipGradByValue, ClipGradByGlobalNorm  # noqa: F401
