"""paddle.nn namespace of the port: ``Layer`` and its layers
(``layer_common``, ``layer_conv``, ``layer_norm``, ``layer_pool``,
``layer_loss``), ``functional``, ``initializer`` and the gradient clips;
the weight-only quantization helpers the serving engine needs
(``quant``) and ``flashmask_attention`` (``functional_extra2``).
Recurrent, transformer and MoE layers wait (ROADMAP queue 1 item 5.3)."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .layer import Layer, Parameter, ParamAttr  # noqa: F401
from .layer_common import *  # noqa: F401,F403
from .layer_conv import Conv1D, Conv2D, Conv3D, Conv2DTranspose  # noqa: F401
from .layer_norm import *  # noqa: F401,F403
from .layer_pool import *  # noqa: F401,F403
from .layer_loss import *  # noqa: F401,F403
from .clip import ClipGradByNorm, ClipGradByValue, ClipGradByGlobalNorm  # noqa: F401
