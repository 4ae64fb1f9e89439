"""Continuous-batching LLM serving on the port (tp=1).

``create_engine(config, state)`` builds an :class:`Engine`; requests go
in through :meth:`Engine.submit` and stream out of :class:`Request`.
Quantized weights (``quant=``, :func:`quantize_state`), int8 KV pages
(``kv_quant=``) and LoRA adapters (``lora=`` an :class:`AdapterStore`)
are engine modes.
"""
from .block_manager import BlockManager  # noqa: F401
from .engine import Engine, NonFiniteLogitsError, create_engine  # noqa: F401
from .lora import AdapterStore, merge_adapter, random_adapter  # noqa: F401
from .quantize import quantize_state  # noqa: F401
from .request import GenerationConfig, Request, RequestState  # noqa: F401
from .scheduler import Scheduler  # noqa: F401

__all__ = ["AdapterStore", "BlockManager", "Engine", "GenerationConfig",
           "NonFiniteLogitsError", "Request", "RequestState", "Scheduler",
           "create_engine", "merge_adapter", "quantize_state",
           "random_adapter"]
