"""Continuous-batching LLM serving on the port (tp=1).

``create_engine(config, state)`` builds an :class:`Engine`; requests go
in through :meth:`Engine.submit` and stream out of :class:`Request`.
Quantized weights (``quant=``, :func:`quantize_state`), int8 KV pages
(``kv_quant=``), LoRA adapters (``lora=`` an :class:`AdapterStore`),
speculative decoding (``spec_k=``, drafts from :class:`NgramProposer`),
priority preemption (``preempt=``) and fault injection (``faults=`` a
:class:`FaultPlan`) are engine modes; :class:`EngineSupervisor` drives
the step loop and recovers from a poisoned step.
"""
from .block_manager import BlockManager  # noqa: F401
from .engine import Engine, NonFiniteLogitsError, create_engine  # noqa: F401
from .faults import (  # noqa: F401
    FaultPlan, InjectedFault, fault_plan_from_flags)
from .lora import AdapterStore, merge_adapter, random_adapter  # noqa: F401
from .quantize import quantize_state  # noqa: F401
from .request import GenerationConfig, Request, RequestState  # noqa: F401
from .scheduler import Scheduler  # noqa: F401
from .spec import NgramProposer, SpecStats  # noqa: F401
from .supervisor import EngineSupervisor  # noqa: F401

__all__ = ["AdapterStore", "BlockManager", "Engine", "EngineSupervisor",
           "FaultPlan", "GenerationConfig", "InjectedFault",
           "NgramProposer", "NonFiniteLogitsError", "Request",
           "RequestState", "Scheduler", "SpecStats", "create_engine",
           "fault_plan_from_flags", "merge_adapter", "quantize_state",
           "random_adapter"]
