"""Continuous-batching LLM serving on the port.

``create_engine(config, state)`` builds an :class:`Engine`; requests go
in through :meth:`Engine.submit` and stream out of :class:`Request`.
Quantized weights (``quant=``, :func:`quantize_state`), int8 KV pages
(``kv_quant=``), LoRA adapters (``lora=`` an :class:`AdapterStore`),
speculative decoding (``spec_k=``, drafts from :class:`NgramProposer`),
priority preemption (``preempt=``) and fault injection (``faults=`` a
:class:`FaultPlan`) are engine modes; :class:`EngineSupervisor` drives
the step loop and recovers from a poisoned step.  ``mesh=`` (or
``FLAGS_serving_mesh_tp``) serves with tensor parallelism, one process
per card (:func:`parse_mesh`, ``parallel/worker.py``).

The front end ports the reference's: :func:`serve` puts an engine
behind an OpenAI-style HTTP server (``POST /v1/completions`` with SSE
streaming, 429 backpressure, 503 drain, ``/metrics``, ``/healthz`` and
the ``/debug/*`` routes), :class:`ServingClient` speaks its wire
protocol, :class:`Router` spreads traffic over replicas by prefix
affinity with health probing and circuit breaking, :class:`Watchdog`
detects a wedged decode loop, :class:`SLOTracker` turns finished
requests into SLO verdicts and burn rates, and :class:`BatchJob` is
the offline lane behind ``POST /v1/batches``.
"""
from .block_manager import BlockManager  # noqa: F401
from .client import ServingClient, ServingHTTPError  # noqa: F401
from .engine import Engine, NonFiniteLogitsError, create_engine  # noqa: F401
from .faults import (  # noqa: F401
    FaultPlan, InjectedFault, fault_plan_from_flags)
from .parallel import ModelRunner, parse_mesh  # noqa: F401
from .lora import (  # noqa: F401
    AdapterStore, BATCH_PRIORITY, BatchJob, merge_adapter,
    random_adapter)
from .quantize import quantize_state  # noqa: F401
from .request import GenerationConfig, Request, RequestState  # noqa: F401
from .router import (  # noqa: F401
    NoReplicaAvailable, Replica, Router, RouterServer)
from .scheduler import Scheduler  # noqa: F401
from .server import (  # noqa: F401
    BackpressureError, DrainingError, EngineWorker, ServingServer, serve)
from .slo import SLOConfig, SLOTracker  # noqa: F401
from .spec import NgramProposer, SpecStats  # noqa: F401
from .supervisor import EngineSupervisor  # noqa: F401
from .watchdog import Watchdog  # noqa: F401

__all__ = ["AdapterStore", "BATCH_PRIORITY", "BackpressureError",
           "BatchJob", "BlockManager", "DrainingError", "Engine",
           "EngineSupervisor", "EngineWorker", "FaultPlan",
           "GenerationConfig", "InjectedFault", "ModelRunner",
           "NgramProposer",
           "NoReplicaAvailable", "NonFiniteLogitsError", "Replica",
           "Request", "RequestState", "Router", "RouterServer",
           "SLOConfig", "SLOTracker", "Scheduler", "ServingClient",
           "ServingHTTPError", "ServingServer", "SpecStats", "Watchdog",
           "create_engine", "fault_plan_from_flags", "merge_adapter",
           "parse_mesh", "quantize_state", "random_adapter", "serve"]
