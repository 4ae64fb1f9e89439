"""Multi-LoRA adapter serving.

``store`` holds the :class:`AdapterStore` (host parking, loud
validation, LRU residency over the runner's packed bank).  The device
half is the runner's packed ``[rows, r, dim]`` bank and per-slot
adapter-index vector (``serving.parallel.runner``) and the gather-LoRA
matmul (``ops.pallas.lora_matmul``, the K5 kernel).  The offline batch
lane (``BatchJob``) needs the HTTP front end and comes with it (ROADMAP
queue 1, serving front end and observability).
"""
from .store import (AdapterStore, LORA_KEYS, lora_key_dims,  # noqa: F401
                    merge_adapter, random_adapter)

__all__ = ["AdapterStore", "LORA_KEYS", "lora_key_dims", "merge_adapter",
           "random_adapter"]
