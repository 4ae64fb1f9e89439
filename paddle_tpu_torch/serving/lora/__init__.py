"""Multi-LoRA adapter serving + the offline batch lane.

``store`` holds the :class:`AdapterStore` (host parking, loud
validation, LRU residency over the runner's packed bank); ``batch``
holds :class:`BatchJob`, the lowest-priority JSONL drip-feed behind
``POST /v1/batches``.  The device half is the runner's packed
``[rows, r, dim]`` bank and per-slot adapter-index vector
(``serving.parallel.runner``) and the gather-LoRA matmul
(``ops.pallas.lora_matmul``, the K5 kernel).
"""
from .batch import BATCH_PRIORITY, BatchJob  # noqa: F401
from .store import (AdapterStore, LORA_KEYS, lora_key_dims,  # noqa: F401
                    merge_adapter, random_adapter)

__all__ = ["AdapterStore", "BATCH_PRIORITY", "BatchJob", "LORA_KEYS",
           "lora_key_dims", "merge_adapter", "random_adapter"]
