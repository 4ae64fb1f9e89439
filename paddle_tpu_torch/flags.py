"""Global flag system.

Ports ``paddle_tpu/flags.py`` by copy: the same plain-dict registry
with the same names, defaults and help texts (reference:
PHI_DEFINE_EXPORTED_* in paddle/common/flags.h:343, flags.cc, and
paddle.set_flags/get_flags).  Flags are seeded from the environment at
import (``FLAGS_xxx`` env vars) like the reference.  Only the flags the port
reads are registered: a flag whose feature is not ported yet is unknown
here, so ``set_flags`` raises for it instead of accepting a setting
that nothing reads.  The slice that ports a feature registers its
flags.
"""
from __future__ import annotations

import os
from typing import Any

__all__ = ["define_flag", "set_flags", "get_flags", "FLAGS"]

FLAGS: dict[str, Any] = {}
_DEFS: dict[str, tuple[type, Any, str]] = {}


_BOOL_TRUE = ("1", "true", "yes")
_BOOL_FALSE = ("0", "false", "no")


def _coerce(name: str, value, t: type):
    """Coerce ``value`` to the registered flag type, loudly.

    Bools are strict: only the canonical spellings parse — ``"2"`` or
    ``"on"`` raise instead of silently becoming False (the pre-fix
    behavior), and non-bool truthy objects are rejected rather than
    cast.  Other types go through the constructor (so ``"4096"`` is a
    fine int), with failures re-raised as a flag-specific error.
    """
    if t is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            low = value.strip().lower()
            if low in _BOOL_TRUE:
                return True
            if low in _BOOL_FALSE:
                return False
        raise ValueError(
            f"flag {name!r} is a bool; got {value!r} (accepted: "
            f"{'/'.join(_BOOL_TRUE)} or {'/'.join(_BOOL_FALSE)})")
    # bool-as-number for int/float flags is almost always a mistake
    # (checked first: bool IS an int subclass, isinstance would pass it)
    if isinstance(value, bool):
        raise TypeError(
            f"flag {name!r} expects {t.__name__}, got bool {value!r}")
    if isinstance(value, t):
        return value
    try:
        return t(value)
    except (TypeError, ValueError) as e:
        raise TypeError(
            f"flag {name!r} expects {t.__name__}, got "
            f"{type(value).__name__} {value!r}: {e}") from None


def define_flag(name: str, default, help_: str = "", type_=None):
    t = type_ or type(default)
    _DEFS[name] = (t, default, help_)
    env = os.environ.get(name)
    if env is not None:
        FLAGS[name] = _coerce(name, env, t)
    else:
        FLAGS[name] = default
    return name


def set_flags(flags: dict):
    # validate the whole batch before mutating: a bad entry must not
    # leave a half-applied update behind
    coerced = {}
    for k, v in flags.items():
        if k not in _DEFS:
            raise ValueError(f"unknown flag {k!r}")
        coerced[k] = _coerce(k, v, _DEFS[k][0])
    FLAGS.update(coerced)


def get_flags(keys):
    if isinstance(keys, str):
        keys = [keys]
    return {k: FLAGS[k] for k in keys}


# Serving flags the port reads (same names, defaults and help texts as
# the reference).
define_flag("FLAGS_serving_mesh_tp", 1,
            "serving tensor-parallel mesh size: shard attention heads, "
            "the FFN hidden dim, and the paged KV pool across the "
            "first N local devices (1 = single-chip; create_engine/"
            "serve --mesh overrides; the port serves tp=1 only and "
            "raises NotImplementedError for N > 1)")
define_flag("FLAGS_serving_spec_k", 0,
            "speculative decoding draft length: the serving engine's "
            "prompt-lookup (n-gram) drafter proposes up to K tokens per "
            "slot and one verify step scores all K+1 positions (0 = "
            "off; greedy outputs are identical either way; "
            "create_engine/serve --spec-k overrides)")
define_flag("FLAGS_serving_fault_plan", "",
            "deterministic fault injection plan for the serving stack "
            "(chaos testing): comma-separated entries 'site@N' (inject "
            "on the Nth check of that site), 'site~P' (inject with "
            "probability P per check, seeded), plus 'seed=S'; entries "
            "take ':key=value' params (e.g. 'nan_logits@2:slot=1'). "
            "Empty = no injection and zero overhead (no plan object is "
            "built; every site guards on 'faults is not None')")
define_flag("FLAGS_serving_max_recoveries", 3,
            "EngineSupervisor restart budget: runner rebuild + in-flight "
            "re-prefill recoveries allowed per process before escalating "
            "to drain (in-flight requests then finish with "
            "finish_reason='error' and the worker stops admitting)")
define_flag("FLAGS_serving_prefill_chunk", 0,
            "chunked prefill: split admission prefill into chunks of at "
            "most N prompt tokens, interleaved with decode steps so one "
            "long prompt cannot stall every decoding slot's TPOT (chunk "
            "K attends chunks 1..K-1 through the cached-prefill jit — "
            "no new traced program; 0 = whole-prompt prefill; "
            "create_engine/serve --prefill-chunk overrides)")
define_flag("FLAGS_serving_preempt", True,
            "priority preempt-and-swap: when a higher-priority request "
            "cannot be placed, evict the lowest-priority most-recently-"
            "admitted resident, spill its exclusive KV pages to host "
            "RAM, and re-queue it for a parity-preserving resume "
            "(False = strict FCFS within the priority order)")
define_flag("FLAGS_serving_host_pages", 4096,
            "capacity of the BlockManager host-RAM spill tier in KV "
            "pages: preempted requests' exclusive pages park here "
            "(content-addressed, LRU) and unpark on resume without "
            "recomputing prefill (0 disables spilling to host)")
define_flag("FLAGS_serving_fair_share", False,
            "fair-share admission/preemption bias: when burn-rate "
            "shedding fires, only the heaviest-page-second tenant's "
            "requests are shed within the shed-eligible class, and "
            "preemption victim selection prefers that tenant's "
            "residents within the lowest priority class (requires "
            "FLAGS_serving_usage_meter; off = zero behavior change)")
define_flag("FLAGS_serving_quant", "",
            "weight-only quantized serving: 'int8' or 'int4' converts "
            "the dense checkpoint at engine construction "
            "(serving/quantize.quantize_state: per-projection matmul "
            "weights become QuantizedWeight leaves, embeddings/norms/"
            "lm_head stay dense) and serves it through the "
            "weight_only_matmul decode path on any tp; empty (the "
            "default) leaves the state untouched — zero behavior "
            "change")
define_flag("FLAGS_serving_kv_quant", False,
            "int8 KV pages: the serving runner's paged KV pools store "
            "int8 with per-(page-row, head) f32 scales, quantized on "
            "write inside the jitted step and dequantized fused into "
            "the attention gather; spill/restore move the quantized "
            "bytes, roughly halving page traffic at f32 checkpoints; "
            "off (the default) keeps the dense pools byte-identical")
