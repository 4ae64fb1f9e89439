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

# Observability, front-end and sanitizer flags the port reads (the serving
# front end, the observability stack and the concurrency sanitizer).
define_flag("FLAGS_metrics_dir", "",
            "directory observability.dump() writes metrics.prom/"
            "metrics.json/retraces.json into (empty: no dump)")
define_flag("FLAGS_trace_buffer_size", 4096,
            "tracing: capacity of the per-process finished-span ring "
            "(observability.tracing.Tracer)")
define_flag("FLAGS_flight_recorder_size", 512,
            "capacity of the engine flight-recorder event ring "
            "(dumped by /debug/flight and the serving watchdog)")
define_flag("FLAGS_serving_watchdog_seconds", 0.0,
            "serving watchdog: seconds of zero decode-loop progress "
            "with active slots before a hang dump (0 disables)")
define_flag("FLAGS_serving_slo_ttft_ms", 0.0,
            "SLO target for time-to-first-token, ms (0 disables)")
define_flag("FLAGS_serving_slo_tpot_ms", 0.0,
            "SLO target for per-output-token latency, ms (0 disables)")
define_flag("FLAGS_serving_slo_e2e_ms", 0.0,
            "SLO target for request end-to-end latency, ms (0 disables)")
define_flag("FLAGS_serving_slo_objective", 0.99,
            "SLO objective (fraction of requests that must meet each "
            "target) — burn rate = violation rate / (1 - objective)")
define_flag("FLAGS_resource_peak_tflops", 0.0,
            "peak accelerator TFLOP/s for the resource tracker's MFU "
            "estimate (0: look the device kind up in the built-in "
            "table; unknown devices report mfu=null)")
define_flag("FLAGS_resource_memory_poll_steps", 16,
            "sample device memory_stats()/host RSS every N engine host "
            "syncs (a host round-trip per device; 0 disables polling)")
define_flag("FLAGS_serving_shed_burn_rate", 0.0,
            "shed load with 429 when any SLO dimension's burn rate "
            "(violation rate / error budget, slo.py) reaches this "
            "threshold — backpressure kicks in before the queue is "
            "full (0 disables; needs SLO targets configured)")
define_flag("FLAGS_obs_timeseries_interval_s", 0.0,
            "fleet-observability sampler: seconds between time-series "
            "ticks (each tick samples the registered serving counters/"
            "gauges into bounded rings and evaluates the alert rules; "
            "0 disables — no store or sampler thread is built and the "
            "serving path pays zero overhead)")
define_flag("FLAGS_obs_timeseries_capacity", 512,
            "fleet-observability time-series ring capacity: points "
            "kept per series (older samples fall off the ring)")
define_flag("FLAGS_obs_fleet_window", 32,
            "recent time-series points each replica publishes per "
            "series in its GET /debug/fleet summary (the router and "
            "the dashboard consume these windows)")
define_flag("FLAGS_obs_profile_interval_s", 0.0,
            "continuous sampling profiler: seconds between stack "
            "sweeps (each sweep walks sys._current_frames and "
            "aggregates phase-attributed per-thread stacks; serve "
            "them via GET /debug/profile or dump() profile.json; "
            "0 disables — no profiler or sweep thread is built and "
            "the serving path pays zero overhead)")
define_flag("FLAGS_obs_capture_dir", "",
            "directory for alert-triggered diagnostic capture bundles "
            "(capture_<n>.json: profile window, flight ring, resource "
            "snapshot, lock-wait graph, series windows; empty falls "
            "back to FLAGS_metrics_dir; with neither set bundles stay "
            "in the bounded in-memory ring behind GET /debug/captures)")
define_flag("FLAGS_obs_capture_min_interval_s", 60.0,
            "per-rule rate limit for diagnostic captures: a rule that "
            "re-fires within this many seconds of its last capture is "
            "counted (obs_captures_rate_limited_total) but captures "
            "no new bundle — a flapping alert cannot fill a disk")
define_flag("FLAGS_obs_capture_max", 8,
            "diagnostic-capture retention: bundles kept on disk and "
            "in the in-memory ring; writing bundle N+1 deletes the "
            "oldest capture_<n>.json")
define_flag("FLAGS_serving_shed_max_priority", 0,
            "burn-rate load shedding only rejects requests with "
            "priority <= this class (higher classes are admitted even "
            "while shedding; used with FLAGS_serving_shed_burn_rate)")
define_flag("FLAGS_serving_usage_meter", False,
            "per-request cost attribution + tenant usage metering: "
            "build a UsageMeter (observability/usage.py) that tracks "
            "queue/prefill/decode/speculation costs, KV page-seconds "
            "(device + host spill tier), and per-tenant rollups behind "
            "GET /debug/usage and serving_usage_* metrics; off (the "
            "default) builds no meter and the serving path pays only "
            "is-not-None tests")
define_flag("FLAGS_serving_usage_max_tenants", 64,
            "LRU bound on distinct tenant labels the usage meter "
            "tracks: admitting tenant N+1 folds the least-recently-"
            "seen tenant's aggregates and metric series into the "
            "(evicted) rollup, so hostile clients cycling X-Tenant "
            "values cannot explode the metrics registry")
define_flag("FLAGS_serving_request_log", False,
            "tail-latency forensics: build a RequestLog "
            "(observability/requestlog.py) that records per-request "
            "lifecycle timelines on the engine clock, folds them into "
            "critical-path attribution buckets that sum exactly to the "
            "measured E2E, and keeps worst-K SLO-violation exemplars — "
            "behind GET /debug/requests/<id>, GET /debug/exemplars, "
            "and serving_latency_attribution_seconds_total; off (the "
            "default) builds no log and the serving path pays only "
            "is-not-None tests")
define_flag("FLAGS_serving_exemplars_k", 8,
            "worst-K reservoir depth per SLO dimension "
            "(ttft/tpot/e2e/error) for the request log's exemplar "
            "store (requires FLAGS_serving_request_log)")
define_flag("FLAGS_sanitizer", False,
            "enable the runtime concurrency sanitizer: serving/"
            "observability locks become instrumented wrappers that "
            "track held-lock stacks, detect runtime ABBA inversions "
            "and lockset-empty shared accesses (Eraser-style), and "
            "export a lock-wait graph for watchdog hang dumps; zero "
            "overhead when off (plain threading primitives)")


# Core flags the eager Paddle API reads (same names, defaults and help
# texts as the reference).
define_flag("FLAGS_check_nan_inf", False, "check op outputs for nan/inf")
define_flag("FLAGS_check_nan_inf_level", 0, "0: abort on nan/inf; 3: log only")
define_flag("FLAGS_strict_view_semantics", False,
            "error on in-place mutation with live views (the aliasing "
            "policy divergence becomes loud; README 'Compatibility "
            "policy')")
