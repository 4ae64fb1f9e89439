"""Resource observatory: where device memory, compile time, and tokens go.

Ports ``paddle_tpu/observability/resources.py`` by copy, with two
changes: memory samples read ``torch.cuda.memory_stats`` for a CUDA
engine (host RSS alone on the CPU), and the peak-FLOPs table knows the
H100.  The port's engine traces no jit, so its compile ledger stays
empty; the ledger keeps the reference's shape for whatever records into
it.

Reference analogs: Paddle's ``paddle.device.cuda.memory_*`` stats
surface + the profiler's compile/kernel accounting, joined with the
serving-era efficiency reporting (Orca/vLLM goodput and KV-utilization
numbers).  Metrics answer *what happened* and traces and SLOs
*when/why*; this layer answers *what did it cost*:

  * **memory** — the engine's CUDA device's allocator stats
    (``allocated_bytes.all.current`` / ``.peak`` as bytes-in-use /
    peak) plus host RSS; a CPU engine samples host RSS alone;
  * **compile ledger** — per-jit compile count, estimated compile
    seconds, and the arg-shape signature of the trace that caused it.
    The serving engine feeds it first-call timings of its jits (decode
    step, per-bucket prefills, CoW copy); the eager dispatch cache's
    retrace log (``observability.retrace_log``) is merged into every
    snapshot so one report covers both compilation surfaces;
  * **goodput** — useful generated tokens (requests that finished
    ``length``/``eos``) vs tokens thrown away (``cancelled`` /
    ``deadline`` / eviction / preemption): wasted decode work is real
    HBM-seconds, and its fraction is the serving-efficiency headline;
  * **throughput / MFU** — tokens/s over the engine's measured phase
    seconds, and a model-FLOPs-utilization estimate
    ``tokens_per_s * 2 * n_params / peak_flops`` (decode is ~2 FLOPs
    per parameter per token).  Peak FLOPs comes from
    ``FLAGS_resource_peak_tflops`` when set, else a device-kind table;
    unknown devices (CPU) report ``mfu: null`` instead of a lie.

One process-wide tracker (``resource_tracker()``, mirroring the metrics
registry design): ``snapshot()`` is the single JSON payload served by
``GET /debug/resources``, embedded in watchdog hang dumps, and written
to ``resources.json`` by ``observability.dump()``.  Every method is
safe to call from the watchdog thread: the tracker takes only its own
lock, never an engine lock.
"""
from __future__ import annotations

import time

import torch

from ..sanitizer import make_lock
from .registry import default_registry

__all__ = ["CompileLedger", "ResourceTracker", "resource_tracker"]

# bf16 peak FLOP/s per chip by device kind (public figures; the serving
# MFU denominator — FLAGS_resource_peak_tflops overrides)
_PEAK_TFLOPS = {
    "TPU v5p": 459.0, "TPU v5 lite": 197.0, "TPU v5e": 197.0,
    "TPU v6 lite": 918.0, "TPU v6e": 918.0, "TPU v4": 275.0,
    "TPU v3": 123.0, "TPU v2": 45.0,
    # H100 SXM dense bf16 tensor-core peak (torch.cuda.get_device_name
    # reports "NVIDIA H100 80GB HBM3")
    "NVIDIA H100": 989.0,
}

# useful = the request's tokens were delivered as a completed answer;
# wasted = decode work thrown away (client cancel, missed deadline,
# scheduler eviction/preemption)
_USEFUL_REASONS = ("length", "eos")


def _peak_flops(device_kind: str | None) -> float | None:
    from ..flags import FLAGS
    override = float(FLAGS.get("FLAGS_resource_peak_tflops") or 0.0)
    if override > 0:
        return override * 1e12
    if not device_kind:
        return None
    for k, v in _PEAK_TFLOPS.items():
        if device_kind.lower().startswith(k.lower()):
            return v * 1e12
    return None


def _host_rss_bytes() -> int:
    """Current host RSS (linux /proc; fallback: peak RSS from
    getrusage) — same probe hapi.MetricsLogger uses."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return 0


class CompileLedger:
    """Per-jit compile accounting: how many times each jitted program
    traced, the estimated seconds those traces cost, and the arg-shape
    signature of the latest trace.

    The engine has no portable compile hook, so "compile seconds" is
    the wall time of the first call after a fresh trace was detected
    (execution rides along — an upper bound, which is the honest
    direction for a cost ledger)."""

    def __init__(self):
        self._lock = make_lock("CompileLedger._lock")
        self._jits: dict[str, dict] = {}

    def record(self, jit: str, seconds: float, signature: str = ""):
        c = _compile_metrics()
        c["compiles"].labels(jit).inc()
        c["seconds"].labels(jit).inc(max(float(seconds), 0.0))
        with self._lock:
            e = self._jits.setdefault(
                jit, {"count": 0, "seconds": 0.0, "signatures": []})
            e["count"] += 1
            e["seconds"] += max(float(seconds), 0.0)
            if signature and signature not in e["signatures"]:
                e["signatures"].append(signature)
                del e["signatures"][:-8]     # keep the newest few

    def snapshot(self) -> dict:
        with self._lock:
            jits = {k: {"count": v["count"],
                        "seconds": round(v["seconds"], 6),
                        "signatures": list(v["signatures"])}
                    for k, v in self._jits.items()}
        return {"jits": jits,
                "total_compiles": sum(v["count"] for v in jits.values()),
                "total_seconds": round(sum(v["seconds"]
                                           for v in jits.values()), 6)}

    def reset(self):
        with self._lock:
            self._jits.clear()


def _compile_metrics():
    reg = default_registry()
    return {
        "compiles": reg.counter(
            "obs_jit_compiles_total",
            "jit traces recorded in the compile ledger", ("jit",)),
        "seconds": reg.counter(
            "obs_jit_compile_seconds_total",
            "estimated wall seconds spent tracing+compiling, by jit "
            "(first-call timing — execution rides along)", ("jit",)),
    }


def _goodput_metrics():
    reg = default_registry()
    return {
        "tokens": reg.counter(
            "serving_goodput_tokens_total",
            "generated tokens by usefulness: 'useful' reached the "
            "client as a completed answer (length/eos), 'wasted' was "
            "thrown away (cancel/deadline/eviction)", ("kind",)),
        "ratio": reg.gauge(
            "serving_goodput_ratio",
            "useful / (useful + wasted) generated tokens"),
    }


def _memory_metrics():
    # EXACT signatures of the gauges hapi.MetricsLogger registers —
    # _get_or_create returns the same families, so serving and training
    # memory samples land on one timeline
    reg = default_registry()
    return {
        "mem": reg.gauge("device_bytes_in_use", "live device memory",
                         ("device",)),
        "peak": reg.gauge("device_peak_bytes_in_use",
                          "peak device memory", ("device",)),
        "rss": reg.gauge("host_rss_bytes", "host process RSS"),
    }


class ResourceTracker:
    """Process-wide memory / compile / goodput / throughput accounting
    (see module docstring).  All mutators take only the tracker's own
    lock — watchdog-safe by construction."""

    def __init__(self):
        self._lock = make_lock("ResourceTracker._lock")
        self.compiles = CompileLedger()
        self._reset_state()

    def _reset_state(self):
        with self._lock:
            self._devices: dict[str, dict] = {}
            self._rss = 0
            self._mem_samples = 0
            self._useful = 0
            self._wasted = 0
            self._finishes: dict[str, int] = {}
            self._tokens = 0
            self._phase_s: dict[str, float] = {}
            self._n_params = 0
            self._device_kind: str | None = None
            self._device: torch.device | None = None
            self._mesh: dict[str, dict] = {}

    # ----------------------------------------------------------- feeding
    def set_model(self, *, n_params: int, device_kind: str | None,
                  device=None):
        """Register the served model: its parameter count, the device
        kind the MFU peak is looked up by, and the ``torch.device``
        :meth:`sample_memory` reads allocator stats from."""
        with self._lock:
            self._n_params = int(n_params)
            self._device_kind = device_kind
            self._device = None if device is None else torch.device(device)

    def set_mesh(self, positions: dict[str, dict]):
        """Register the serving mesh layout: device key ("platform:id",
        matching :meth:`sample_memory`'s keys) -> axis-position dict
        (e.g. ``{"tp": 2}``).  Memory samples and snapshots annotate
        those devices with their mesh position, and every mesh device
        appears in the memory section even when its backend exports no
        ``memory_stats()`` (CPU) — per-device coverage is the point."""
        with self._lock:
            self._mesh = {str(k): dict(v) for k, v in positions.items()}

    def note_phase(self, phase: str, seconds: float):
        """Accumulate engine wall time by phase (prefill / decode /
        host_sync) — the tokens/s and MFU denominator."""
        with self._lock:
            self._phase_s[phase] = self._phase_s.get(phase, 0.0) \
                + max(float(seconds), 0.0)

    def note_tokens(self, n: int = 1):
        with self._lock:
            self._tokens += int(n)

    def note_finish(self, reason: str, generated: int):
        """One finished request: its generated tokens count as useful
        (length/eos) or wasted (cancelled/deadline/evicted)."""
        generated = int(generated)
        with self._lock:
            self._finishes[reason] = self._finishes.get(reason, 0) + 1
            if reason in _USEFUL_REASONS:
                self._useful += generated
            else:
                self._wasted += generated
            useful, wasted = self._useful, self._wasted
        g = _goodput_metrics()
        if generated:
            g["tokens"].labels(
                "useful" if reason in _USEFUL_REASONS else "wasted"
            ).inc(generated)
        if useful + wasted:
            g["ratio"].set(useful / (useful + wasted))

    def sample_memory(self):
        """One memory poll: the CUDA allocator's stats for the device
        the model was registered on (:meth:`set_model`), plus host RSS.
        A CPU model (or none registered yet) samples host RSS alone —
        a route, not a fallback: CUDA stats errors propagate."""
        devices: dict[str, dict] = {}
        dev = self._device
        if dev is not None and dev.type == "cuda":
            stats = torch.cuda.memory_stats(dev)
            idx = dev.index if dev.index is not None \
                else torch.cuda.current_device()
            devices[f"cuda:{idx}"] = {
                "bytes_in_use": int(stats.get(
                    "allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(stats.get(
                    "allocated_bytes.all.peak", 0))}
        rss = _host_rss_bytes()
        m = _memory_metrics()
        for key, entry in devices.items():
            if "bytes_in_use" in entry:
                m["mem"].labels(key).set(entry["bytes_in_use"])
            if "peak_bytes_in_use" in entry:
                m["peak"].labels(key).set(entry["peak_bytes_in_use"])
        if rss:
            m["rss"].set(rss)
        with self._lock:
            # mesh devices always appear, stats or not (CPU backends
            # export none); positions annotate whatever was sampled
            for key, pos in self._mesh.items():
                entry = devices.setdefault(key, {})
                entry["mesh"] = dict(pos)
            self._devices = devices
            self._rss = rss
            self._mem_samples += 1

    # ---------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """The resources.json / /debug/resources / watchdog payload.
        Reads only tracker state, the metrics registry, and the eager
        retrace log — safe while an engine is wedged."""
        with self._lock:
            devices = {k: dict(v) for k, v in self._devices.items()}
            # mesh registration shows up even before the first memory
            # poll — /debug/resources must cover every mesh device
            for key, pos in self._mesh.items():
                devices.setdefault(key, {})["mesh"] = dict(pos)
            rss, samples = self._rss, self._mem_samples
            useful, wasted = self._useful, self._wasted
            finishes = dict(self._finishes)
            tokens = self._tokens
            phase_s = dict(self._phase_s)
            n_params = self._n_params
            kind = self._device_kind
        compiles = self.compiles.snapshot()
        compiles["eager_by_op"] = _eager_retraces()
        total = useful + wasted
        busy = sum(phase_s.values())
        tps = tokens / busy if busy > 0 else 0.0
        peak = _peak_flops(kind)
        mfu = (tps * 2.0 * n_params / peak
               if peak and n_params else None)
        return {
            "memory": {"devices": devices, "host_rss_bytes": rss,
                       "samples": samples},
            "compiles": compiles,
            "goodput": {
                "useful_tokens": useful, "wasted_tokens": wasted,
                "ratio": (useful / total) if total else None,
                "finishes": finishes},
            "throughput": {
                "tokens": tokens,
                "phase_seconds": {k: round(v, 6)
                                  for k, v in phase_s.items()},
                "tokens_per_s": round(tps, 3),
                "n_params": n_params, "device_kind": kind,
                "peak_flops": peak,
                "mfu": (round(mfu, 6) if mfu is not None else None)},
            "pool": _pool_from_registry(),
        }

    def reset(self):
        self.compiles.reset()
        self._reset_state()


def _eager_retraces() -> dict:
    """op -> distinct-signature count from the eager dispatch cache's
    retrace log (the other compilation surface)."""
    try:
        from . import retrace_log
        return retrace_log.by_op()
    except Exception:
        return {}


def _pool_from_registry() -> dict:
    """Read back the block manager's page-pool gauges — the tracker
    never touches engine structures, so this stays watchdog-safe."""
    reg = default_registry()
    out = {}
    for key, name in (("in_use", "serving_pages_in_use"),
                      ("free", "serving_pages_free"),
                      ("cached", "serving_prefix_cached_pages"),
                      ("total", "serving_pages_total"),
                      ("fragmentation_ratio",
                       "serving_page_fragmentation_ratio")):
        m = reg.get(name)
        if m is not None and not m.labelnames:
            out[key] = m.value
    return out


_tracker = ResourceTracker()


def resource_tracker() -> ResourceTracker:
    return _tracker


def record_compile(jit: str, t0: float, signature: str = ""):
    """Convenience for first-call jit timing: ``t0`` is the
    perf_counter stamp taken before the call that traced."""
    _tracker.compiles.record(jit, time.perf_counter() - t0, signature)
