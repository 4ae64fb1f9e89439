"""Continuous-batching inference engine over the paged KV pool.

Ports ``paddle_tpu/serving/engine.py`` (Orca's iteration-level
scheduling over vLLM-style PagedAttention):

  * ONE decode-step program over a fixed number of decode slots and one
    shared page pool.  Slot occupancy, positions and block tables are
    data (int32 tensors on the device), never shapes — admitting or
    evicting a request rebuilds nothing.  Attention in the step runs the
    CUDA paged-attention kernel.
  * prefill-on-admit: an admitted request's prompt runs through
    ``_prefill_layer`` (padded to a page-multiple bucket; attention is
    the CUDA masked flash forward) and pages its KV straight into the
    shared pool; the token picked from the prompt's last logits is the
    request's first output (its TTFT mark).  With
    ``enable_prefix_cache=True`` the admission reserves pages for (and
    prefills) only the prompt's uncached suffix: shared prefix pages
    come from the :class:`BlockManager` chain index, a matching partial
    tail page is copied (copy-on-write) on the device, and the suffix
    runs a cached prefill that attends over the resident prefix KV.
    ``prefill_chunk=N`` splits long admissions into N-token chunks, one
    per engine step, so decoding slots keep stepping in between.
  * device-resident decode state: ``table``/``pos``/``tok``, the active
    mask and a ``[sync_interval, slots]`` sampled-token ring live on the
    device — a steady-state decode iteration uploads and downloads
    nothing.  The host fetches the ring once every ``sync_interval``
    steps (greedy path) and the ``[slots, V]`` logits only when an
    active request samples (``emit_logits=True``).
  * idle slots park on the dump page (table row all-dump, pos 0): their
    lockstep writes land in scratch, their outputs are discarded
    host-side.

Sampling is host-side per request (greedy = argmax of the f32 logits;
stochastic requests draw from a per-request numpy RNG, so results do not
depend on batch composition).

Serving modes: ``quant="int8"|"int4"`` converts the dense checkpoint at
construction (``quantize_state``: the projections run the K4 GEMV);
``kv_quant=True`` switches the KV pools to int8 pages with f32 scales;
``lora=AdapterStore(...)`` arms a packed adapter bank, and
``submit(..., adapter="name")`` pins that adapter's bank row from submit
to finalize (the decode step's deltas run the K5 kernel).  Prefix pages
and host-parked pages are shared only between requests of one adapter.

``spec_k=K`` turns on speculative decoding (a host-side n-gram drafter;
one verify step scores K+1 positions per slot through the same paged
layers, so K3 runs at slots x (K+1) rows); ``preempt`` (default
``FLAGS_serving_preempt``, True) lets a higher-priority request evict
the lowest-class resident, whose exclusive KV pages spill to the host
tier and come back on resume; ``faults=FaultPlan(...)`` injects faults
at the reference's sites, and :meth:`Engine.recover` (driven by the
:class:`~.supervisor.EngineSupervisor`) rebuilds the runner and replays
every in-flight request.  A failed prefill or a non-finite logits row
fails only its request (``finish_reason="error"``).

Observability follows the reference seam for seam: every request gets a
``request`` root span (parented under the caller's ``traceparent`` when
the server passes one) with ``scheduler.queue_wait`` / ``engine.prefill``
/ ``engine.decode`` children, the engine records ``engine.*`` spans and
flight-recorder events, publishes ``current_phase`` for the sampling
profiler, and feeds the process resource tracker.  ``usage=`` (a
:class:`~..observability.usage.UsageMeter`), ``requestlog=`` (a
:class:`~..observability.requestlog.RequestLog`) and ``slo=`` (a
:class:`~.slo.SLOTracker`) arm per-request cost metering, lifecycle
timelines and SLO verdicts; each seam is one ``is not None`` test when
off.

Tensor parallelism (``mesh=`` / ``FLAGS_serving_mesh_tp``): heads and
the FFN hidden dim shard over ``tp`` ranks, one process per card
(``parallel/worker.py``: this process is rank 0 and keeps the whole host
half; ranks 1 … tp-1 run their shards of every device call it makes).
The page table and the scheduling stay host-side and mesh-agnostic.
``tp=1`` is exactly the single-device runner: no process, no message,
no collective.  :meth:`Engine.close` stops the workers.
"""
from __future__ import annotations

import time

import numpy as np

import torch

from .. import observability as _obs
from .. import resolve_device
from ..flags import FLAGS
from ..observability.resources import resource_tracker
from ..models.generation import GenerationConfig
from ..models.llama import LlamaConfig
from .block_manager import BlockManager
from .faults import InjectedFault, fault_plan_from_flags
from .parallel.mesh import parse_mesh, validate_tp
from .parallel.runner import ModelRunner
from .parallel.worker import MeshRunner, get_mesh
from .quantize import quantize_state
from .request import Request, RequestState
from .scheduler import Scheduler
from .spec import NgramProposer, SpecStats

__all__ = ["Engine", "NonFiniteLogitsError", "create_engine"]

_M_STEPS = _obs.counter(
    "serving_decode_steps_total", "engine decode iterations")
_M_TOKENS = _obs.counter(
    "serving_tokens_total", "tokens emitted to requests")
_M_REQUESTS = _obs.counter(
    "serving_requests_total", "finished requests", ("outcome",))
_M_FINISH = _obs.counter(
    "serving_finish_total",
    "finished requests by finish_reason "
    "(length|eos|cancelled|deadline|error)", ("reason",))
_M_RECOVERY = _obs.counter(
    "serving_recovery_total",
    "self-healing events: 'quarantine' = one request failed in place "
    "(finish_reason='error', batch kept running), 'rebuild' = runner "
    "rebuilt + in-flight requests replayed, 'stall' = rebuild declared "
    "by the watchdog, 'drain' = restart budget exhausted, escalated",
    ("kind",))
_M_HOST_SYNCS = _obs.counter(
    "serving_host_syncs_total",
    "device->host transfers on the serving hot path: 'ring' = sampled-"
    "token ring fetch (one per sync_interval decode steps on the greedy "
    "path), 'logits' = [slots, V] logits fetch (only when an active "
    "request samples), 'prefill' = first-token logits at admission",
    ("kind",))
_M_PHASE_SECONDS = _obs.counter(
    "serving_step_phase_seconds_total",
    "engine wall seconds by phase: 'prefill' calls (incl. CoW copies), "
    "'decode' step dispatch, 'host_sync' blocking ring fetches",
    ("phase",))
_M_CHUNKS = _obs.counter(
    "serving_prefill_chunks_total",
    "chunked-prefill calls: admission prefill split into "
    "prefill_chunk-token pieces interleaved with decode steps (chunk K "
    "attends chunks 1..K-1 via the cached prefill)")

class NonFiniteLogitsError(ValueError):
    """A request's logits hold no usable probability mass (NaN/Inf from
    the model, or top_k/top_p masked every candidate).  A per-request
    failure: the engine quarantines the offending request
    (finish_reason='error') and keeps the rest of the batch running."""


def _serving_hists():
    buckets = _obs.registry.SERVING_LATENCY_BUCKETS
    ttft = _obs.histogram(
        "serving_ttft_seconds", "request arrival -> first token",
        buckets=buckets)
    tpot = _obs.histogram(
        "serving_tpot_seconds", "inter-token latency during decode",
        buckets=buckets)
    e2e = _obs.histogram(
        "serving_e2e_seconds", "request arrival -> completion",
        buckets=buckets)
    return ttft, tpot, e2e


class Engine:
    """Drives admission, prefill, and the shared decode step.

    Static shapes (fixed at construction): ``max_slots`` decode slots,
    ``table_width`` pages per sequence, ``num_pages (+ dump)`` pool rows,
    ``sync_interval`` ring rows.  Everything per-request is data.
    ``device=None`` runs on CUDA and raises when there is no card.

    Built from a ``model`` (a ``LlamaForCausalLM``: its ``config`` and
    ``functional_state()``, served on its parameters' device unless
    ``device`` says otherwise), as the reference's is, or from
    ``config=`` and ``state=``.
    """

    def __init__(self, model=None, *, config: LlamaConfig = None,
                 state: dict | None = None, device=None,
                 max_slots: int = 4, page_size: int = 64,
                 num_pages: int | None = None,
                 max_model_len: int | None = None,
                 emit_logits: bool = False,
                 enable_prefix_cache: bool = False,
                 sync_interval: int = 1, clock=time.monotonic,
                 spec_k: int | None = None,
                 prefill_chunk: int | None = None,
                 preempt: bool | None = None, faults=None,
                 quant: str | None = None, kv_quant: bool | None = None,
                 lora=None, slo=None, usage=None, requestlog=None,
                 mesh=None):
        if model is not None:
            config, state = model.config, model.functional_state()
            if device is None:
                device = next(iter(state.values())).device
        if config is None or state is None:
            raise ValueError("pass a model, or both config= and state=")
        # the mesh first: a tp that does not divide the heads and the FFN
        # width is refused before anything is built
        if mesh is None:
            mesh = int(FLAGS.get("FLAGS_serving_mesh_tp") or 1)
        self.tp = parse_mesh(mesh)
        validate_tp(config, self.tp)
        self.device = resolve_device(device)
        if self.tp > 1 and self.device.type == "cuda" \
                and self.device.index not in (None, 0):
            raise ValueError(
                f"a tp={self.tp} mesh runs its ranks on cuda:0 … "
                f"cuda:{self.tp - 1}; rank 0 (this process) takes cuda:0, "
                f"not {self.device}")
        # quantized serving: convert the dense checkpoint before
        # placement (embeddings/norms/lm_head stay dense, so the dtype
        # the pools take still is the checkpoint's).  quant off (the
        # default) leaves the state untouched.
        if quant is None:
            quant = str(FLAGS.get("FLAGS_serving_quant") or "")
        if kv_quant is None:
            kv_quant = bool(FLAGS.get("FLAGS_serving_kv_quant"))
        if quant not in ("", "int8", "int4"):
            raise ValueError(
                f"quant must be '', 'int8', or 'int4', got {quant!r}")
        self.quant = quant
        self.kv_quant = bool(kv_quant)
        if self.quant:
            state = quantize_state(state, kind=self.quant)
        # multi-LoRA serving: the AdapterStore sizes the runner's packed
        # bank (rows x rank fixed at construction)
        self.lora = lora
        if lora is not None and lora.rank is None:
            raise ValueError(
                "the AdapterStore has no adapters and no explicit "
                "rank= — the runner cannot size the bank (register "
                "one adapter first, or pass AdapterStore(rank=...))")
        self.config = config
        # kept for recover(): a rebuilt runner places the same weights
        self.state = state
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.max_model_len = int(max_model_len
                                 or config.max_position_embeddings)
        if self.max_model_len > config.max_position_embeddings:
            raise ValueError(
                f"max_model_len {self.max_model_len} exceeds the model's "
                f"max_position_embeddings {config.max_position_embeddings}")
        self.table_width = -(-self.max_model_len // self.page_size)
        if num_pages is None:       # full residency: every slot can run
            num_pages = self.max_slots * self.table_width  # at max length
        self.emit_logits = bool(emit_logits)
        self.enable_prefix_cache = bool(enable_prefix_cache)
        self.sync_interval = int(sync_interval)
        if self.sync_interval < 1:
            raise ValueError(
                f"sync_interval must be >= 1, got {sync_interval}")
        self._clock = clock
        if spec_k is None:
            spec_k = int(FLAGS.get("FLAGS_serving_spec_k") or 0)
        self.spec_k = int(spec_k)
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if self.spec_k:
            self._proposer = NgramProposer(self.spec_k)
            self._spec = SpecStats()
        else:
            self._proposer = None
            self._spec = None
        if prefill_chunk is None:
            prefill_chunk = int(
                FLAGS.get("FLAGS_serving_prefill_chunk") or 0)
        self.prefill_chunk = max(int(prefill_chunk), 0)
        if preempt is None:
            preempt = bool(FLAGS.get("FLAGS_serving_preempt"))
        self.preempt = bool(preempt)
        # chaos harness: None (the default when FLAGS_serving_fault_plan
        # is empty) keeps every injection site to a single None test
        self.faults = fault_plan_from_flags() if faults is None else faults

        self.blocks = BlockManager(
            num_pages, self.page_size,
            enable_prefix_cache=self.enable_prefix_cache,
            faults=self.faults)
        # chunked admissions must not be cache-matchable until their KV
        # has actually been written: allocate_seq defers registration
        # past this many fresh tokens and the engine publishes after the
        # last chunk lands
        self.blocks.defer_publish = self.prefill_chunk
        self.scheduler = Scheduler(self.blocks, self.max_slots,
                                   clock=self._clock,
                                   preempt_enabled=self.preempt)
        self.scheduler._finalize = self._finalize
        # preempt-and-swap: the scheduler picks the victim, the engine
        # owns the device side (spill exclusive KV pages to the host
        # tier, release the pages, park the slot)
        self.scheduler._preempt = self._preempt
        # every eviction parks its slot: a cancel/deadline eviction would
        # otherwise leave the slot's table/pos pointing at freed pages,
        # and the lockstep decode step (which writes KV for every slot)
        # would corrupt them once reallocated
        self.scheduler._on_evict = self._park
        # per-request cost attribution (observability.usage): every
        # call site below is a single ``is not None`` test, so the
        # default (no meter) adds zero work to the serving path
        self.usage = usage
        if usage is not None:
            if usage._clock is None:
                usage._clock = self._clock   # page-seconds on engine clock
            self.blocks.usage = usage        # page hold/release + host tier
            self.scheduler.usage = usage     # fair-share victim selection
            if slo is not None:
                slo.verdict_hook = usage.slo_verdict
            # the process-active meter: obs.dump() writes usage.json
            # from it (last engine built wins)
            _obs.set_active_usage(usage)
        # tail-latency forensics (observability.requestlog): per-request
        # lifecycle timelines + critical-path attribution + SLO-violation
        # exemplars, under the same zero-overhead-off contract
        self.requestlog = requestlog
        if requestlog is not None:
            if slo is not None:
                # violation exemplars ride the tracker's verdicts; the
                # usage meter's verdict_hook is untouched
                slo.exemplar_hook = requestlog.slo_verdict
            # the process-active log: obs.dump() writes exemplars.json
            _obs.set_active_requestlog(requestlog)

        # the device half; the kwargs are kept so recover() can rebuild
        # an identical runner after a poisoned step (fresh pools, same
        # static shapes)
        self._runner_kw = dict(
            device=self.device, max_slots=self.max_slots,
            page_size=self.page_size, table_width=self.table_width,
            num_pages=self.blocks.num_pages,
            dump_page=self.blocks.dump_page,
            sync_interval=self.sync_interval,
            emit_logits=self.emit_logits, spec_k=self.spec_k,
            kv_quant=self.kv_quant,
            lora_slots=lora.capacity if lora is not None else 0,
            lora_rank=lora.rank if lora is not None else 0)
        self.runner = self._new_runner()
        if lora is not None:
            # bind the store to the bank: resident adapters (if any)
            # upload now; later acquires patch single rows in place
            lora.attach(self.runner)
        self._embed_itemsize = \
            state["llama.embed_tokens.weight"].element_size()

        # host-side mirrors of the slot state (bookkeeping + targeted
        # device patches on admit/evict; NEVER re-uploaded per step)
        self.table = np.tile(self.blocks.empty_row(self.table_width),
                             (self.max_slots, 1))
        self._pos = np.zeros((self.max_slots,), np.int32)
        self._tok = np.zeros((self.max_slots,), np.int32)
        self._active = np.zeros((self.max_slots,), np.int32)
        # per-slot adapter bank row (0 = the zero no-adapter row)
        self._aidx = np.zeros((self.max_slots,), np.int32)
        self._ring_cursor = 0           # host mirror of the ring index
        # ring rows the host has not consumed yet, in decode order:
        # [(ring row, [(slot, request), ...], drafts-or-None), ...] —
        # the third element is the verify step's {slot: draft tokens}
        # (a verify row syncs immediately, so it is always solitary)
        self._pending: list[tuple[int, list, dict | None]] = []
        self._last_logits = None        # device tensor, fetched lazily

        self.decode_steps = 0       # mirror of serving_decode_steps_total
        self.host_syncs = 0         # ring fetches (1 per sync_interval)
        self.logit_fetches = 0      # [slots, V] transfers (sampling only)
        # chunked prefill: in-flight admission prefills advanced one
        # chunk per engine step — {slot: state dict}
        self._chunking: dict[int, dict] = {}
        self.prefill_chunks = 0     # mirror of serving_prefill_chunks_total
        self.preemptions = 0        # successful preempt-and-swap spills
        self.spill_aborts = 0       # preemptions aborted by a failed spill
        # the most prompt tokens prefilled between two decode steps —
        # bounded by prefill_chunk when chunking is on
        self._prefill_since_decode = 0
        self.max_prefill_gap = 0
        # self-healing mirrors of serving_recovery_total
        self.recoveries = 0         # runner rebuilds (recover() calls)
        self.quarantines = 0        # requests failed in place
        self.replayed_requests = 0  # in-flight requests re-prefilled
        # per-phase wall seconds (mirror of serving_step_phase_seconds_
        # total)
        self.timings = {"prefill_s": 0.0, "decode_s": 0.0,
                        "host_sync_s": 0.0}
        # monotonically increasing iteration counter: the serving
        # watchdog reads it lock-free to detect a wedged decode loop
        self.progress = 0
        # what the engine is doing right now, for the sampling profiler
        # (prefill / prefill_chunk / decode / verify / host_sync / idle):
        # a plain attribute store at each section entry, read lock-free
        self.current_phase = "idle"
        self.slo = slo              # optional slo.SLOTracker
        # open "engine.decode_segment" span covering the device steps
        # since the last host sync (None between segments)
        self._seg_span = None
        self._seg_steps = 0
        self._rngs: dict[int, np.random.Generator] = {}
        self._ttft, self._tpot, self._e2e = _serving_hists()
        self._pages_hist = _obs.histogram(
            "serving_pages_in_use_hist",
            "pages-in-use sampled at each decode step",
            buckets=_pages_buckets(self.blocks.num_pages))
        # resource tracker: model size + device kind feed the MFU
        # estimate (tokens/s * 2 * n_params / peak_flops); the device
        # feeds its memory samples
        n_params = sum(int(np.prod(v.shape))
                       for v in state.values() if hasattr(v, "shape"))
        device_kind = (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else None)
        resource_tracker().set_model(n_params=n_params,
                                     device_kind=device_kind,
                                     device=self.device)
        # the quant / LoRA metric surface, registered only when the mode
        # is on, so a dense engine exports the pre-quant set
        if self.quant or self.kv_quant:
            _obs.gauge(
                "serving_quant_weight_bits",
                "weight-only quantization width of the serving state "
                "(8 = int8, 4 = nibble-packed int4, 0 = dense weights)"
            ).set({"int8": 8, "int4": 4}.get(self.quant, 0))
            _obs.gauge(
                "serving_quant_kv_page_bits",
                "KV pool element width: 8 under the int8 page mode "
                "(per-(page-row, head) f32 scales ride separately), "
                "else the checkpoint dtype width"
            ).set(8 if self.kv_quant else self._embed_itemsize * 8)
            _obs.gauge(
                "serving_quant_kv_page_bytes",
                "bytes one KV page pair (k + v + scales) occupies — "
                "what each spill/restore moves"
            ).set(self._page_bytes())
            # quant.json provider for obs.dump() (last engine wins)
            _obs.set_active_quant(self)
        if self.lora is not None:
            _obs.gauge(
                "serving_lora_bank_bytes",
                "device bytes the packed adapter bank occupies "
                "(all rows, every projection, + the scale vector)"
            ).set(self.runner.lora_bank_bytes())
            # lora.json provider for obs.dump() (last engine wins)
            _obs.set_active_lora(self)

    # ------------------------------------------------ runner delegation
    @property
    def decode_traces(self) -> int:
        return self.runner.decode_traces

    @property
    def kpool(self):
        return self.runner.kpool

    @property
    def vpool(self):
        return self.runner.vpool

    # ----------------------------------------------------------- intake
    def submit(self, prompt, gen: GenerationConfig | None = None, *,
               deadline: float | None = None, on_token=None,
               arrival_time: float | None = None, trace=None,
               priority: int = 0, tenant: str | None = None,
               adapter: str | None = None) -> Request:
        """Queue one request.  ``trace`` is an optional
        tracing.SpanContext (or Span) the request's root span is
        parented under — the server passes the extracted
        ``traceparent`` here so the engine-side spans join the caller's
        trace; without it the root span inherits the submitting
        thread's current span, if any.  ``priority`` sets the scheduling
        class (higher admits first and, with preemption on, may preempt
        lower-priority residents).  ``tenant`` is the usage meter's
        billing dimension (default ``"anon"``).  ``adapter`` names a
        LoRA adapter registered with the engine's AdapterStore (None =
        dense); its bank row is pinned from here to the request's
        finalize."""
        req = Request(prompt, gen, deadline=deadline, on_token=on_token,
                      priority=priority, tenant=tenant, adapter=adapter,
                      arrival_time=(self._clock() if arrival_time is None
                                    else arrival_time))
        if req.adapter is not None and self.lora is None:
            raise ValueError(
                f"request names adapter {req.adapter!r} but the engine "
                "was built without lora= (pass an AdapterStore)")
        total = req.prompt.size + req.gen.max_new_tokens
        if total > self.max_model_len:
            raise ValueError(
                f"prompt ({req.prompt.size}) + max_new_tokens "
                f"({req.gen.max_new_tokens}) = {total} exceeds "
                f"max_model_len {self.max_model_len}")
        need = self.blocks.pages_needed(req.prompt.size,
                                        req.gen.max_new_tokens)
        if need > self.blocks.num_pages:
            raise ValueError(
                f"request needs {need} KV pages but the pool only has "
                f"{self.blocks.num_pages}; it could never be admitted "
                "(raise num_pages or lower max_new_tokens)")
        if req.gen.do_sample and not self.emit_logits:
            raise ValueError(
                "do_sample requests need an engine built with "
                "emit_logits=True (host-side sampling reads the logits)")
        # pin the adapter's bank row for the request's whole lifetime
        # (preemption parks KV, never the adapter, so a resume re-enters
        # decode on the same row).  Unknown names KeyError here; a full
        # bank (every row pinned) RuntimeErrors.
        req._adapter_row = (self.lora.acquire(req.adapter)
                            if self.lora is not None else 0)
        req._engine = self
        # spans only after every validation — a rejected submit must not
        # leave dangling open spans
        tr = _obs.tracer()
        attrs = {"req": req.id, "prompt_len": int(req.prompt.size),
                 "max_new_tokens": int(req.gen.max_new_tokens)}
        req.trace_parent = trace
        if trace is not None:
            req.root_span = tr.start_span("request", parent=trace,
                                          attributes=attrs)
        else:
            req.root_span = tr.start_span("request", attributes=attrs)
        req.queue_span = tr.start_span("scheduler.queue_wait",
                                       parent=req.root_span)
        if self.requestlog is not None:
            # after the root span exists so the timeline carries the
            # trace id (the /debug/trace <-> /debug/exemplars join)
            self.requestlog.attach(req)
        try:
            _obs.flight("engine", "submit", req=req.id,
                        prompt_len=int(req.prompt.size),
                        trace=req.root_span.trace_id)
            if self.usage is not None:
                # register BEFORE the scheduler sees the request so any
                # admission-time page holds already attribute to it
                self.usage.on_submit(req)
            self.scheduler.submit(req)
        except BaseException:
            # a rejected submit must not leave the request's spans open
            # in the tracer ring — nor its adapter row pinned
            if self.lora is not None:
                self.lora.release(req.adapter)
            if self.requestlog is not None:
                self.requestlog.discard(req.id)
            req.queue_span.end()
            req.root_span.end()
            raise
        return req

    # -------------------------------------------------------- main loop
    def step(self) -> bool:
        """One engine iteration: evict/admit (scheduler pass), prefill
        admissions, then one lockstep decode step over the active slots.
        Returns whether any work happened."""
        now = self._clock()
        admitted = self.scheduler.schedule(now)
        # chunk states registered by THIS step's admissions already ran
        # their first chunk inside _prefill — snapshot the in-flight set
        # first so each prefill advances exactly one chunk per step
        inflight = list(self._chunking)
        for slot, req in admitted:
            self._prefill(slot, req)
        advanced = 0
        for slot in inflight:
            if slot in self._chunking:      # evicted states drop out
                self._advance_chunk(slot)
                advanced += 1
        active = [i for i, r in enumerate(self.scheduler.slots)
                  if r is not None and r.state == RequestState.DECODE]
        if active:
            self._decode(active)
        else:
            self._prefill_since_decode = 0
        self.current_phase = "idle"
        self.progress += 1          # watchdog heartbeat
        return bool(admitted) or bool(active) or bool(advanced)

    def run_until_complete(self, max_steps: int | None = None):
        """Drive step() until no live or queued work remains."""
        steps = 0
        while self.scheduler.has_work():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"engine did not quiesce within {max_steps} steps")

    def drain(self):
        """Graceful drain: stop admitting; finish what is running.
        Queued requests stay queued until :meth:`resume`."""
        self.scheduler.drain()
        while self.scheduler.active_count:
            self.step()

    def resume(self):
        self.scheduler.resume()

    # ----------------------------------------------------------- prefill
    def _prefill(self, slot: int, req: Request):
        if req.queue_span is not None:      # queue wait ends at admission
            req.queue_span.end()
            req.queue_span = None
        if req.admitted_at is not None:
            # ledger: queue-wait seconds — every wait (first admission
            # and each preemption re-queue) sums into the same field
            req.queue_seconds += max(
                0.0, req.admitted_at - req._queued_since)
            req._queued_since = req.admitted_at
            if req.timeline is not None:
                # a re-queue wait after preemption charges to the
                # preempted bucket
                req.timeline.note(
                    "preempted" if req.num_generated else "queue",
                    req.admitted_at, event="admit", slot=slot,
                    then="prefill_compute")
        if req.num_generated:
            # re-admission of a preempted request: rebuild device KV
            # from the prefix cache + host spill tier + a re-prefill of
            # the remainder; no token is emitted
            self._resume(slot, req)
            return
        self.current_phase = "prefill"
        t0 = time.perf_counter()
        ps = self.page_size
        plen = req.prompt.size
        meta = self.blocks.seq_meta(req.id)
        cached = int(meta["cached_len"])
        row = self.blocks.table_row(req.id, self.table_width)
        if self.prefill_chunk and plen - cached > self.prefill_chunk:
            # chunked admission: CoW once up front, then one chunk per
            # engine step so decoding slots keep stepping in between
            try:
                if meta["cow_src"] is not None:
                    self.runner.copy_page(int(meta["cow_src"]),
                                          int(row[cached // ps]))
            except Exception as e:
                self._note_phase("prefill", time.perf_counter() - t0)
                self._quarantine(slot, req, e, self._clock())
                return
            req.num_cached_tokens = cached
            req.prefill_cached_tokens += cached
            req.prefill_computed_tokens += plen - cached
            self._note_phase("prefill", time.perf_counter() - t0)
            self._begin_chunks(slot, req, req.prompt, cached, row)
            return
        try:
            if meta["cow_src"] is not None:
                # copy-on-write: duplicate the matching tail page into
                # this request's own tail before any writes land there
                self.runner.copy_page(int(meta["cow_src"]),
                                      int(row[cached // ps]))
            if cached == 0:
                bucket = -(-plen // ps) * ps
                ids = np.zeros((1, bucket), np.int32)
                ids[0, :plen] = req.prompt
                logits = self.runner.prefill(
                    ids, plen, row, adapter_row=req._adapter_row)
            else:
                suffix = plen - cached
                bucket = -(-suffix // ps) * ps
                ids = np.zeros((1, bucket), np.int32)
                ids[0, :suffix] = req.prompt[cached:]
                logits = self.runner.prefill_cached(
                    ids, suffix, cached, row,
                    adapter_row=req._adapter_row)
            req.num_cached_tokens = cached
            req.prefill_cached_tokens += cached
            req.prefill_computed_tokens += plen - cached
            self._note_gap(plen - cached)
            _M_HOST_SYNCS.labels("prefill").inc()
            tok = self._pick_token(req, self._fault_logits(
                logits.cpu().numpy()[0], req, slot, "prefill"))
        except Exception as e:
            # a failed prefill kills ONE request, never the process:
            # pages release, the slot parks, the batch keeps running
            self._note_phase("prefill", time.perf_counter() - t0)
            self._quarantine(slot, req, e, self._clock())
            return
        now = self._clock()
        self._ttft.observe(now - req.arrival_time)
        self._note_phase("prefill", time.perf_counter() - t0)
        if req.timeline is not None:
            req.timeline.note_prefill(now, cached=cached,
                                      computed=plen - cached, slot=slot)
        _obs.tracer().record_span(
            "engine.prefill", t0, time.perf_counter(),
            parent=req.root_span,
            attributes={"req": req.id, "slot": slot, "bucket": bucket,
                        "cached_tokens": cached,
                        "kind": "cached_suffix" if cached else "full",
                        "cow": meta["cow_src"] is not None})
        _obs.flight("engine", "prefill", req=req.id, slot=slot,
                    bucket=bucket, cached=cached)
        self._enter_decode(slot, req, row, plen, tok)
        if self._proposer is not None:
            # seed the drafter with the prompt; emitted tokens extend
            # the history through _emit
            self._proposer.register(req.id, req.prompt)
        self._emit(slot, req, tok, now)

    def _fault_logits(self, row: np.ndarray, req: Request, slot: int,
                      phase: str) -> np.ndarray:
        """The ``nan_logits`` chaos site: a firing poisons this row."""
        if (self.faults is not None
                and self.faults.check("nan_logits", req=req.id, slot=slot,
                                      phase=phase) is not None):
            return np.full_like(row, np.nan)
        return row

    # --------------------------------------------------- chunked prefill
    def _note_gap(self, tokens: int):
        """Account ``tokens`` prompt tokens prefilled since the last
        decode step (the overload-degradation witness)."""
        self._prefill_since_decode += int(tokens)
        if self._prefill_since_decode > self.max_prefill_gap:
            self.max_prefill_gap = self._prefill_since_decode

    def _begin_chunks(self, slot: int, req: Request, ids_all, done: int,
                      row, *, resume_tok: int | None = None):
        """Arm chunked prefill for ``slot`` and run its first chunk.
        ``resume_tok`` marks a preempted-request resume — the final
        chunk's logits are discarded and decode re-enters with that
        token instead of sampling a new one."""
        self._chunking[slot] = {
            "req": req, "ids": np.asarray(ids_all, np.int32).reshape(-1),
            "done": int(done), "row": row, "resume_tok": resume_tok,
            "chunks": 0, "t0": time.perf_counter()}
        self._advance_chunk(slot)

    def _advance_chunk(self, slot: int):
        """Run ONE prefill chunk for an in-flight admission.  Chunk K
        attends chunks 1..K-1 through the cached prefill; intermediate
        chunks never fetch logits, so they cost no host sync."""
        st = self._chunking[slot]
        req = st["req"]
        if req.timeline is not None:
            # time since the last chunk (decode steps for other slots
            # ran in between) is this request's chunk-gap cost
            req.timeline.note("chunk_gap", self._clock(),
                              then="prefill_compute")
        ids_all = st["ids"]
        n = int(ids_all.size)
        done = st["done"]
        this = min(self.prefill_chunk, n - done)
        last = done + this >= n
        ps = self.page_size
        self.current_phase = "prefill_chunk"
        t0 = time.perf_counter()
        try:
            bucket = -(-this // ps) * ps
            ids = np.zeros((1, bucket), np.int32)
            ids[0, :this] = ids_all[done:done + this]
            if done == 0:
                logits = self.runner.prefill(
                    ids, this, st["row"], adapter_row=req._adapter_row)
            else:
                logits = self.runner.prefill_cached(
                    ids, this, done, st["row"],
                    adapter_row=req._adapter_row)
            st["chunks"] += 1
            self.prefill_chunks += 1
            req.prefill_chunks += 1
            _M_CHUNKS.inc()
            self._note_gap(this)
            if not last:
                st["done"] = done + this
                self._note_phase("prefill", time.perf_counter() - t0)
                if req.timeline is not None:
                    req.timeline.note(
                        "prefill_compute", self._clock(), event="chunk",
                        slot=slot, done=done + this, total=n,
                        then="chunk_gap")
                _obs.flight("engine", "prefill_chunk", req=req.id,
                            slot=slot, done=done + this, total=n)
                return
            if st["resume_tok"] is None:
                # admission: the first output token comes from the final
                # chunk's last-position logits
                _M_HOST_SYNCS.labels("prefill").inc()
                tok = self._pick_token(req, self._fault_logits(
                    logits.cpu().numpy()[0], req, slot, "prefill"))
            else:
                # resume: the last emitted token re-enters as the next
                # decode input; the replay logits are discarded
                tok = int(st["resume_tok"])
        except Exception as e:
            self._note_phase("prefill", time.perf_counter() - t0)
            self._chunking.pop(slot, None)
            self._quarantine(slot, req, e, self._clock())
            return
        self._chunking.pop(slot, None)
        # the full chunked prefix is device-resident now — register it
        # in the prefix-cache chain (deferred at allocate_seq)
        self.blocks.publish_seq(req.id, ids_all, adapter=req.adapter)
        now = self._clock()
        self._note_phase("prefill", time.perf_counter() - t0)
        if req.timeline is not None:
            req.timeline.note("prefill_compute", now, event="chunk",
                              slot=slot, done=n, total=n,
                              chunks=st["chunks"], then="decode")
        _obs.tracer().record_span(
            "engine.prefill", st["t0"], time.perf_counter(),
            parent=req.root_span,
            attributes={"req": req.id, "slot": slot,
                        "chunks": st["chunks"],
                        "cached_tokens": req.num_cached_tokens,
                        "kind": "chunked",
                        "resume": st["resume_tok"] is not None})
        _obs.flight("engine", "prefill", req=req.id, slot=slot,
                    chunks=st["chunks"], cached=req.num_cached_tokens)
        self._enter_decode(slot, req, st["row"], n, tok)
        if st["resume_tok"] is None:
            self._ttft.observe(now - req.arrival_time)
            if self._proposer is not None:
                self._proposer.register(req.id, req.prompt)
            self._emit(slot, req, tok, now)
        elif self._proposer is not None:
            self._proposer.register(req.id, np.append(ids_all, tok))

    def _enter_decode(self, slot: int, req: Request, row, pos: int,
                      tok: int):
        """Flip an admitted request into decode: patch the slot mirrors
        + the device row, open the decode span."""
        self.table[slot] = row
        self._pos[slot] = pos
        self._tok[slot] = tok
        self._active[slot] = 1
        self._aidx[slot] = req._adapter_row
        self._push_slot(slot)
        req.state = RequestState.DECODE
        if req.root_span is not None:
            req.decode_span = _obs.tracer().start_span(
                "engine.decode", parent=req.root_span,
                attributes={"req": req.id, "slot": slot})

    # -------------------------------------------------------- preemption
    def _preempt(self, slot: int) -> bool:
        """Scheduler callback behind preempt-and-swap: spill ``slot``'s
        exclusive committed KV pages to the BlockManager host tier,
        release its pages (complete chunks re-register in the prefix-
        cache chain when the cache is on), and park the slot.  Returns
        False — victim untouched, preemption aborted — when a page copy
        fails (the ``spill_fail`` chaos site); parked copies from the
        aborted attempt are discarded, so the pool census stays exact."""
        req = self.scheduler.slots[slot]
        if req is None or req.state != RequestState.DECODE:
            return False
        t0 = time.perf_counter()
        if req.timeline is not None:
            # decoding ends here; the spill loop below (and, if the
            # preemption lands, the re-queue wait and the restore)
            # charges to the preempted bucket
            req.timeline.note("decode", self._clock(), then="preempted")
        tokens = req.resume_tokens()
        parked: list[str] = []
        for page, digest in self.blocks.spill_plan(req.id, tokens,
                                                   req.adapter):
            if (self.faults is not None
                    and self.faults.check("spill_fail", req=req.id,
                                          page=page) is not None):
                self.blocks.host_discard(parked)
                self.spill_aborts += 1
                if req.timeline is not None:
                    # the aborted spill attempt was still preemption
                    # cost; the request goes back to decoding
                    req.timeline.note("preempted", self._clock(),
                                      event="spill_abort", slot=slot,
                                      then="decode")
                _obs.flight("engine", "spill_abort", req=req.id,
                            slot=slot, page=page,
                            parked_dropped=len(parked))
                return False
            arrays = self.runner.read_page(page)
            self.blocks.host_put(digest, *arrays)
            # ledger: charged per page parked, mirroring host_put's
            # global counters (an abort on a LATER page keeps both) —
            # int8 pages park (k, v, kscale, vscale)
            req.spilled_pages += 1
            req.spill_bytes += sum(a.nbytes for a in arrays)
            if self.usage is not None:
                self.usage.on_host_park(req, digest)
            parked.append(digest)
        self.blocks.release_preempted(req.id, tokens, adapter=req.adapter)
        self._park(slot)
        # the victim's unsynced ring rows die with its slot: the resume
        # recomputes those tokens, and a resume before the next sync
        # must not emit them as well (the reference keeps the rows, and
        # emits them again when the victim is back in DECODE by then)
        self._pending = [(ridx, [(s, r) for s, r in entries if r is not req],
                          drafts) for ridx, entries, drafts in self._pending]
        self.preemptions += 1
        # back to the queue: the ledger's queue-wait anchor restarts so
        # queue_seconds sums this wait too
        req._queued_since = self._clock()
        if req.timeline is not None:
            req.timeline.note("preempted", req._queued_since,
                              event="preempt", slot=slot,
                              pages=len(parked), then="preempted")
        if self._proposer is not None:
            self._proposer.drop(req.id)  # resume re-registers history
        if req.decode_span is not None:
            req.decode_span.set_attribute("preempted", True)
            req.decode_span.set_attribute("generated", req.num_generated)
            req.decode_span.end()
            req.decode_span = None
        if req.root_span is not None:
            # back to the queue: a fresh queue-wait span covers the
            # time until re-admission
            req.queue_span = _obs.tracer().start_span(
                "scheduler.queue_wait", parent=req.root_span,
                attributes={"resume": True})
        _obs.tracer().record_span(
            "engine.preempt_spill", t0, time.perf_counter(),
            parent=req.root_span,
            attributes={"req": req.id, "slot": slot,
                        "pages": len(parked)})
        _obs.flight("engine", "preempt_spill", req=req.id, slot=slot,
                    pages=len(parked))
        return True

    def _resume(self, slot: int, req: Request):
        """Re-admit a preempted request.  Its effective prompt is
        prompt + generated-so-far; device KV rebuilds from, in order,
        the prefix-cache match recorded at allocate_seq, the host spill
        tier (page-granular, content-addressed), and a re-prefill of
        whatever remains — then decode continues with the last emitted
        token as the next input, token-for-token identical to an
        uninterrupted greedy run."""
        self.current_phase = "prefill"
        t0 = time.perf_counter()
        ps = self.page_size
        if self.usage is not None:
            # this request is no longer waiting on its parked pages —
            # per-request host-tier accrual stops here (the tenant keeps
            # paying until the digests fall out of the host LRU)
            self.usage.on_host_release(req)
        tokens = req.resume_tokens()
        ids_all = tokens[:-1]
        n = int(ids_all.size)
        meta = self.blocks.seq_meta(req.id)
        # ledger: the uncapped match length is what allocate_seq added
        # to the global cached_tokens counter for this resume
        req.prefill_cached_tokens += int(meta["cached_len"])
        cached = min(int(meta["cached_len"]), n)
        row = self.blocks.table_row(req.id, self.table_width)
        restored = 0
        try:
            if meta["cow_src"] is not None:
                # tail CoW page from the admission match: duplicate it
                # before any writes land (same rule as fresh admission)
                self.runner.copy_page(int(meta["cow_src"]),
                                      int(row[cached // ps]))
            else:
                # host-tier unpark: extend coverage page by page past
                # the cache match while parked complete chunks exist
                while cached % ps == 0 and cached + ps <= n:
                    c = cached // ps
                    entry = self.blocks.host_get(self.blocks.spill_digest(
                        tokens, c, req.adapter))
                    if entry is None:
                        break
                    self.runner.write_page(int(row[c]), *entry)
                    self.blocks.note_restored()
                    req.restored_pages += 1
                    req.restore_bytes += sum(a.nbytes for a in entry)
                    restored += 1
                    cached += ps
        except Exception as e:
            self._note_phase("prefill", time.perf_counter() - t0)
            self._quarantine(slot, req, e, self._clock())
            return
        suffix = n - cached
        tok = int(tokens[-1])
        # ledger: the re-prefilled remainder runs on the device (chunked
        # or single-shot alike)
        req.prefill_computed_tokens += suffix
        if self.prefill_chunk and suffix > self.prefill_chunk:
            # a long replay suffix chunks exactly like a long prompt
            self._note_phase("prefill", time.perf_counter() - t0)
            if req.timeline is not None:
                # restore work so far charges to preempted; the chunked
                # re-prefill accounts like any chunked admission
                req.timeline.note("preempted", self._clock(),
                                  event="resume", slot=slot,
                                  restored=restored, cached=cached,
                                  chunked=True, then="prefill_compute")
            _obs.flight("engine", "resume", req=req.id, slot=slot,
                        tokens=n, cached=cached, restored=restored,
                        chunked=True)
            self._begin_chunks(slot, req, ids_all, cached, row,
                               resume_tok=tok)
            return
        try:
            if suffix > 0:
                bucket = -(-suffix // ps) * ps
                ids = np.zeros((1, bucket), np.int32)
                ids[0, :suffix] = ids_all[cached:]
                if cached == 0:
                    self.runner.prefill(ids, suffix, row,
                                        adapter_row=req._adapter_row)
                else:
                    self.runner.prefill_cached(
                        ids, suffix, cached, row,
                        adapter_row=req._adapter_row)
                self._note_gap(suffix)
            # the resume logits are discarded (the last token is
            # already known) — no host sync happens here
        except Exception as e:
            self._note_phase("prefill", time.perf_counter() - t0)
            self._quarantine(slot, req, e, self._clock())
            return
        # allocate_seq defers on plen while the chunk test above uses
        # the replay suffix, so a resume can be deferred yet single-shot
        # — publish here too (no-op when registration wasn't deferred)
        self.blocks.publish_seq(req.id, ids_all, adapter=req.adapter)
        now = self._clock()
        self._note_phase("prefill", time.perf_counter() - t0)
        if req.timeline is not None:
            req.timeline.note("preempted", now, event="resume",
                              slot=slot, restored=restored,
                              cached=cached, then="decode")
        self._enter_decode(slot, req, row, n, tok)
        if self._proposer is not None:
            self._proposer.register(req.id, tokens)
        _obs.tracer().record_span(
            "engine.resume", t0, time.perf_counter(),
            parent=req.root_span,
            attributes={"req": req.id, "slot": slot, "tokens": n,
                        "cached_tokens": cached,
                        "restored_pages": restored})
        _obs.flight("engine", "resume", req=req.id, slot=slot,
                    tokens=n, cached=cached, restored=restored)

    # ------------------------------------------------------------ decode
    def _decode(self, active: list[int]):
        self.current_phase = "decode"
        if self.faults is not None:
            f = self.faults.check("slow_step", step=self.decode_steps)
            if f is not None:
                time.sleep(float(f.get("seconds", 0.05)))
            # raise BEFORE any dispatch, so recovery sees a consistent
            # host mirror
            if self.faults.check("step_raise",
                                 step=self.decode_steps) is not None:
                raise InjectedFault(
                    f"injected poisoned decode step "
                    f"(step {self.decode_steps})")
        if self._seg_span is None:
            # one span per host-sync interval, NOT per device step —
            # segments are the engine's visible unit of decode work
            self._seg_span = _obs.tracer().start_span(
                "engine.decode_segment", parent=None,
                attributes={"slots": len(active)})
            self._seg_steps = 0
        self._seg_steps += 1
        reqs = [(s, self.scheduler.slots[s]) for s in active]
        drafts = self._propose(reqs)
        if drafts:
            self._decode_spec(reqs, drafts)
            return
        step_t0 = time.perf_counter()
        logits = self.runner.decode_step()
        self._note_phase("decode", time.perf_counter() - step_t0)
        self.decode_steps += 1
        self._prefill_since_decode = 0      # gap witness: decode ran
        _M_STEPS.inc()
        self._pages_hist.observe(self.blocks.pages_in_use)
        for slot in active:
            self._pos[slot] += 1            # mirror of pos + active
        self._pending.append((self._ring_cursor, reqs, None))
        self._ring_cursor = (self._ring_cursor + 1) % self.sync_interval
        self._last_logits = logits
        # any active sampling request needs its token fed back before
        # the next step, so sampling degrades to a per-step sync
        eff = 1 if any(r.gen.do_sample for _, r in reqs) \
            else self.sync_interval
        if len(self._pending) >= eff:
            self._sync()

    def _propose(self, reqs) -> dict:
        """Collect this step's drafts: ``{slot: [tokens]}``.  Empty —
        take the plain step — when speculation is off, when unsynced
        ring rows are outstanding (the drafter indexes only tokens the
        host has seen; a verify step always syncs immediately, so the
        mirrors it needs are exact), or when an active request samples
        (greedy verification only)."""
        if (self._proposer is None or self._pending
                or any(r.gen.do_sample for _, r in reqs)):
            return {}
        drafts = {}
        for slot, req in reqs:
            # cap so even a fully-accepted draft commits at most the
            # tokens the request may still emit, keeping every KV write
            # inside the admission reservation
            cap = req.gen.max_new_tokens - req.num_generated - 1
            if cap <= 0:
                continue
            ds = self._proposer.propose(req.id, cap)
            if ds:
                drafts[slot] = ds
        return drafts

    def _decode_spec(self, reqs, drafts: dict):
        """One verify step: upload the draft grid, score k+1 positions
        per slot, then sync immediately — acceptance needs the ring row
        before the next proposal anyway, and the step commits up to k+1
        tokens, so the sync amortizes like deferred plain steps."""
        self.current_phase = "verify"
        draft_arr = np.zeros((self.max_slots, self.spec_k), np.int32)
        dlen = np.zeros((self.max_slots,), np.int32)
        for slot, ds in drafts.items():
            draft_arr[slot, :len(ds)] = ds
            dlen[slot] = len(ds)
        step_t0 = time.perf_counter()
        self.runner.verify_step(draft_arr, dlen)
        self._note_phase("decode", time.perf_counter() - step_t0)
        self.decode_steps += 1
        self._prefill_since_decode = 0      # gap witness: decode ran
        _M_STEPS.inc()
        self._spec.record_step()
        self._pages_hist.observe(self.blocks.pages_in_use)
        # speculative multi-token append: charge the whole candidate
        # span now; the rejected suffix rolls back at the sync below
        for slot, req in reqs:
            ds = drafts.get(slot)
            if ds:
                self.blocks.append(req.id, len(ds) + 1)
        self._pending.append((self._ring_cursor, reqs, drafts))
        self._ring_cursor = (self._ring_cursor + 1) % self.sync_interval
        self._last_logits = None
        self._sync()

    def _sync(self):
        """Drain the device token ring: ONE [sync_interval, slots] int32
        transfer covers every decode step since the previous sync."""
        self.current_phase = "host_sync"
        sync_t0 = time.perf_counter()
        ring = self.runner.fetch_ring()
        sync_s = time.perf_counter() - sync_t0
        self.host_syncs += 1
        self._note_phase("host_sync", sync_s)
        _M_HOST_SYNCS.labels("ring").inc()
        poll = int(FLAGS.get("FLAGS_resource_memory_poll_steps") or 0)
        if poll > 0 and self.host_syncs % poll == 0:
            resource_tracker().sample_memory()
        # wide-ring rows: [slots, k+1] candidate grids (speculation on);
        # narrow rows: [slots] sampled tokens.  Re-derive each verify
        # row's acceptance from the drafts the host already holds — the
        # same integer comparison the device ran, no extra transfer.
        wide = ring.ndim == 3
        accepted: dict[int, tuple[int, int]] = {}
        for ridx, entries, drafts in self._pending:
            if drafts is None:
                continue
            for slot, req in entries:
                if req.is_finished() or req.state != RequestState.DECODE:
                    continue
                a = 0
                for j, d in enumerate(drafts.get(slot, ())):
                    if int(ring[ridx, slot, j]) != int(d):
                        break
                    a += 1
                accepted[slot] = (len(drafts.get(slot, ())), a)
        if self._seg_span is not None:
            # the ring fetch above blocked on the device — the segment
            # span ends here, covering dispatch through host sync
            self._seg_span.set_attribute("steps", self._seg_steps)
            if accepted:
                self._seg_span.set_attribute(
                    "spec_proposed", sum(p for p, _ in accepted.values()))
                self._seg_span.set_attribute(
                    "spec_accepted", sum(a for _, a in accepted.values()))
            self._seg_span.end()
            self._seg_span = None
        _obs.flight("engine", "host_sync", rows=len(self._pending),
                    steps=self._seg_steps, sync_s=round(sync_s, 6))
        sample_t0 = None
        logits_np = None
        now = self._clock()
        n_rows = len(self._pending)
        if self.requestlog is not None:
            # one timeline charge per live request per sync: decode
            # dispatch up to the blocking ring fetch, then the sync
            # itself — overlapping requests each experience the full
            # wall interval, so per-request conservation still holds
            seen: set[int] = set()
            for _, entries, _ in self._pending:
                for _slot, _req in entries:
                    if (_req.id in seen or _req.is_finished()
                            or _req.state != RequestState.DECODE
                            or _req.timeline is None):
                        continue
                    seen.add(_req.id)
                    _req.timeline.note_sync(now, sync_s)
        corrections = []
        for row_i, (ridx, entries, drafts) in enumerate(self._pending):
            for slot, req in entries:
                if req.is_finished() or req.state != RequestState.DECODE:
                    continue        # evicted/finished: overrun discarded
                if drafts is not None:
                    self._accept(slot, req, ring[ridx, slot],
                                 *accepted[slot], now)
                    continue
                tok = raw = int(ring[ridx, slot, 0]) if wide \
                    else int(ring[ridx, slot])
                if req.gen.do_sample:
                    # sampling rows only exist under eff-interval 1, so
                    # the step's logits are always the right row
                    if logits_np is None:
                        sample_t0 = time.perf_counter()
                        logits_np = self._last_logits.cpu().numpy()
                        self.logit_fetches += 1
                        _M_HOST_SYNCS.labels("logits").inc()
                    try:
                        tok = self._pick_token(req, self._fault_logits(
                            logits_np[slot], req, slot, "decode"))
                    except NonFiniteLogitsError as e:
                        # fail ONLY the offending request — the other
                        # slots in this sync keep their tokens
                        self._quarantine(slot, req, e, now)
                        continue
                    if tok != raw:
                        corrections.append((slot, tok))
                prev = req.last_token_at
                if prev is not None:
                    # batched sync: spread the interval over the tokens
                    # it covers so TPOT keeps per-token semantics
                    self._tpot.observe((now - prev) / (n_rows - row_i))
                self._tok[slot] = tok
                self._emit(slot, req, tok, now)
        self._pending.clear()
        if sample_t0 is not None:
            # host-side sampling for this sync: logits fetch + per-
            # request pick (argmax/top-k/top-p) + any device feedback
            _obs.tracer().record_span(
                "engine.sample", sample_t0, time.perf_counter(),
                attributes={"corrections": len(corrections)})
        if corrections:
            self.runner.correct_tokens(corrections)

    def _accept(self, slot: int, req: Request, row, proposed: int,
                a: int, now: float):
        """Commit one verify-row slot: roll back the rejected draft
        suffix (the ledger then charges pages for accepted tokens
        only), advance the pos mirror by the accepted prefix + the
        correction/bonus token, and emit those ``a + 1`` tokens in
        order — stopping at max_new/EOS exactly where sequential decode
        would have stopped."""
        if proposed:
            self.blocks.rollback(req.id, proposed - a)
            self._spec.record(proposed, a)
            req.spec_proposed_tokens += proposed
            req.spec_accepted_tokens += a
        self._pos[slot] += a + 1        # mirror of pos + (acc+1)*active
        prev = req.last_token_at
        dt = None if prev is None else (now - prev) / (a + 1)
        for j in range(a + 1):
            tok = int(row[j])
            if dt is not None:
                # one verify step emitted a+1 tokens: spread the
                # interval so TPOT keeps per-token semantics
                self._tpot.observe(dt)
            self._tok[slot] = tok
            # drafted slots were charged up front at dispatch;
            # ride-along slots (no draft) charge per emit as usual
            self._emit(slot, req, tok, now, charge=proposed == 0)
            if req.is_finished():
                break

    def _note_phase(self, phase: str, seconds: float):
        """Charge engine wall time to a phase: the per-engine mirror,
        the serving_step_phase_seconds_total counter, and the process
        tracker's throughput denominator."""
        seconds = max(float(seconds), 0.0)
        self.timings[phase + "_s"] += seconds
        _M_PHASE_SECONDS.labels(phase).inc(seconds)
        resource_tracker().note_phase(phase, seconds)

    def _emit(self, slot: int, req: Request, tok: int, now: float,
              charge: bool = True):
        if req.timeline is not None and req.first_token_at is None:
            req.timeline.mark("first_token", now)   # the TTFT moment
        req._emit(tok, now)
        _M_TOKENS.inc()
        resource_tracker().note_tokens(1)
        if charge:
            # committed-token ledger: one durable token per emit (the
            # speculative path charges its whole span at dispatch and
            # rolls the rejected suffix back instead)
            self.blocks.append(req.id, 1)
        if self._proposer is not None:
            self._proposer.extend(req.id, tok)
        eos = req.gen.eos_token_id
        if req.num_generated >= req.gen.max_new_tokens:
            self._finalize(req, "length", now)
            self.scheduler.evict(slot, "finished", now)
        elif eos is not None and tok == eos:
            self._finalize(req, "eos", now)
            self.scheduler.evict(slot, "finished", now)

    def _park(self, slot: int):
        """Return a slot to the idle state: all writes/reads go to the
        dump page until the next admission."""
        # an eviction mid-chunked-prefill abandons the chunk state (the
        # pages are gone; the request was finalized by the scheduler)
        self._chunking.pop(slot, None)
        self.table[slot] = self.blocks.empty_row(self.table_width)
        self._pos[slot] = 0
        self._tok[slot] = 0
        self._active[slot] = 0
        self._aidx[slot] = 0
        self._push_slot(slot)

    def _push_slot(self, slot: int):
        """Patch ONE slot's row of the device-resident decode state from
        the host mirrors (admission / eviction only — never per step)."""
        self.runner.push_slot(slot, self.table[slot],
                              int(self._pos[slot]), int(self._tok[slot]),
                              int(self._active[slot]),
                              adapter_row=int(self._aidx[slot]))

    # --------------------------------------------------------- sampling
    def _pick_token(self, req: Request, logits: np.ndarray) -> int:
        g = req.gen
        if not g.do_sample:
            # argmax over NaN silently returns the NaN's index — poisoned
            # logits must fail loudly, not emit a garbage token
            if np.isnan(logits).any() or not np.isfinite(logits).any():
                raise NonFiniteLogitsError(
                    f"request {req.id}: non-finite logits from the "
                    "model (greedy decode)")
            return int(np.argmax(logits))
        rng = self._rngs.get(req.id)
        if rng is None:
            rng = self._rngs[req.id] = np.random.default_rng(
                (g.seed, req.id))
        logits = logits.astype(np.float64)
        if g.temperature != 1.0:
            logits = logits / max(g.temperature, 1e-6)
        if g.top_k and g.top_k > 0:
            k = min(g.top_k, logits.size)
            kth = np.sort(logits)[-k]
            logits = np.where(logits < kth, -np.inf, logits)
        if g.top_p < 1.0:
            order = np.argsort(logits)[::-1]
            probs = _softmax(logits[order])
            cum = np.cumsum(probs)
            cutoff_idx = int(np.sum(cum < g.top_p))
            cutoff = logits[order[min(cutoff_idx, logits.size - 1)]]
            logits = np.where(logits < cutoff, -np.inf, logits)
        if not np.isfinite(logits).any():
            raise NonFiniteLogitsError(
                f"request {req.id}: no finite logits to sample from — "
                "the model emitted non-finite logits (or top_k/top_p "
                "masked every candidate)")
        return int(rng.choice(logits.size, p=_softmax(logits)))

    # -------------------------------------------------------- lifecycle
    def _finalize(self, req: Request, reason: str, now: float):
        if req.is_finished():
            return
        req.finish_reason = reason
        req.state = RequestState.CANCELLED \
            if reason in ("cancelled", "deadline") else RequestState.DONE
        req.finished_at = now
        if self.lora is not None:
            # unpin the bank row (acquired at submit); the weights stay
            # resident until LRU pressure evicts them
            self.lora.release(req.adapter)
        self._rngs.pop(req.id, None)
        if self._proposer is not None:
            self._proposer.drop(req.id)
        self._e2e.observe(now - req.arrival_time)
        _M_REQUESTS.labels(reason).inc()
        _M_FINISH.labels(reason).inc()
        resource_tracker().note_finish(reason, req.num_generated)
        if self.requestlog is not None:
            # close the timeline (residual charge + conservation check)
            # BEFORE slo.observe, so a violation exemplar snapshots the
            # finished attribution, not a half-charged one
            self.requestlog.on_finish(req, reason, now)
        if self.slo is not None:
            self.slo.observe(req, now)
        if self.usage is not None:
            # after slo.observe so per-tenant verdicts land first; the
            # page-seconds accumulator folds when the pages release
            self.usage.on_finish(req, reason, now)
        _obs.flight("engine", "finish", req=req.id, reason=reason,
                    generated=req.num_generated)
        if req.queue_span is not None:      # dropped while still queued
            req.queue_span.set_attribute("dropped", True)
            req.queue_span.end()
            req.queue_span = None
        if req.decode_span is not None:
            req.decode_span.set_attribute("generated", req.num_generated)
            req.decode_span.end()
            req.decode_span = None
        if req.root_span is not None:
            rs = req.root_span
            rs.set_attribute("finish_reason", reason)
            rs.set_attribute("generated", req.num_generated)
            rs.set_attribute("cached_tokens", req.num_cached_tokens)
            if reason == "deadline" and req.deadline is not None:
                # how far past its deadline the request was when the
                # scheduler finally evicted it (engine clock)
                rs.set_attribute("deadline_overrun_s",
                                 round(now - req.deadline, 6))
            rs.end()

    # -------------------------------------------------------- self-healing
    def _quarantine(self, slot: int, req: Request, why, now: float):
        """Fail ONE request in place: finish_reason='error', pages
        released, slot parked — the batch keeps running.  The failure
        detail lands on ``req.error``."""
        req.error = str(why)
        self.quarantines += 1
        _M_RECOVERY.labels("quarantine").inc()
        _obs.flight("engine", "quarantine", req=req.id, slot=slot,
                    error=str(why)[:160])
        self._finalize(req, "error", now)
        self.scheduler.evict(slot, "error", now)

    def recover(self) -> dict:
        """Rebuild the ModelRunner after a poisoned step and replay
        every in-flight request.

        The BlockManager is entirely host-side, so page ownership, block
        tables and the committed-token ledger all survive — only the
        device KV *content* is gone.  Each DECODE-state request re-runs
        its committed tokens (prompt + generated so far, minus the last
        token, which re-enters as the next decode input) through the
        prefill path; the prefix-cache chain is flushed first (it
        described dead KV) and re-registered by the replays themselves,
        so sequences sharing prefix pages replay the shared part once.
        Requests that cannot be replayed are quarantined.  The dead
        runner's pools are freed before the new runner allocates its
        own, so a full-size pool is never held twice.  Typically called
        by the :class:`~.supervisor.EngineSupervisor`, not user code."""
        now = self._clock()
        t0 = time.perf_counter()
        if self._seg_span is not None:
            self._seg_span.set_attribute("aborted", True)
            self._seg_span.end()
            self._seg_span = None
        self._seg_steps = 0
        # drop un-synced device state: the ring rows and logits belong
        # to the dead runner (the pos mirrors they would have advanced
        # are recomputed from request state below)
        self._pending.clear()
        self._ring_cursor = 0
        self._last_logits = None
        flushed = self.blocks.flush_prefix_cache()
        # on a failed rebuild the released runner stays in place: its
        # decode-state rows still take the quarantines' slot parks
        self.runner.release()
        self.runner = self._new_runner()
        if self.lora is not None:
            # the fresh runner's bank is zeroed — re-upload every
            # resident adapter before any replayed prefill reads it
            self.lora.attach(self.runner)
        replayed = 0
        for slot, req in enumerate(self.scheduler.slots):
            if req is None:
                self._park(slot)        # sync the fresh decode state
                continue
            if req.state != RequestState.DECODE or not req.output_tokens:
                self._quarantine(slot, req,
                                 "not replayable at runner rebuild", now)
                continue
            try:
                self._replay(slot, req)
                replayed += 1
                self.replayed_requests += 1
            except Exception as e:
                self._quarantine(slot, req, f"replay failed: {e}", now)
        self.recoveries += 1
        _obs.flight("engine", "recover", replayed=replayed,
                    flushed_cached_pages=flushed)
        _obs.tracer().record_span(
            "engine.recover", t0, time.perf_counter(),
            attributes={"replayed": replayed,
                        "flushed_cached_pages": flushed})
        return {"replayed": replayed, "flushed_cached_pages": flushed}

    def _replay(self, slot: int, req: Request):
        """Re-prefill one in-flight request's committed tokens into the
        rebuilt runner.  Restores the decode invariant exactly: device
        KV covers positions ``0..pos-1`` where ``pos = prompt +
        generated - 1``, and the last generated token re-enters as the
        next step's input — decode then continues token-for-token as if
        the fault never happened."""
        self.current_phase = "prefill"
        t0 = time.perf_counter()
        tokens = [int(t) for t in req.prompt] + list(req.output_tokens)
        ids_all = tokens[:-1]
        n = len(ids_all)
        plan = self.blocks.replay_plan(req.id, ids_all, adapter=req.adapter)
        cached = int(plan["cached_len"])
        # ledger: recovery replays re-run committed tokens; the cache
        # match mirrors replay_plan's global cached_tokens bump
        req.replays += 1
        req.prefill_cached_tokens += cached
        req.prefill_computed_tokens += n - cached
        row = self.blocks.table_row(req.id, self.table_width)
        ps = self.page_size
        if cached == 0:
            bucket = -(-n // ps) * ps
            ids = np.zeros((1, bucket), np.int32)
            ids[0, :n] = ids_all
            self.runner.prefill(ids, n, row, adapter_row=req._adapter_row)
        else:
            suffix = n - cached
            bucket = -(-suffix // ps) * ps
            ids = np.zeros((1, bucket), np.int32)
            ids[0, :suffix] = ids_all[cached:]
            self.runner.prefill_cached(ids, suffix, cached, row,
                                       adapter_row=req._adapter_row)
        # the replay's logits are discarded (the last token is already
        # known), so no host sync happens here
        drift = self.blocks.committed_tokens(req.id) - len(tokens)
        if drift > 0:
            # a fault between a speculative dispatch and its sync left
            # uncommitted draft positions charged — roll them back
            self.blocks.rollback(req.id, drift)
        self.table[slot] = row
        self._pos[slot] = n
        self._tok[slot] = tokens[-1]
        self._active[slot] = 1
        self._aidx[slot] = req._adapter_row
        self._push_slot(slot)
        self._note_phase("prefill", time.perf_counter() - t0)
        if req.timeline is not None:
            # everything since the last charge — the poisoned step, the
            # runner rebuild's share, and this replay — was recovery
            req.timeline.note("recovery", self._clock(), event="replay",
                              slot=slot, tokens=n, cached=cached,
                              then="decode")
        _obs.tracer().record_span(
            "engine.replay", t0, time.perf_counter(),
            parent=req.root_span,
            attributes={"req": req.id, "slot": slot, "tokens": n,
                        "cached_tokens": cached})
        _obs.flight("engine", "replay", req=req.id, slot=slot,
                    tokens=n, cached=cached)

    def _new_runner(self):
        """The device half: the single-device runner at tp=1, else rank
        0's runner of the live mesh of ``tp`` ranks (the workers build
        their shards of it; a failed mesh gives way to new workers)."""
        if self.tp == 1:
            return ModelRunner(self.config, self.state, **self._runner_kw)
        return MeshRunner(self.config, self.state,
                          mesh=get_mesh(self.tp, self.device),
                          **self._runner_kw)

    def close(self):
        """Release the runner's device memory; at tp > 1 also stop the
        mesh's workers (an engine built later starts new ones), a failed
        mesh's included."""
        self.runner.release()
        if self.tp > 1:
            self.runner._mesh.close()

    # -------------------------------------------------------------- info
    def stats(self) -> dict:
        b = self.blocks
        spec = {"spec_k": self.spec_k,
                "verify_traces": self.runner.verify_traces}
        if self._spec is not None:
            spec.update(self._spec.snapshot())
        return {
            **spec,
            "queued": len(self.scheduler.queue),
            "active": self.scheduler.active_count,
            "pages_in_use": b.pages_in_use,
            "pages_total": b.num_pages,
            "decode_traces": self.decode_traces,
            "prefill_buckets": sorted(self.runner.prefill_buckets),
            "cached_prefill_buckets": sorted(
                self.runner.cached_prefill_buckets),
            "prefix_hits": b.prefix_hits,
            "prefix_misses": b.prefix_misses,
            "prefix_evictions": b.prefix_evictions,
            "cow_copies": b.cow_copies,
            "cached_tokens": b.cached_tokens,
            "cached_pages": b.cached_pages,
            "host_syncs": self.host_syncs,
            "logit_fetches": self.logit_fetches,
            "decode_steps": self.decode_steps,
            "pages_allocated": b.pages_allocated,
            "prefill_chunk": self.prefill_chunk,
            "prefill_chunks": self.prefill_chunks,
            "max_prefill_gap": self.max_prefill_gap,
            "preemptions": self.preemptions,
            "spill_aborts": self.spill_aborts,
            "spilled_pages": b.spilled_pages,
            "restored_pages": b.restored_pages,
            "spill_bytes": b.spill_bytes,
            "host_parked_pages": b.host_parked,
            "mesh_tp": self.tp,
            "quant": self.quant,
            "kv_quant": self.kv_quant,
            "lora": (self.lora.snapshot()
                     if self.lora is not None else None),
            "timings": {k: round(v, 6) for k, v in self.timings.items()},
            "progress": self.progress,
            "slo": self.slo.stats() if self.slo is not None else None,
            "recoveries": self.recoveries,
            "quarantines": self.quarantines,
            "replayed_requests": self.replayed_requests,
            "faults_injected": (dict(self.faults.injected)
                                if self.faults is not None else {}),
        }

    def _page_bytes(self, *, dense: bool = False) -> int:
        """Bytes one KV page pair (k + v, all layers and heads)
        occupies — the unit every spill/restore moves.  Under
        ``kv_quant`` that is the int8 elements plus the per-(page-row,
        head) f32 scale rows; ``dense=True`` prices the same page at the
        checkpoint dtype (the savings baseline)."""
        cfg = self.config
        rows = (cfg.num_hidden_layers * cfg.num_key_value_heads
                * self.page_size)
        elems = rows * cfg.head_dim
        if self.kv_quant and not dense:
            return 2 * elems + 2 * rows * 4
        return 2 * elems * self._embed_itemsize

    def quant_snapshot(self) -> dict:
        """What is quantized, the per-page byte math, and the spill-tier
        bytes against what the same traffic would have moved with dense
        pages."""
        b = self.blocks
        dense_page = self._page_bytes(dense=True)
        return {
            "weight_kind": self.quant or "dense",
            "kv_quant": self.kv_quant,
            "page_bytes": self._page_bytes(),
            "dense_page_bytes": dense_page,
            "spilled_pages": b.spilled_pages,
            "spill_bytes": b.spill_bytes,
            "spill_bytes_dense_estimate": b.spilled_pages * dense_page,
        }

    def lora_snapshot(self) -> dict:
        """The ``lora.json`` side-file: the adapter store's residency
        census plus the device bank footprint."""
        snap = self.lora.snapshot() if self.lora is not None else {}
        snap["bank_bytes_device"] = self.runner.lora_bank_bytes()
        return snap

    def resource_snapshot(self) -> dict:
        """Engine-local half of ``GET /debug/resources``: the exact
        pool census (live/cached/free with a leak check), per-resident-
        request page footprints, fragmentation against the queue head,
        the runner's device memory, and the phase timing breakdown.
        The process-wide tracker snapshot (memory/compiles/goodput)
        complements it."""
        b = self.blocks
        head_need = None
        if self.scheduler.queue:
            head = self.scheduler.queue[0]
            head_need = b.pages_needed(head.prompt.size,
                                       head.gen.max_new_tokens)
        requests = {}
        for slot, req in enumerate(self.scheduler.slots):
            if req is not None:
                fp = b.seq_footprint(req.id)
                fp["slot"] = slot
                requests[str(req.id)] = fp
        pool = b.pool_accounting()
        pool["fragmentation_ratio"] = round(b.fragmentation(head_need), 6)
        return {
            "pool": pool,
            "requests": requests,
            "mesh": self.runner.mesh_info(),
            "lora": (self.lora_snapshot()
                     if self.lora is not None else None),
            "timings": {k: round(v, 6) for k, v in self.timings.items()},
            "counters": {
                "decode_steps": self.decode_steps,
                "decode_traces": self.decode_traces,
                "host_syncs": self.host_syncs,
                "logit_fetches": self.logit_fetches,
                "pages_allocated": b.pages_allocated,
                "recoveries": self.recoveries,
                "quarantines": self.quarantines,
                "prefill_chunks": self.prefill_chunks,
                "preemptions": self.preemptions,
                "spilled_pages": b.spilled_pages,
                "restored_pages": b.restored_pages,
            },
        }


def _softmax(x):
    x = x - np.max(x[np.isfinite(x)]) if np.isfinite(x).any() else x
    e = np.exp(np.where(np.isfinite(x), x, -np.inf))
    return e / e.sum()


def _pages_buckets(num_pages):
    """Integer page-count buckets spanning the pool (pages-in-use is a
    count, not a latency; the default ms-scale buckets would collapse)."""
    n = max(num_pages, 1)
    edges = sorted({max(1, round(n * f))
                    for f in (0.125, 0.25, 0.375, 0.5, 0.625, 0.75,
                              0.875, 1.0)})
    return tuple(float(e) for e in edges)


def create_engine(model_or_config, state: dict | None = None, *,
                  device=None,
                  max_slots: int = 4, page_size: int = 64,
                  num_pages: int | None = None,
                  max_model_len: int | None = None,
                  emit_logits: bool = False,
                  enable_prefix_cache: bool = False,
                  sync_interval: int = 1, clock=time.monotonic,
                  spec_k: int | None = None,
                  prefill_chunk: int | None = None,
                  preempt: bool | None = None, faults=None,
                  quant: str | None = None, kv_quant: bool | None = None,
                  lora=None, slo=None, usage=None, requestlog=None,
                  mesh=None) -> Engine:
    """Build a continuous-batching engine over a ``LlamaForCausalLM``
    (``create_engine(model)``, the reference's form: its ``config`` and
    ``functional_state()``, on its parameters' device unless ``device``
    says otherwise) or over a config and a Llama state dict
    (``create_engine(config, state)``; see ``models/convert.py``:
    :func:`state_from_numpy` carries the JAX package's weights over,
    :func:`init_state` makes random ones).  The two are told apart by
    the first argument: a Layer has ``functional_state``, a config does
    not.

    ``device=None`` runs on CUDA (and raises without a card);
    ``device="cpu"`` runs every kernel's plain PyTorch version.
    ``enable_prefix_cache=True`` turns on automatic prefix caching;
    ``sync_interval=N`` lets the greedy decode loop run N device steps
    between host syncs; ``prefill_chunk=N`` (default
    ``FLAGS_serving_prefill_chunk``) splits admission prefill into
    N-token chunks interleaved with decode steps.  ``spec_k=K`` (default
    ``FLAGS_serving_spec_k``) turns on speculative decoding: the n-gram
    drafter proposes up to K tokens per slot and one verify step scores
    all K+1 positions — greedy outputs are identical to ``spec_k=0``.
    ``preempt`` (default ``FLAGS_serving_preempt``, True) enables
    priority preempt-and-swap.  ``faults`` takes a :class:`FaultPlan`
    (default: ``FLAGS_serving_fault_plan``, empty = none).  ``quant``
    ("int8"/"int4") quantizes the projection weights, ``kv_quant=True``
    the KV pages, and ``lora`` takes an :class:`AdapterStore` (requests
    then pick an adapter with ``submit(..., adapter=name)``).  ``slo``
    takes an :class:`~.slo.SLOTracker`, ``usage`` a
    :class:`~..observability.usage.UsageMeter` and ``requestlog`` a
    :class:`~..observability.requestlog.RequestLog` (each None = off).
    ``mesh`` (an int, ``"tp=N"`` or a 1-tuple; default
    ``FLAGS_serving_mesh_tp``) serves over ``tp`` ranks, one process per
    card (``device="cpu"``: gloo ranks on the CPU); tp must divide the q
    heads, the kv heads and the FFN width.  Keep a tp engine's ``state``
    on the host: rank 0 scatters every rank's shard from it, and the
    engine keeps it for a supervisor's rebuild, so a state on ``cuda:0``
    would stay there beside rank 0's shard as a second, full copy.

    Example::

        engine = create_engine(llama3_8b(), state, max_slots=8,
                               enable_prefix_cache=True, sync_interval=8,
                               spec_k=4)
        req = engine.submit([1, 2, 3], GenerationConfig(max_new_tokens=32))
        for tok in req.stream():
            ...
    """
    if hasattr(model_or_config, "functional_state"):
        if state is not None:
            raise ValueError("create_engine(model) takes no state")
        model, config = model_or_config, None
    else:
        model, config = None, model_or_config
    return Engine(model, config=config, state=state, device=device,
                  max_slots=max_slots, page_size=page_size,
                  num_pages=num_pages, max_model_len=max_model_len,
                  emit_logits=emit_logits,
                  enable_prefix_cache=enable_prefix_cache,
                  sync_interval=sync_interval, clock=clock, spec_k=spec_k,
                  prefill_chunk=prefill_chunk, preempt=preempt,
                  faults=faults, quant=quant, kv_quant=kv_quant, lora=lora,
                  slo=slo, usage=usage, requestlog=requestlog, mesh=mesh)
