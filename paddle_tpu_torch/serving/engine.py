"""Continuous-batching inference engine over the paged KV pool.

Ports ``paddle_tpu/serving/engine.py`` at tp=1 with dense weights
(Orca's iteration-level scheduling over vLLM-style PagedAttention):

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
depend on batch composition).  A kernel or prefill failure propagates
out of :meth:`Engine.step`; per-request quarantine comes back with the
supervisor slice.

Serving modes: ``quant="int8"|"int4"`` converts the dense checkpoint at
construction (``quantize_state``: the projections run the K4 GEMV);
``kv_quant=True`` switches the KV pools to int8 pages with f32 scales;
``lora=AdapterStore(...)`` arms a packed adapter bank, and
``submit(..., adapter="name")`` pins that adapter's bank row from submit
to finalize (the decode step's deltas run the K5 kernel).  Prefix pages
are shared only between requests of one adapter.  Speculative decoding,
preemption, recovery, fault injection, usage metering, request logs,
SLO tracking and tensor parallelism come with later slices: their
constructor arguments raise ``NotImplementedError`` when set.
"""
from __future__ import annotations

import time

import numpy as np

from .. import observability as _obs
from .. import resolve_device
from ..models.generation import GenerationConfig
from ..models.llama import LlamaConfig
from .block_manager import BlockManager
from .parallel.runner import ModelRunner
from .quantize import quantize_state
from .request import Request, RequestState
from .scheduler import Scheduler

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

# constructor arguments of the reference engine whose features come with
# later slices: a set value raises instead of being silently ignored
_LATER = {"spec_k": "speculative decoding", "preempt": "preemption",
          "faults": "fault injection", "usage": "usage metering",
          "requestlog": "request logs", "slo": "SLO tracking",
          "mesh": "tensor parallelism"}


class NonFiniteLogitsError(ValueError):
    """A request's logits hold no usable probability mass (NaN/Inf from
    the model, or top_k/top_p masked every candidate)."""


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
    """

    def __init__(self, *, config: LlamaConfig, state: dict, device=None,
                 max_slots: int = 4, page_size: int = 64,
                 num_pages: int | None = None,
                 max_model_len: int | None = None,
                 emit_logits: bool = False,
                 enable_prefix_cache: bool = False,
                 sync_interval: int = 1, clock=time.monotonic,
                 prefill_chunk: int | None = None,
                 quant: str | None = None, kv_quant: bool | None = None,
                 lora=None, **later):
        for name, value in later.items():
            if name not in _LATER:
                raise TypeError(f"Engine got an unexpected argument {name!r}")
            unset = value is None or value is False or (
                isinstance(value, (int, str)) and value in (0, ""))
            if not unset and not (name == "mesh" and value == 1):
                raise NotImplementedError(
                    f"{name}={value!r}: {_LATER[name]} is not ported to "
                    "paddle_tpu_torch yet")
        self.device = resolve_device(device)
        # quantized serving: convert the dense checkpoint before
        # placement (embeddings/norms/lm_head stay dense, so the dtype
        # the pools take still is the checkpoint's).  None means off.
        quant = quant or ""
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
        self.prefill_chunk = max(int(prefill_chunk or 0), 0)

        self.blocks = BlockManager(
            num_pages, self.page_size,
            enable_prefix_cache=self.enable_prefix_cache)
        # chunked admissions must not be cache-matchable until their KV
        # has actually been written: allocate_seq defers registration
        # past this many fresh tokens and the engine publishes after the
        # last chunk lands
        self.blocks.defer_publish = self.prefill_chunk
        self.scheduler = Scheduler(self.blocks, self.max_slots,
                                   clock=self._clock)
        self.scheduler._finalize = self._finalize
        # every eviction parks its slot: a cancel/deadline eviction would
        # otherwise leave the slot's table/pos pointing at freed pages,
        # and the lockstep decode step (which writes KV for every slot)
        # would corrupt them once reallocated
        self.scheduler._on_evict = self._park

        self.runner = ModelRunner(
            config, state, device=self.device, max_slots=self.max_slots,
            page_size=self.page_size, table_width=self.table_width,
            num_pages=self.blocks.num_pages,
            dump_page=self.blocks.dump_page,
            sync_interval=self.sync_interval,
            emit_logits=self.emit_logits, kv_quant=self.kv_quant,
            lora_slots=lora.capacity if lora is not None else 0,
            lora_rank=lora.rank if lora is not None else 0)
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
        # [(ring row, [(slot, request), ...]), ...]
        self._pending: list[tuple[int, list]] = []
        self._last_logits = None        # device tensor, fetched lazily

        self.decode_steps = 0       # mirror of serving_decode_steps_total
        self.host_syncs = 0         # ring fetches (1 per sync_interval)
        self.logit_fetches = 0      # [slots, V] transfers (sampling only)
        # chunked prefill: in-flight admission prefills advanced one
        # chunk per engine step — {slot: state dict}
        self._chunking: dict[int, dict] = {}
        self.prefill_chunks = 0     # mirror of serving_prefill_chunks_total
        # the most prompt tokens prefilled between two decode steps —
        # bounded by prefill_chunk when chunking is on
        self._prefill_since_decode = 0
        self.max_prefill_gap = 0
        # per-phase wall seconds (mirror of serving_step_phase_seconds_
        # total)
        self.timings = {"prefill_s": 0.0, "decode_s": 0.0,
                        "host_sync_s": 0.0}
        self.progress = 0           # iteration counter, never reset
        self._rngs: dict[int, np.random.Generator] = {}
        self._ttft, self._tpot, self._e2e = _serving_hists()
        self._pages_hist = _obs.histogram(
            "serving_pages_in_use_hist",
            "pages-in-use sampled at each decode step",
            buckets=_pages_buckets(self.blocks.num_pages))
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
                "bytes one KV page pair (k + v + scales) occupies"
            ).set(self._page_bytes())
        if self.lora is not None:
            _obs.gauge(
                "serving_lora_bank_bytes",
                "device bytes the packed adapter bank occupies "
                "(all rows, every projection, + the scale vector)"
            ).set(self.runner.lora_bank_bytes())

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
               arrival_time: float | None = None,
               priority: int = 0, adapter: str | None = None) -> Request:
        """Queue one request; ``priority`` sets its scheduling class
        (higher admits first).  ``adapter`` names a LoRA adapter
        registered with the engine's AdapterStore (None = dense); its
        bank row is pinned from here to the request's finalize."""
        req = Request(prompt, gen, deadline=deadline, on_token=on_token,
                      priority=priority, adapter=adapter,
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
        # unknown names KeyError here; a full bank (every row pinned)
        # RuntimeErrors
        req._adapter_row = (self.lora.acquire(req.adapter)
                            if self.lora is not None else 0)
        req._engine = self
        try:
            self.scheduler.submit(req)
        except BaseException:
            # a rejected submit must not leave its adapter row pinned
            if self.lora is not None:
                self.lora.release(req.adapter)
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
        self.progress += 1
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
        t0 = time.perf_counter()
        ps = self.page_size
        plen = req.prompt.size
        meta = self.blocks.seq_meta(req.id)
        cached = int(meta["cached_len"])
        row = self.blocks.table_row(req.id, self.table_width)
        if meta["cow_src"] is not None:
            # copy-on-write: duplicate the matching tail page into this
            # request's own tail before any writes land there
            self.runner.copy_page(int(meta["cow_src"]),
                                  int(row[cached // ps]))
        req.num_cached_tokens = cached
        req.prefill_cached_tokens += cached
        req.prefill_computed_tokens += plen - cached
        if self.prefill_chunk and plen - cached > self.prefill_chunk:
            # chunked admission: one chunk per engine step so decoding
            # slots keep stepping in between
            self._note_phase("prefill", time.perf_counter() - t0)
            self._begin_chunks(slot, req, req.prompt, cached, row)
            return
        if cached == 0:
            bucket = -(-plen // ps) * ps
            ids = np.zeros((1, bucket), np.int32)
            ids[0, :plen] = req.prompt
            logits = self.runner.prefill(ids, plen, row,
                                         adapter_row=req._adapter_row)
        else:
            suffix = plen - cached
            bucket = -(-suffix // ps) * ps
            ids = np.zeros((1, bucket), np.int32)
            ids[0, :suffix] = req.prompt[cached:]
            logits = self.runner.prefill_cached(
                ids, suffix, cached, row, adapter_row=req._adapter_row)
        self._note_gap(plen - cached)
        _M_HOST_SYNCS.labels("prefill").inc()
        tok = self._pick_token(req, logits.cpu().numpy()[0])
        now = self._clock()
        self._ttft.observe(now - req.arrival_time)
        self._note_phase("prefill", time.perf_counter() - t0)
        self._enter_decode(slot, req, row, plen, tok)
        self._emit(slot, req, tok, now)

    # --------------------------------------------------- chunked prefill
    def _note_gap(self, tokens: int):
        """Account ``tokens`` prompt tokens prefilled since the last
        decode step (the overload-degradation witness)."""
        self._prefill_since_decode += int(tokens)
        if self._prefill_since_decode > self.max_prefill_gap:
            self.max_prefill_gap = self._prefill_since_decode

    def _begin_chunks(self, slot: int, req: Request, ids_all, done: int,
                      row):
        """Arm chunked prefill for ``slot`` and run its first chunk."""
        self._chunking[slot] = {
            "req": req, "ids": np.asarray(ids_all, np.int32).reshape(-1),
            "done": int(done), "row": row, "chunks": 0}
        self._advance_chunk(slot)

    def _advance_chunk(self, slot: int):
        """Run ONE prefill chunk for an in-flight admission.  Chunk K
        attends chunks 1..K-1 through the cached prefill; intermediate
        chunks never fetch logits, so they cost no host sync."""
        st = self._chunking[slot]
        req = st["req"]
        ids_all = st["ids"]
        n = int(ids_all.size)
        done = st["done"]
        this = min(self.prefill_chunk, n - done)
        ps = self.page_size
        t0 = time.perf_counter()
        bucket = -(-this // ps) * ps
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :this] = ids_all[done:done + this]
        if done == 0:
            logits = self.runner.prefill(ids, this, st["row"],
                                         adapter_row=req._adapter_row)
        else:
            logits = self.runner.prefill_cached(
                ids, this, done, st["row"], adapter_row=req._adapter_row)
        st["chunks"] += 1
        self.prefill_chunks += 1
        req.prefill_chunks += 1
        _M_CHUNKS.inc()
        self._note_gap(this)
        if done + this < n:
            st["done"] = done + this
            self._note_phase("prefill", time.perf_counter() - t0)
            return
        # admission: the first output token comes from the final chunk's
        # last-position logits
        _M_HOST_SYNCS.labels("prefill").inc()
        tok = self._pick_token(req, logits.cpu().numpy()[0])
        self._chunking.pop(slot)
        # the full chunked prefix is device-resident now — register it
        # in the prefix-cache chain (deferred at allocate_seq)
        self.blocks.publish_seq(req.id, ids_all, adapter=req.adapter)
        now = self._clock()
        self._note_phase("prefill", time.perf_counter() - t0)
        self._enter_decode(slot, req, st["row"], n, tok)
        self._ttft.observe(now - req.arrival_time)
        self._emit(slot, req, tok, now)

    def _enter_decode(self, slot: int, req: Request, row, pos: int,
                      tok: int):
        """Flip an admitted request into decode: patch the slot mirrors
        + the device row."""
        self.table[slot] = row
        self._pos[slot] = pos
        self._tok[slot] = tok
        self._active[slot] = 1
        self._aidx[slot] = req._adapter_row
        self._push_slot(slot)
        req.state = RequestState.DECODE

    # ------------------------------------------------------------ decode
    def _decode(self, active: list[int]):
        reqs = [(s, self.scheduler.slots[s]) for s in active]
        step_t0 = time.perf_counter()
        logits = self.runner.decode_step()
        self._note_phase("decode", time.perf_counter() - step_t0)
        self.decode_steps += 1
        self._prefill_since_decode = 0      # gap witness: decode ran
        _M_STEPS.inc()
        self._pages_hist.observe(self.blocks.pages_in_use)
        for slot in active:
            self._pos[slot] += 1            # mirror of pos + active
        self._pending.append((self._ring_cursor, reqs))
        self._ring_cursor = (self._ring_cursor + 1) % self.sync_interval
        self._last_logits = logits
        # any active sampling request needs its token fed back before
        # the next step, so sampling degrades to a per-step sync
        eff = 1 if any(r.gen.do_sample for _, r in reqs) \
            else self.sync_interval
        if len(self._pending) >= eff:
            self._sync()

    def _sync(self):
        """Drain the device token ring: ONE [sync_interval, slots] int32
        transfer covers every decode step since the previous sync."""
        sync_t0 = time.perf_counter()
        ring = self.runner.fetch_ring()
        self.host_syncs += 1
        self._note_phase("host_sync", time.perf_counter() - sync_t0)
        _M_HOST_SYNCS.labels("ring").inc()
        logits_np = None
        now = self._clock()
        n_rows = len(self._pending)
        corrections = []
        for row_i, (ridx, entries) in enumerate(self._pending):
            for slot, req in entries:
                if req.is_finished() or req.state != RequestState.DECODE:
                    continue        # evicted/finished: overrun discarded
                tok = raw = int(ring[ridx, slot])
                if req.gen.do_sample:
                    # sampling rows only exist under eff-interval 1, so
                    # the step's logits are always the right row
                    if logits_np is None:
                        logits_np = self._last_logits.cpu().numpy()
                        self.logit_fetches += 1
                        _M_HOST_SYNCS.labels("logits").inc()
                    tok = self._pick_token(req, logits_np[slot])
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
        if corrections:
            self.runner.correct_tokens(corrections)

    def _note_phase(self, phase: str, seconds: float):
        """Charge engine wall time to a phase (the per-engine mirror and
        the serving_step_phase_seconds_total counter)."""
        seconds = max(float(seconds), 0.0)
        self.timings[phase + "_s"] += seconds
        _M_PHASE_SECONDS.labels(phase).inc(seconds)

    def _emit(self, slot: int, req: Request, tok: int, now: float):
        req._emit(tok, now)
        _M_TOKENS.inc()
        # committed-token ledger: one durable token per emit
        self.blocks.append(req.id, 1)
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
        self._e2e.observe(now - req.arrival_time)
        _M_REQUESTS.labels(reason).inc()
        _M_FINISH.labels(reason).inc()

    # -------------------------------------------------------------- info
    def stats(self) -> dict:
        b = self.blocks
        return {
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
            "mesh_tp": 1,
            "quant": self.quant,
            "kv_quant": self.kv_quant,
            "lora": (self.lora.snapshot()
                     if self.lora is not None else None),
            "timings": {k: round(v, 6) for k, v in self.timings.items()},
            "progress": self.progress,
        }

    def _page_bytes(self, *, dense: bool = False) -> int:
        """Bytes one KV page pair (k + v, all layers and heads)
        occupies: under ``kv_quant`` the int8 elements plus the
        per-(page-row, head) f32 scale rows; ``dense=True`` prices the
        same page at the checkpoint dtype (the savings baseline)."""
        cfg = self.config
        rows = (cfg.num_hidden_layers * cfg.num_key_value_heads
                * self.page_size)
        elems = rows * cfg.head_dim
        if self.kv_quant and not dense:
            return 2 * elems + 2 * rows * 4
        return 2 * elems * self._embed_itemsize

    def quant_snapshot(self) -> dict:
        """What is quantized and the per-page byte math (the spill-tier
        figures of the reference come with preemption)."""
        return {
            "weight_kind": self.quant or "dense",
            "kv_quant": self.kv_quant,
            "page_bytes": self._page_bytes(),
            "dense_page_bytes": self._page_bytes(dense=True),
        }

    def lora_snapshot(self) -> dict:
        """The adapter store's residency census plus the device bank
        footprint."""
        snap = self.lora.snapshot() if self.lora is not None else {}
        snap["bank_bytes_device"] = self.runner.lora_bank_bytes()
        return snap


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


def create_engine(config: LlamaConfig, state: dict, *, device=None,
                  max_slots: int = 4, page_size: int = 64,
                  num_pages: int | None = None,
                  max_model_len: int | None = None,
                  emit_logits: bool = False,
                  enable_prefix_cache: bool = False,
                  sync_interval: int = 1, clock=time.monotonic,
                  prefill_chunk: int | None = None,
                  quant: str | None = None, kv_quant: bool | None = None,
                  lora=None, **later) -> Engine:
    """Build a continuous-batching engine over a Llama state dict (see
    ``models/convert.py``: :func:`state_from_numpy` carries the JAX
    package's weights over, :func:`init_state` makes random ones).

    ``device=None`` runs on CUDA (and raises without a card);
    ``device="cpu"`` runs every kernel's plain PyTorch version.
    ``enable_prefix_cache=True`` turns on automatic prefix caching;
    ``sync_interval=N`` lets the greedy decode loop run N device steps
    between host syncs; ``prefill_chunk=N`` splits admission prefill
    into N-token chunks interleaved with decode steps.  ``quant``
    ("int8"/"int4") quantizes the projection weights, ``kv_quant=True``
    the KV pages, and ``lora`` takes an :class:`AdapterStore` (requests
    then pick an adapter with ``submit(..., adapter=name)``).

    Example::

        engine = create_engine(llama3_8b(), state, max_slots=8,
                               enable_prefix_cache=True, sync_interval=8)
        req = engine.submit([1, 2, 3], GenerationConfig(max_new_tokens=32))
        for tok in req.stream():
            ...
    """
    return Engine(config=config, state=state, device=device,
                  max_slots=max_slots, page_size=page_size,
                  num_pages=num_pages, max_model_len=max_model_len,
                  emit_logits=emit_logits,
                  enable_prefix_cache=enable_prefix_cache,
                  sync_interval=sync_interval, clock=clock,
                  prefill_chunk=prefill_chunk, quant=quant,
                  kv_quant=kv_quant, lora=lora, **later)
