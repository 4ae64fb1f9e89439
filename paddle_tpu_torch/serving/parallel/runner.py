"""The engine's device half: weights, paged KV pools, decode state.

Ports ``paddle_tpu/serving/parallel/runner.py``.  The :class:`ModelRunner`
owns the state dict on its device, the paged KV pools, the rope tables,
the device-resident decode state (table/pos/tok/active + the
sampled-token ring) and the programs the engine calls through a narrow
seam: :meth:`decode_step`, :meth:`verify_step`, :meth:`prefill`,
:meth:`prefill_cached`, :meth:`copy_page`, :meth:`read_page`,
:meth:`write_page`, :meth:`push_slot`, :meth:`fetch_ring`,
:meth:`correct_tokens`.

The KV pools ``[L, num_pages + 1, kvH, page_size, D]`` (the extra row
is the dump page) are updated IN PLACE by prefill, decode and the CoW
page copy; the reference threads them functionally through donated jit
arguments.  PyTorch runs eagerly, so there is no trace to count:
``decode_traces`` counts first calls of a built decode-step or verify
program (the moment the reference traces its jit) — one per runner, two
with speculation, as the reference's — so ``stats()`` stays comparable,
and ``verify_traces`` the verify program's.  Decode attention runs the
CUDA paged kernel (the verify step too, at slots x (k+1) rows) and full
prefill the CUDA masked flash forward (through ``sdpa``); the cached-
suffix prefill's arbitrary bool mask runs plain PyTorch attention, as
it runs XLA on the TPU.

The serving modes:

  * quantized weights — :class:`QuantizedWeight` leaves (checked at
    construction by :meth:`ModelRunner._validate_quantized_state`) run
    through the K4 GEMV in every decode projection;
  * ``kv_quant`` — int8 pools with f32 scale pools ``[L, P+1, kvH,
    page_size]``; every write quantizes per (token, head) and decode
    attention dequantizes in the page gather (plain PyTorch, as the
    reference runs it on XLA: no K3 launch);
  * ``lora_slots`` — a packed f32 adapter bank of ``lora_slots + 1``
    rows (row 0 stays zero: the no-adapter row) and a device ``aidx
    [slots]`` vector set by :meth:`push_slot`.  The decode step passes
    the vector to ``lora_delta`` (the K5 kernel); prefill passes the
    request's scalar row (plain matmuls).

Off modes (dense weights, ``kv_quant=False``, ``lora_slots=0``) run the
dense path unchanged.  ``spec_k > 0`` adds the verify program and widens
the ring to ``[sync_interval, slots, k+1]``.  ``read_page`` returns CPU
tensors (numpy has no bfloat16); the host spill tier keeps them as
they are.

Two construction modes, by ``tp``:

``tp == 1``
    The single-device programs above: no process, no message, no
    collective.

``tp > 1``
    One runner per rank of a ``tp``-way mesh, one process per card
    (``serving/parallel/worker.py`` starts them; the caller's process
    is rank 0).  Rank 0 scatters its shards from the full state over
    the process group (``models/convert.py:shard_serving_leaf``: q/k/v,
    gate and up split their columns, o and down their rows, the rest
    replicates), the pools hold ``kvh/tp`` heads ``[L, P+1, kvh/tp,
    page_size, D]``, the adapter bank holds the rank's rows of each
    adapter, and the layers are tp=1's, given the tp group as ``axis``:
    their only collectives are the o and down all-reduces (2 x L per
    decode step).  Logits, the next tokens and the ring come out equal
    on every rank, so every rank feeds the same token back.  Each rank's
    ``read_page`` returns its heads of the page and ``write_page`` takes
    the full page and keeps its heads; rank 0's runner (``worker.
    MeshRunner``) gathers and scatters them, so the host tier holds
    full-head pages as at tp=1.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import observability as _obs
from ...models.generation import (_decode_layer_paged, _ffn,
                                  _layer_weights, _mm, _out_proj,
                                  _prefill_layer, _qkv_proj, _rope_at)
from ...models.llama import _rms, _rope_tables, _rotate_half
from ...ops.pallas.flash_attention import sdpa
from ...ops.pallas.paged_attention import gather_kv_pages, quantize_kv_rows
from ...distributed import collective as C
from ...models.convert import (_LORA_ROW_KEYS, serving_shard_axis,
                               shard_serving_adapter, shard_serving_leaf)
from ...ops.pallas.quant_matmul import QuantizedWeight
from ..lora.store import lora_key_dims
from .layers import decode_layer_paged_quant, prefill_layer_cached_quant

__all__ = ["ModelRunner"]

_M_STEP_TRACES = _obs.counter(
    "serving_decode_step_traces_total",
    "decode-step programs first run — continuous batching keeps this at "
    "1 per engine (2 with speculative decoding: the plain step + the "
    "verify program); growth means admissions are rebuilding the step")
_M_VERIFY_TRACES = _obs.counter(
    "serving_spec_verify_traces_total",
    "verify programs first run — exactly 1 per speculative engine")
_M_PREFILL_TRACES = _obs.counter(
    "serving_prefill_traces_total",
    "prefill programs first used, one per prompt-length bucket",
    ("bucket",))


class ModelRunner:
    """Device-side serving runner of one rank (see module docstring).

    At ``tp > 1``, ``group`` is the mesh's process group and ``state``
    is the full state on rank 0 and its :func:`state_spec` on the other
    ranks (their shards arrive by scatter)."""

    def __init__(self, config, state, *, device: torch.device,
                 max_slots: int, page_size: int, table_width: int,
                 num_pages: int, dump_page: int, sync_interval: int = 1,
                 emit_logits: bool = False, spec_k: int = 0,
                 kv_quant: bool = False, lora_slots: int = 0,
                 lora_rank: int = 0, tp: int = 1, rank: int = 0,
                 group=None):
        self.config = config
        self.tp = int(tp)
        self.rank = int(rank)
        # the tp group the layers all-reduce over (None: single device)
        self._axis = group if self.tp > 1 else None
        self.device = device
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.table_width = int(table_width)
        self.num_pages = int(num_pages)
        self.dump_page = int(dump_page)
        self.sync_interval = int(sync_interval)
        self.emit_logits = bool(emit_logits)
        self.spec_k = int(spec_k)
        self.kv_quant = bool(kv_quant)
        self.lora_slots = int(lora_slots)
        self.lora_rank = int(lora_rank)
        if self.lora_slots and self.lora_rank < 1:
            raise ValueError(
                f"lora_slots={self.lora_slots} requires lora_rank >= 1,"
                f" got {self.lora_rank}")
        if self.tp == 1:
            self._validate_quantized_state(state)
            self.state = {k: v.to(device) for k, v in state.items()}
        else:
            self.state = _scatter_state(state, self.tp, self.rank, device)

        L = config.num_hidden_layers
        kvh, hd = config.num_key_value_heads // self.tp, config.head_dim
        dtype = self.state["llama.embed_tokens.weight"].dtype
        pool_shape = (L, self.num_pages + 1, kvh, self.page_size, hd)
        pool_dtype = torch.int8 if self.kv_quant else dtype
        self.kpool = torch.zeros(pool_shape, dtype=pool_dtype, device=device)
        self.vpool = torch.zeros(pool_shape, dtype=pool_dtype, device=device)
        # per-(page-row, head) f32 scales of the int8 pools (None when off)
        self.kscale = self.vscale = None
        if self.kv_quant:
            self.kscale = torch.zeros(pool_shape[:-1], dtype=torch.float32,
                                      device=device)
            self.vscale = torch.zeros_like(self.kscale)
        # the adapter bank (() when off)
        self.lora = self._build_lora_bank() if self.lora_slots else ()
        self._rope_len = self.table_width * self.page_size
        self._cos, self._sin = _rope_tables(self._rope_len, hd,
                                            config.rope_theta, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        self._table_dev = torch.full((self.max_slots, self.table_width),
                                     self.dump_page, **i32)
        self._pos_dev = torch.zeros((self.max_slots,), **i32)
        self._tok_dev = torch.zeros((self.max_slots,), **i32)
        self._active_dev = torch.zeros((self.max_slots,), **i32)
        # per-slot adapter bank rows (None when off)
        self._aidx_dev = (torch.zeros((self.max_slots,), **i32)
                          if self.lora_slots else None)
        # with speculation the ring rows are WIDE ([slots, k+1]: a verify
        # step deposits every candidate token; the plain step uses column
        # 0) so the host sync stays ONE transfer either way
        ring_shape = ((self.sync_interval, self.max_slots)
                      if self.spec_k == 0 else
                      (self.sync_interval, self.max_slots, self.spec_k + 1))
        self._ring_dev = torch.zeros(ring_shape, **i32)
        self._ridx = 0              # ring row the next step writes

        self.decode_traces = 0      # python mirror of _M_STEP_TRACES
        self.verify_traces = 0      # python mirror of _M_VERIFY_TRACES
        self._step_fn = self._build_step()
        self._verify_fn = self._build_verify() if self.spec_k else None
        self.prefill_buckets: set[int] = set()
        self.cached_prefill_buckets: set[int] = set()

    # ------------------------------------------------------ construction
    @staticmethod
    def _validate_quantized_state(state: dict):
        """Loud construction-time rejection of malformed quantized
        leaves: a broken QuantizedWeight would otherwise surface as an
        opaque shape error inside the first step."""
        for key, v in state.items():
            if not isinstance(v, QuantizedWeight):
                continue
            if v.kind not in ("int8", "int4"):
                raise ValueError(
                    f"state[{key!r}]: unsupported quant kind {v.kind!r}"
                    " (expected 'int8' or 'int4')")
            if not (hasattr(v.q, "shape") and hasattr(v.scale, "shape")):
                raise ValueError(
                    f"state[{key!r}]: QuantizedWeight q/scale must be "
                    "tensors (missing scale?)")
            if v.q.dim() != 2:
                raise ValueError(
                    f"state[{key!r}]: quantized values must be 2-D, "
                    f"got shape {tuple(v.q.shape)}")
            if v.scale.dim() != 1 or v.scale.shape[0] != v.q.shape[1]:
                raise ValueError(
                    f"state[{key!r}]: scale shape "
                    f"{tuple(v.scale.shape)} does not match one scale "
                    f"per output channel (expected ({v.q.shape[1]},))")
            rows = v.k // 2 if v.kind == "int4" else v.k
            if v.q.shape[0] != rows:
                raise ValueError(
                    f"state[{key!r}]: {v.kind} values have "
                    f"{v.q.shape[0]} rows, expected {rows} for "
                    f"K={v.k}")

    def _build_lora_bank(self):
        """Zeroed packed bank ``{"a": {key: [L, rows, r, in]}, "b":
        {key: [L, rows, r, out]}, "scale": [rows]}``, f32 whatever the
        base dtype — row 0 stays all zero (the no-adapter row), so a
        mixed batch indexes one bank in one step."""
        dims = lora_key_dims(self.config)
        if self.tp > 1:     # this rank's rows: A of o/down, B of the rest
            dims = {k: ((ind // self.tp, outd) if k in _LORA_ROW_KEYS
                        else (ind, outd // self.tp))
                    for k, (ind, outd) in dims.items()}
        L = self.config.num_hidden_layers
        rows, r = self.lora_slots + 1, self.lora_rank
        f32 = dict(dtype=torch.float32, device=self.device)
        return {
            "a": {k: torch.zeros((L, rows, r, ind), **f32)
                  for k, (ind, _) in dims.items()},
            "b": {k: torch.zeros((L, rows, r, outd), **f32)
                  for k, (_, outd) in dims.items()},
            "scale": torch.zeros((rows,), **f32),
        }

    @torch.no_grad()
    def load_adapter(self, row: int, a: dict, b: dict, scale: float):
        """Write one adapter into bank row ``row`` in place (admission
        path, never per step).  ``a``/``b`` map each projection key to
        its [L, r, dim] host tensor (the whole adapter: at tp > 1 each
        rank keeps its rows)."""
        self._check_bank_row(row)
        if self.tp > 1:
            a, b = shard_serving_adapter(a, b, self.tp, self.rank)
        for k, bank in self.lora["a"].items():
            bank[:, row] = torch.as_tensor(a[k], dtype=torch.float32)
        for k, bank in self.lora["b"].items():
            bank[:, row] = torch.as_tensor(b[k], dtype=torch.float32)
        self.lora["scale"][row] = float(scale)

    def _check_bank_row(self, row):
        if not self.lora_slots:
            raise RuntimeError(
                "runner built with lora_slots=0 has no adapter bank")
        if not 1 <= int(row) <= self.lora_slots:
            raise ValueError(
                f"bank row {row} out of range 1..{self.lora_slots} "
                "(row 0 is the reserved no-adapter row)")

    def lora_bank_bytes(self) -> int:
        """Total device bytes of the adapter bank (0 when off)."""
        if not self.lora_slots:
            return 0
        leaves = [*self.lora["a"].values(), *self.lora["b"].values(),
                  self.lora["scale"]]
        return sum(t.numel() * t.element_size() for t in leaves)

    # ------------------------------------------------------------ programs
    def _first_run(self, verify: bool = False):
        """Count a built program's first run (the reference traces its
        jit then): the plain step and the verify program each add one
        to ``decode_traces``, the verify program to ``verify_traces``."""
        self.decode_traces += 1
        _M_STEP_TRACES.inc()
        if verify:
            self.verify_traces += 1
            _M_VERIFY_TRACES.inc()

    def _layers(self, h, table, cos1, sin1, posc, aidx):
        """Every decoder layer of one paged decode batch: ``h`` [B, H],
        one token per row at position ``posc`` through ``table``
        [B, W]; the pools update in place (KV written at ``posc``, then
        attention with lens ``posc + 1``)."""
        cfg, lora = self.config, self.lora
        for i in range(cfg.num_hidden_layers):
            w = _layer_weights(self.state, i)
            if self.kv_quant:
                h = decode_layer_paged_quant(
                    w, h, self.kpool[i], self.vpool[i], self.kscale[i],
                    self.vscale[i], table, cos1, sin1, posc, cfg,
                    self._axis, lora, aidx, i)
            else:
                h = _decode_layer_paged(
                    w, h, self.kpool[i], self.vpool[i], table, cos1, sin1,
                    posc, cfg, lora, aidx, i, self._axis)
        h = _rms(h, self.state["llama.norm.weight"], cfg.rms_norm_eps)
        return _logits_of(self.state, h).float()

    def _build_step(self):
        """The lockstep decode step over every slot.  Slot occupancy,
        positions and tables are data, so one build serves the engine's
        whole life."""
        rope_len = self._rope_len
        fresh = [True]
        wide_ring = self.spec_k > 0

        @torch.no_grad()
        def step():
            if fresh[0]:
                fresh[0] = False
                self._first_run()
            # a finished slot keeps decoding until the next host sync
            # (deferred-sync overrun); clamp so its rope/table lookups
            # stay in range — overrun writes land in the slot's own
            # reserved tail or the dump page, never another sequence
            posc = self._pos_dev.clamp(max=rope_len - 1)
            h = self.state["llama.embed_tokens.weight"][
                self._tok_dev.long()]
            cos1, sin1 = _rope_at(self._cos, self._sin, posc.long())
            logits = self._layers(h, self._table_dev, cos1, sin1, posc,
                                  self._aidx_dev)
            nxt = logits.argmax(dim=-1).to(torch.int32)
            self._pos_dev += self._active_dev      # idle slots stay parked
            self._tok_dev = torch.where(self._active_dev.bool(), nxt,
                                        self._tok_dev)
            if wide_ring:
                self._ring_dev[self._ridx, :, 0] = nxt
            else:
                self._ring_dev[self._ridx] = nxt
            self._ridx = (self._ridx + 1) % self.sync_interval
            return logits

        return step

    def _build_verify(self):
        """The speculative verify program: score ``k+1`` candidate
        positions per slot in ONE step.

        The ``[slots, k+1]`` token grid (the slot's current token + its
        ``k`` draft tokens) flattens to a ``[slots*(k+1)]`` batch that
        runs the SAME paged decode layers as the plain step, so the
        paged attention kernel runs once per layer at slots x (k+1)
        rows, each slot's rows sharing its table row.  Every row writes
        its token's KV at ``pos + j`` first, then attends with ``lens =
        pos + j + 1``: row ``j`` sees exactly the prefix a sequential
        decode would have seen (its own slot's writes ``j' <= j``; later
        rows' writes sit past ``lens``, and rejected rows' stale KV is
        masked the same way until a later step overwrites it in place).
        The rows of one slot write distinct offsets (possibly across a
        page boundary); rows of different slots write distinct pages,
        except idle slots and rows clamped at the rope end past the
        reservation, which all land on the dump page or past every
        visible length.  Acceptance stays on the device: the longest
        prefix where the draft matches the target argmax, ``+1`` for
        the correction/bonus token, advances pos/tok, and the full
        candidate row lands in the wide ring for the host to re-derive
        the same acceptance without an extra transfer.  Slots with no
        draft (``dlen == 0``) reduce exactly to the plain step."""
        rope_len = self._rope_len
        k = self.spec_k
        M = k + 1
        fresh = [True]

        @torch.no_grad()
        def verify(draft, dlen):
            if fresh[0]:
                fresh[0] = False
                self._first_run(verify=True)
            S = self.max_slots
            dev = self._tok_dev.device
            # [S, M] candidate grid: column 0 is the slot's current token
            # (the plain step's input), columns 1..k its drafts
            grid = torch.cat([self._tok_dev[:, None], draft], dim=1)
            offs = torch.arange(M, dtype=torch.int32, device=dev)
            pos_f = (self._pos_dev[:, None] + offs[None, :]).reshape(-1)
            posc = pos_f.clamp(max=rope_len - 1)
            table_f = self._table_dev.repeat_interleave(M, dim=0)
            # every candidate row of a slot shares its adapter
            aidx_f = (self._aidx_dev.repeat_interleave(M)
                      if self.lora_slots else None)
            h = self.state["llama.embed_tokens.weight"][
                grid.reshape(-1).long()]
            cos1, sin1 = _rope_at(self._cos, self._sin, posc.long())
            logits = self._layers(h, table_f, cos1, sin1, posc, aidx_f)
            y = logits.argmax(dim=-1).to(torch.int32).reshape(S, M)
            # longest matching prefix: draft[:, j] proposed what the
            # target's own argmax y[:, j] confirms (or not)
            m = ((draft == y[:, :k])
                 & (offs[None, :k] < dlen[:, None])).to(torch.int32)
            # cast back: cumprod/sum promote to int64
            acc = torch.cumprod(m, dim=1).sum(dim=1).to(torch.int32)
            self._pos_dev += (acc + 1) * self._active_dev   # idle: 0
            tok_new = y.gather(1, acc[:, None].long())[:, 0]
            self._tok_dev = torch.where(self._active_dev.bool(), tok_new,
                                        self._tok_dev)
            self._ring_dev[self._ridx] = y
            self._ridx = (self._ridx + 1) % self.sync_interval

        return verify

    # ------------------------------------------------------------ the seam
    def decode_step(self):
        """One lockstep decode step over every slot.  Returns the step's
        [slots, V] f32 logits when the runner emits logits, else None."""
        logits = self._step_fn()
        return logits if self.emit_logits else None

    def verify_step(self, draft: np.ndarray, dlen: np.ndarray):
        """One speculative verify step: ``draft`` [slots, k] int32
        candidate tokens, ``dlen`` [slots] int32 drafted counts (0 =
        the slot takes the plain-step path inside the program).
        Acceptance happens on the device (pos/tok advance by the
        accepted count + 1); the host re-derives it from the wide ring
        row at the next sync."""
        if self._verify_fn is None:
            raise RuntimeError("runner built with spec_k=0 has no "
                               "verify program")
        i32 = dict(dtype=torch.int32, device=self.device)
        self._verify_fn(torch.as_tensor(draft, **i32),
                        torch.as_tensor(dlen, **i32))

    def _write_pages(self, i, pages, k, v):
        """Page one layer's prompt KV ``k``/``v`` [bucket, kvh, D] into
        pool rows ``pages`` (quantized per (token, head) under
        ``kv_quant``)."""
        n_pages, ps = pages.shape[0], self.page_size
        kvh, hd = k.shape[1:]
        if self.kv_quant:
            (k, sk), (v, sv) = quantize_kv_rows(k), quantize_kv_rows(v)
            self.kscale[i, pages] = sk.reshape(n_pages, ps, kvh) \
                .transpose(1, 2)
            self.vscale[i, pages] = sv.reshape(n_pages, ps, kvh) \
                .transpose(1, 2)
        # [bucket, kvh, D] -> [n_pages, kvh, ps, D] page rows
        self.kpool[i, pages] = k.reshape(n_pages, ps, kvh, hd) \
            .transpose(1, 2).to(self.kpool.dtype)
        self.vpool[i, pages] = v.reshape(n_pages, ps, kvh, hd) \
            .transpose(1, 2).to(self.vpool.dtype)

    @torch.no_grad()
    def prefill(self, ids: np.ndarray, plen: int, row: np.ndarray,
                adapter_row: int = 0):
        """Full-prompt prefill: pages the prompt's KV into the pool and
        returns the last-token [1, V] f32 logits.  ``ids`` is the
        [1, bucket] padded prompt (bucket a page multiple);
        ``adapter_row`` the request's bank row (0 = dense)."""
        cfg = self.config
        bucket = ids.shape[1]
        if bucket not in self.prefill_buckets:
            self.prefill_buckets.add(bucket)
            _M_PREFILL_TRACES.labels(str(bucket)).inc()
        n_pages = bucket // self.page_size
        state = self.state
        ids_t = torch.as_tensor(ids, device=self.device).long()
        pages = torch.as_tensor(row[:n_pages], device=self.device).long()
        x = state["llama.embed_tokens.weight"][ids_t]
        pmask = torch.arange(bucket, device=self.device)[None, :] < plen
        for i in range(cfg.num_hidden_layers):
            x, k, v = _prefill_layer(
                _layer_weights(state, i), x, self._cos[:bucket],
                self._sin[:bucket], pmask, cfg, self.lora,
                int(adapter_row), i, self._axis)
            self._write_pages(i, pages, k[0], v[0])
        x = _rms(x, state["llama.norm.weight"], cfg.rms_norm_eps)
        return _logits_of(state, x[:, plen - 1]).float()

    @torch.no_grad()
    def prefill_cached(self, ids: np.ndarray, suffix_len: int,
                       cached_len: int, row: np.ndarray,
                       adapter_row: int = 0):
        """Suffix prefill for a prompt whose first ``cached_len`` tokens
        are already resident in the pool (shared prefix pages and/or a
        CoW-copied tail): suffix queries attend the resident prefix,
        then causally within the (padded) suffix.  Returns the
        last-token [1, V] f32 logits."""
        cfg = self.config
        bucket = ids.shape[1]
        if bucket not in self.cached_prefill_buckets:
            self.cached_prefill_buckets.add(bucket)
            _M_PREFILL_TRACES.labels(f"cached:{bucket}").inc()
        dev = self.device
        ps, W = self.page_size, self.table_width
        kvh = cfg.num_key_value_heads // self.tp
        state = self.state
        row_t = torch.as_tensor(row, device=dev).long()
        x = state["llama.embed_tokens.weight"][
            torch.as_tensor(ids, device=dev).long()]
        j = torch.arange(bucket, device=dev)
        absp = cached_len + j                       # absolute positions
        posc = absp.clamp(max=self._rope_len - 1)
        cos_s, sin_s = self._cos[posc], self._sin[posc]
        t_pre = torch.arange(W * ps, device=dev)
        pre_ok = (t_pre[None, :] < cached_len).expand(bucket, W * ps)
        suf_ok = (j[None, :] <= j[:, None]) & (j[None, :] < suffix_len)
        mask = torch.cat([pre_ok, suf_ok], dim=1)[None, None]
        # per-token write targets (padding lands on the dump page)
        page_w = torch.where(j < suffix_len,
                             row_t[(absp // ps).clamp(max=W - 1)],
                             self.dump_page)[:, None]
        off = (absp % ps)[:, None]
        heads = torch.arange(kvh, device=dev)[None, :]
        widx = (page_w, heads, off)
        lora, aidx = self.lora, int(adapter_row)
        for i in range(cfg.num_hidden_layers):
            w = _layer_weights(state, i)
            if self.kv_quant:
                x, k, v = prefill_layer_cached_quant(
                    w, x, self.kpool[i], self.vpool[i], self.kscale[i],
                    self.vscale[i], row_t, cos_s, sin_s, mask, cfg,
                    self._axis, lora, aidx, i)
                (qk, sk), (qv, sv) = quantize_kv_rows(k[0]), \
                    quantize_kv_rows(v[0])
                self.kpool[i][widx] = qk
                self.vpool[i][widx] = qv
                self.kscale[i][widx] = sk
                self.vscale[i][widx] = sv
                continue
            kpre = gather_kv_pages(self.kpool[i], row_t)
            vpre = gather_kv_pages(self.vpool[i], row_t)
            x, k, v = _prefill_layer_cached(
                w, x, kpre[None], vpre[None], cos_s, sin_s, mask, cfg,
                lora, aidx, i, self._axis)
            self.kpool[i][widx] = k[0].to(self.kpool.dtype)
            self.vpool[i][widx] = v[0].to(self.vpool.dtype)
        x = _rms(x, state["llama.norm.weight"], cfg.rms_norm_eps)
        return _logits_of(state, x[:, suffix_len - 1]).float()

    @torch.no_grad()
    def copy_page(self, src: int, dst: int):
        """Copy-on-write page duplicate across every layer (with its
        scale rows under ``kv_quant``)."""
        self.kpool[:, dst] = self.kpool[:, src]
        self.vpool[:, dst] = self.vpool[:, src]
        if self.kv_quant:
            self.kscale[:, dst] = self.kscale[:, src]
            self.vscale[:, dst] = self.vscale[:, src]

    def read_page(self, page: int):
        """Device -> host copy of one KV page: ``(k, v)`` CPU tensors of
        shape [L, kvh, page_size, hd] in the pool dtype, plus ``(kscale,
        vscale)`` [L, kvh, page_size] f32 when the pools are int8 — the
        spill tier moves the quantized bytes, never a dequantized copy.
        At tp > 1, this rank's ``kvh/tp`` heads.  Preemption-spill only:
        a host sync per call, never on the steady decode path."""
        pools = (self.kpool, self.vpool)
        if self.kv_quant:
            pools += (self.kscale, self.vscale)
        return tuple(p[:, page].to("cpu", copy=True) for p in pools)

    @torch.no_grad()
    def write_page(self, page: int, k, v, kscale=None, vscale=None):
        """Host -> device copy of one KV page (preempted-request resume
        unparking a host-tier copy); int8 pages restore with their
        scales.  The page holds every head; at tp > 1 this rank keeps its
        ``kvh/tp``."""
        self._check_page_scales(kscale, vscale)
        dev = self.device
        if self.tp > 1:
            n = self.kpool.shape[2]
            k, v, kscale, vscale = (
                None if t is None else
                torch.as_tensor(t)[:, self.rank * n:(self.rank + 1) * n]
                for t in (k, v, kscale, vscale))
        self.kpool[:, page] = torch.as_tensor(k).to(dev, self.kpool.dtype)
        self.vpool[:, page] = torch.as_tensor(v).to(dev, self.vpool.dtype)
        if self.kv_quant:
            self.kscale[:, page] = torch.as_tensor(kscale).to(
                dev, torch.float32)
            self.vscale[:, page] = torch.as_tensor(vscale).to(
                dev, torch.float32)

    def _check_page_scales(self, kscale, vscale):
        if self.kv_quant and (kscale is None or vscale is None):
            raise ValueError(
                "int8 KV pages restore with their scales: "
                "write_page(page, k, v, kscale, vscale)")

    def release(self):
        """Drop the KV pools and the placed weights (engine recovery
        frees a dead runner's device memory before the rebuilt runner
        allocates its own, so both never hold it at once).  The decode
        state stays: a released runner still takes slot parks."""
        self.kpool = self.vpool = self.kscale = self.vscale = None
        self.state = None

    @torch.no_grad()
    def push_slot(self, slot: int, row: np.ndarray, pos: int, tok: int,
                  active: int, adapter_row: int = 0):
        """Patch ONE slot's row of the device-resident decode state
        (admission / eviction only — never per step)."""
        self._table_dev[slot] = torch.as_tensor(row, device=self.device)
        self._pos_dev[slot] = int(pos)
        self._tok_dev[slot] = int(tok)
        self._active_dev[slot] = int(active)
        if self.lora_slots:
            self._aidx_dev[slot] = int(adapter_row)

    def mesh_info(self) -> dict:
        """Device memory of the runner's one device, in the reference's
        per-mesh-position shape (``tp`` 1, position 0): the KV pool,
        weight and adapter-bank footprints, plus the CUDA allocator's
        live and peak bytes on a card (a CPU runner reports the
        footprints alone)."""
        return {"tp": 1, "axis": "tp", "kv_quant": self.kv_quant,
                "devices": [self.mesh_entry()]}

    def mesh_entry(self) -> dict:
        """This rank's entry of :meth:`mesh_info`: its device, its mesh
        position and its footprints (its shards at tp > 1)."""
        def nbytes(t):
            if t is None:
                return 0
            if isinstance(t, QuantizedWeight):
                return nbytes(t.q) + nbytes(t.scale)
            return t.numel() * t.element_size()

        pools = (self.kpool, self.vpool, self.kscale, self.vscale)
        dev = self.device
        idx = dev.index if dev.index is not None else (
            torch.cuda.current_device() if dev.type == "cuda" else 0)
        if dev.type == "cpu":
            idx = self.rank         # a CPU rank is a process, not a card
        entry = {"device": f"{dev.type}:{idx}", "tp": self.rank,
                 "kv_pool_bytes": sum(nbytes(t) for t in pools),
                 "weight_bytes": sum(nbytes(t) for t in
                                     (self.state or {}).values()),
                 "lora_bank_bytes": self.lora_bank_bytes()}
        if dev.type == "cuda":
            stats = torch.cuda.memory_stats(dev)
            entry["bytes_in_use"] = int(stats.get(
                "allocated_bytes.all.current", 0))
            entry["peak_bytes_in_use"] = int(stats.get(
                "allocated_bytes.all.peak", 0))
        return entry

    def rank_state(self) -> dict:
        """This rank's device decode state on the host (the ring, pos and
        tok): the check that every rank feeds the same token back."""
        return {"ring": self._ring_dev.cpu().numpy(),
                "pos": self._pos_dev.cpu().numpy(),
                "tok": self._tok_dev.cpu().numpy()}

    def fetch_ring(self) -> np.ndarray:
        """The host sync: ONE [sync_interval, slots] int32 transfer."""
        return self._ring_dev.cpu().numpy()

    @torch.no_grad()
    def correct_tokens(self, corrections: list[tuple[int, int]]):
        """Push host-side sampling picks back into the device token
        state before the next step."""
        idx = torch.as_tensor([s for s, _ in corrections], device=self.device)
        val = torch.as_tensor([t for _, t in corrections], dtype=torch.int32,
                              device=self.device)
        self._tok_dev[idx] = val

    def reinject_step(self):
        """Rebuild the decode-step program (perf-gate hook: its next run
        counts as a fresh trace, so retrace detection can be exercised
        deterministically)."""
        self._step_fn = self._build_step()


def _prefill_layer_cached(w, x, kpre, vpre, cos_s, sin_s, mask, cfg,
                          lora=(), aidx=None, li=0, axis=None):
    """One transformer layer of suffix prefill against a resident
    prefix: ``x`` [1, S, H] suffix hidden, ``kpre``/``vpre``
    [1, Tpre, kvH, D] prefix KV gathered from the pool (keys already
    rotary-encoded at their absolute positions), ``mask``
    [1, 1, S, Tpre + S] bool.  Returns (out, k_suffix, v_suffix).
    Under a tp ``axis``: this rank's heads, o and down all-reduced."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = _rms(x, w["ln1"], cfg.rms_norm_eps)
    qp, kp, vp = _qkv_proj(w, h, lora, aidx, li)
    nh, kvh = qp.shape[-1] // hd, kp.shape[-1] // hd
    q = qp.reshape(b, s, nh, hd)
    k = kp.reshape(b, s, kvh, hd)
    v = vp.reshape(b, s, kvh, hd)
    cos_c = cos_s[None, :, None, :].to(q.dtype)
    sin_c = sin_s[None, :, None, :].to(q.dtype)
    q = q * cos_c + _rotate_half(q) * sin_c
    k = k * cos_c + _rotate_half(k) * sin_c
    kcat = torch.cat([kpre.to(k.dtype), k], dim=1)
    vcat = torch.cat([vpre.to(v.dtype), v], dim=1)
    attn = sdpa(q, kcat, vcat, attn_mask=mask,
                is_causal=False).reshape(b, s, nh * hd)
    x = x + _out_proj(w, attn, lora, aidx, li, axis)
    h = _rms(x, w["ln2"], cfg.rms_norm_eps)
    return x + _ffn(w, h, lora, aidx, li, axis), k, v


def _logits_of(state, h):
    head = state.get("lm_head.weight")
    if head is not None:
        return _mm(h, head)
    return h @ state["llama.embed_tokens.weight"].T


# ----------------------------------------------- the shards, by scatter
def _leaf_parts(key, v):
    """The tensors of one state leaf with the dim tp splits (None:
    replicated): ``[("w", t, axis)]`` for a tensor; values and scales
    for a :class:`QuantizedWeight` (scales split with the columns,
    replicated with the rows)."""
    axis = serving_shard_axis(key)
    if isinstance(v, QuantizedWeight):
        return [("q", v.q, axis), ("scale", v.scale,
                                   0 if axis == 1 else None)]
    return [("w", v, axis)]


def state_spec(state: dict) -> list:
    """What the other ranks need to receive their shards of ``state``:
    per key, its kind (a tensor, or a quantized leaf's kind and logical
    K) and each part's name, full shape, dtype and split dim."""
    spec = []
    for key, v in state.items():
        kind = (("quant", v.kind, v.k) if isinstance(v, QuantizedWeight)
                else ("tensor",))
        spec.append((key, kind, [(name, tuple(t.shape), str(t.dtype), axis)
                                 for name, t, axis in _leaf_parts(key, v)]))
    return spec


def _scatter_state(state, tp, rank, device):
    """This rank's shard of the serving state on ``device``: rank 0 holds
    ``state`` (the full dict) and scatters each split part and
    broadcasts each replicated one; the other ranks hold its
    :func:`state_spec` and receive."""
    full = state if isinstance(state, dict) else None
    spec = state_spec(full) if full is not None else state
    out = {}
    for key, kind, parts in spec:
        got = {}
        for i, (name, shape, dtype, axis) in enumerate(parts):
            dt = getattr(torch, dtype.rpartition(".")[2])
            local = list(shape)
            if axis is not None:
                local[axis] //= tp
            t = torch.empty(local, dtype=dt, device=device)
            if axis is None:
                if full is not None:
                    t.copy_(_leaf_parts(key, full[key])[i][1])
                C.broadcast(t, src=0)
            else:
                pieces = None
                if full is not None:
                    pieces = [shard_serving_leaf(key, full[key], tp, r)
                              for r in range(tp)]
                    pieces = [(p if kind[0] == "tensor"
                               else getattr(p, name)).to(device)
                              for p in pieces]
                C.scatter(t, pieces, src=0)
            got[name] = t
        if kind[0] == "tensor":
            out[key] = got["w"]
        else:
            k = kind[2] // tp if parts[0][3] == 0 else kind[2]
            out[key] = QuantizedWeight(got["q"], got["scale"], kind=kind[1],
                                       k=k)
    return out
