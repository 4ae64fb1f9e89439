"""KV-page allocator + automatic prefix cache for the serving engine.

Ports ``paddle_tpu/serving/block_manager.py`` by copy (host-side, with
the reference's flight-recorder events and usage-meter hooks).  Each
sequence owns a list of fixed-size pages in one shared pool, so device
memory scales with the tokens actually resident, not batch * max_len.
The host spill tier holds whatever ``ModelRunner.read_page`` returns
(CPU tensors: numpy has no bfloat16) and prices it by ``nbytes``, as the
reference prices its numpy pages.

Unlike :class:`~paddle_tpu_torch.ops.pallas.paged_attention.PagedPool` (which
reserves pages for ONE static batch up front), this manager serves a
changing request population: pages cycle through a free list as
requests are admitted and evicted, and an allocation that does not fit
returns ``None`` — backpressure the scheduler turns into queueing,
never an exception out of the engine.

With ``enable_prefix_cache=True`` the manager additionally runs
automatic prefix caching (vLLM's hash-based PagedAttention reuse /
SGLang's RadixAttention, restructured as a chain index over pages):

  * every page holding a **page_size-aligned full chunk** of a prompt
    is registered in a chain index keyed ``(parent page, token chunk)``
    — exact-match keys, so a recycled parent id can never alias a stale
    chain (children are detached before a parent is ever reused);
  * a later request walks its prompt chunk-by-chunk down the chain and
    **shares** every page it matches (refcount++), paying pages only
    for the unmatched suffix — admission is charged for *new* pages
    only, which is what raises effective pool capacity;
  * the **partially-filled tail page** of a prompt is indexed with its
    token content; a new request whose suffix extends a matching tail
    gets a **copy-on-write** source: the engine copies the page's KV
    rows into the request's own tail page and recomputes only from the
    divergence point (the shared copy is never written);
  * when a sequence releases its pages, registered pages with refcount
    0 park in an **LRU** side pool instead of the free list; under
    pressure the allocator evicts LRU pages leaf-first (a page is only
    evicted once no cached chain or tail hangs off it), so the free
    list is a floor, not a ceiling, on allocatable pages.

The dump-page convention matches the paged kernel's contract: page id
``num_pages`` is a shared scratch page that absorbs writes through
table padding; it is never handed to a sequence.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque

import numpy as np

from .. import observability as _obs
from ..flags import FLAGS

__all__ = ["BlockManager"]

_M_PAGES_IN_USE = _obs.gauge(
    "serving_pages_in_use", "KV pages currently owned by live sequences")
_M_PAGES_TOTAL = _obs.gauge(
    "serving_pages_total", "allocatable KV pages in the engine pool")
_M_PREFIX_PAGES = _obs.counter(
    "serving_prefix_cache_pages_total",
    "full-chunk prefix-cache lookups by result", ("result",))
_M_PREFIX_TOKENS = _obs.counter(
    "serving_prefix_cached_tokens_total",
    "prompt tokens whose prefill was skipped via the prefix cache")
_M_PREFIX_EVICT = _obs.counter(
    "serving_prefix_cache_evictions_total",
    "cached refcount-0 pages evicted (LRU, leaf-first) under pressure")
_M_PREFIX_COW = _obs.counter(
    "serving_prefix_cache_cow_total",
    "copy-on-write page copies for partially-filled tail pages")
_M_CACHED_PAGES = _obs.gauge(
    "serving_prefix_cached_pages",
    "pages currently registered in the prefix index (incl. shared)")
_M_PAGES_FREE = _obs.gauge(
    "serving_pages_free", "KV pages on the free list (parked cached "
    "pages are reusable but counted separately)")
_M_FRAG = _obs.gauge(
    "serving_page_fragmentation_ratio",
    "fraction of idle pages (free + parked cached) the largest waiting "
    "request cannot use (0: nothing waiting or all idle pages usable; "
    "1: the queue head cannot be placed at all)")
_M_PAGES_ALLOC = _obs.counter(
    "serving_pages_allocated_total",
    "fresh page acquisitions (free-list pops + LRU evictions; shared "
    "prefix-cache pages are not re-acquired)")
_M_SPILLED = _obs.counter(
    "serving_spilled_pages_total",
    "KV pages copied device -> host RAM when a resident was preempted "
    "for a higher-priority request")
_M_RESTORED = _obs.counter(
    "serving_restored_pages_total",
    "host-parked KV pages copied back to device on preempted-request "
    "resume (prefill skipped for those positions)")
_M_SPILL_BYTES = _obs.counter(
    "serving_spill_bytes_total",
    "bytes of KV copied device -> host by preemption spills")
_M_HOST_PARKED = _obs.gauge(
    "serving_host_spill_pages",
    "KV pages currently parked in the host-RAM spill tier "
    "(content-addressed, LRU-bounded by FLAGS_serving_host_pages)")

_ROOT = -1          # chain parent of the first chunk of every prompt


def _root(adapter):
    """The chain root a prompt's first chunk hangs from: ``_ROOT`` for
    the dense model (``adapter=None``, the reference's single root, so
    dense chains and ``pool_accounting()`` stay the reference's), one
    root per adapter name otherwise.  KV depends on the adapter (its
    k/v deltas), so requests share prefix pages only when both their
    tokens and their adapter match — the reference keys by tokens alone
    and would hand one adapter's KV to another.  The host spill tier
    keys its pages the same way (:meth:`BlockManager.spill_digest`)."""
    return _ROOT if adapter is None else (_ROOT, str(adapter))


class BlockManager:
    """Free-list page allocator + per-sequence block tables (+ optional
    prefix cache).

    ``num_pages`` is the number of *allocatable* pages; the pool arrays
    the engine builds must hold ``num_pages + 1`` rows (the extra row is
    the dump page, :attr:`dump_page`).
    """

    def __init__(self, num_pages: int, page_size: int,
                 enable_prefix_cache: bool = False, faults=None,
                 host_pages: int | None = None):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if host_pages is None:
            host_pages = int(FLAGS.get("FLAGS_serving_host_pages") or 0)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.host_pages = max(int(host_pages), 0)
        self.dump_page = self.num_pages       # pool row past the real pages
        self.prefix_cache = bool(enable_prefix_cache)
        self.faults = faults                  # chaos harness (None = off)
        # FIFO reuse keeps page churn spread across the pool; a deque
        # makes both ends O(1) (popping the head of a plain list shifts
        # the whole tail on every acquisition)
        self._free: deque[int] = deque(range(self.num_pages))
        self._tables: dict[int, list[int]] = {}   # seq id -> owned pages
        self._ref: dict[int, int] = {}            # page -> live-seq refs
        self._meta: dict[int, dict] = {}          # seq id -> prefill plan
        # committed-token ledger (speculative append/rollback): seq id ->
        # {"committed", "floor", "capacity"} token counts
        self._commit: dict[int, dict] = {}
        # prefix-cache state.  Chain index: (parent page, chunk) -> page;
        # tail index: parent page -> {page: partial-chunk tokens}.
        self._index: dict[tuple, int] = {}
        self._key_of: dict[int, tuple] = {}       # page -> its chain key
        self._tails: dict[int, dict[int, tuple]] = {}
        self._tail_parent: dict[int, int] = {}    # tail page -> parent
        self._children: dict[int, set] = {}       # page -> cached children
        self._lru: OrderedDict[int, None] = OrderedDict()
        # host spill tier (preempt-and-swap): content-addressed KV page
        # copies keyed by the sha1 of the absolute token prefix they
        # cover — under greedy causal attention a page's KV depends only
        # on that prefix, so any sequence sharing it can unpark the copy
        self._host: OrderedDict[str, tuple] = OrderedDict()
        # chunked-prefill publish deferral: when the engine will prefill
        # an admission in chunks of this many tokens, allocate_seq skips
        # chain registration (the pages hold no KV yet) and the engine
        # calls publish_seq once the last chunk has landed (0 = off)
        self.defer_publish = 0
        # usage meter (observability.usage.UsageMeter) fed page
        # hold/release and host-tier eviction events for the
        # page-seconds ledger; None (the default) costs one attribute
        # test per allocation — the engine wires it when metering is on
        self.usage = None
        # python-side mirrors of the serving_prefix_* metrics (stats())
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_evictions = 0
        self.cow_copies = 0
        self.cached_tokens = 0
        self.pages_allocated = 0    # mirror of serving_pages_allocated_total
        self.spilled_pages = 0      # mirror of serving_spilled_pages_total
        self.restored_pages = 0     # mirror of serving_restored_pages_total
        self.spill_bytes = 0        # mirror of serving_spill_bytes
        _M_PAGES_TOTAL.set(self.num_pages)
        self._update_pool_gauges()

    # ------------------------------------------------------------- sizing
    def pages_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Pages a request reserves for its whole lifetime (prompt +
        every token it may generate) — admission is all-or-nothing, so
        an admitted request can never hit pool exhaustion mid-decode."""
        return -(-(int(prompt_len) + int(max_new_tokens)) // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        """Pages registered in the prefix index (shared or parked)."""
        return len(self._key_of) + len(self._tail_parent)

    @property
    def pages_in_use(self) -> int:
        """Pages owned by live sequences.  Cached refcount-0 pages in
        the LRU side pool are reusable, so they do not count."""
        return self.num_pages - len(self._free) - len(self._lru)

    def can_allocate(self, n: int) -> bool:
        return n <= len(self._free) + len(self._lru)

    # --------------------------------------------------------- alloc/free
    def allocate(self, seq_id: int, n: int):
        """Reserve ``n`` pages for ``seq_id``.  Returns the page-id list,
        or ``None`` when the pool cannot satisfy the request
        (backpressure — the caller keeps the request queued)."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already owns pages")
        pages = self._acquire(n)
        if pages is None:
            return None
        for p in pages:
            self._ref[p] = 1
        self._tables[seq_id] = pages
        self._meta[seq_id] = {"cached_len": 0, "cow_src": None}
        self._commit[seq_id] = {"committed": 0, "floor": 0,
                                "capacity": n * self.page_size}
        _obs.flight("blocks", "alloc_seq", seq=seq_id, pages=len(pages),
                    shared=0, cached_tokens=0, cow=False)
        if self.usage is not None:
            self.usage.on_hold(seq_id, pages, fresh=len(pages))
        self._update_pool_gauges()
        return list(pages)

    def allocate_seq(self, seq_id: int, prompt, max_new_tokens: int,
                     adapter=None):
        """Admission entry point: match ``prompt`` against the prefix
        cache under ``adapter``'s chain root (``None`` = dense), share
        matched pages, and reserve fresh pages for the suffix only.
        Returns the sequence's full page list (shared prefix first) or
        ``None`` on backpressure.  The prefill plan
        (``cached_len``, ``cow_src``) is retrievable via
        :meth:`seq_meta` until :meth:`free_seq`."""
        if not self.prefix_cache:
            pages = self.allocate(seq_id,
                                  self.pages_needed(len(prompt),
                                                    max_new_tokens))
            if pages is not None:
                c = self._commit[seq_id]
                c["committed"] = c["floor"] = len(prompt)
            return pages
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already owns pages")
        prompt = tuple(int(t) for t in np.asarray(prompt).reshape(-1))
        plen = len(prompt)
        ps = self.page_size
        total = self.pages_needed(plen, max_new_tokens)
        full = plen // ps

        # walk the chain index chunk by chunk
        root = _root(adapter)
        matched: list[int] = []
        parent = root
        for c in range(full):
            page = self._index.get((parent, prompt[c * ps:(c + 1) * ps]))
            if page is None:
                break
            matched.append(page)
            parent = page
        if matched and len(matched) * ps >= plen:
            # full-prompt hit: drop the last match so at least one token
            # still runs through the model (its logits seed decoding)
            matched.pop()
            parent = matched[-1] if matched else root
        m = len(matched)
        self.prefix_hits += m
        self.prefix_misses += full - m
        if m:
            _M_PREFIX_PAGES.labels("hit").inc(m)
        if full - m:
            _M_PREFIX_PAGES.labels("miss").inc(full - m)

        # protect the matched chain, then acquire the suffix pages (the
        # acquire may LRU-evict; refcounted pages are never candidates)
        for p in matched:
            self._incref(p)
        fresh = self._acquire(total - m)
        if fresh is None:
            for p in matched:
                self._decref(p)
            self._update_pool_gauges()
            return None
        for p in fresh:
            self._ref[p] = 1

        # copy-on-write probe AFTER acquiring (the acquire could have
        # evicted a tail candidate): longest common prefix between the
        # prompt's remainder and a cached partial tail under `parent`
        cached_len = m * ps
        cow_src = None
        rem = prompt[m * ps:]
        best_cp = 0
        for page, toks in self._tails.get(parent, {}).items():
            cp = 0
            for a, b in zip(rem, toks):
                if a != b:
                    break
                cp += 1
            # cap so at least one prompt token is left to recompute
            cp = min(cp, plen - m * ps - 1)
            if cp > best_cp:
                best_cp, cow_src = cp, page
        if cow_src is not None:
            cached_len += best_cp
            self.cow_copies += 1
            _M_PREFIX_COW.inc()

        self.cached_tokens += cached_len
        if cached_len:
            _M_PREFIX_TOKENS.inc(cached_len)

        # chunked admissions defer registration: the fresh pages hold no
        # KV until their chunk runs, and a concurrent admission matching
        # them in the meantime would attend over unwritten pages —
        # publish_seq re-runs the registration after the last chunk
        deferred = bool(self.defer_publish
                        and plen - cached_len > self.defer_publish)

        pages = matched + fresh
        self._tables[seq_id] = pages
        self._meta[seq_id] = {"cached_len": cached_len, "cow_src": cow_src,
                              "deferred": deferred}
        self._commit[seq_id] = {"committed": plen, "floor": plen,
                                "capacity": total * ps}
        _obs.flight("blocks", "alloc_seq", seq=seq_id, pages=len(pages),
                    shared=m, cached_tokens=cached_len,
                    cow=cow_src is not None)
        if self.usage is not None:
            self.usage.on_hold(seq_id, pages, fresh=len(fresh))

        # register this prompt's fresh full chunks (chain through any
        # page an identical chunk already cached)
        for c in range(m, full):
            if deferred:
                break
            key = (parent, prompt[c * ps:(c + 1) * ps])
            existing = self._index.get(key)
            if existing is not None:
                parent = existing
                continue
            page = pages[c]
            self._index[key] = page
            self._key_of[page] = key
            self._children.setdefault(parent, set()).add(page)
            parent = page
        # register the partial tail (its prompt-token content is final:
        # decode writes only to later slots of the page)
        off = plen - full * ps
        if off > 0 and not deferred:
            tail_toks = prompt[full * ps:]
            tails = self._tails.setdefault(parent, {})
            if tail_toks not in tails.values():
                page = pages[full]
                tails[page] = tail_toks
                self._tail_parent[page] = parent
                self._children.setdefault(parent, set()).add(page)
        _M_CACHED_PAGES.set(self.cached_pages)
        self._update_pool_gauges()
        return list(pages)

    def publish_seq(self, seq_id: int, tokens, adapter=None):
        """Deferred chain registration for a chunk-prefilled admission.

        :meth:`allocate_seq` skips chain/tail registration when the
        engine will prefill in chunks (``meta["deferred"]``); the
        engine calls this once the last chunk has landed, passing
        exactly the token prefix whose KV is now device-resident and
        the ``adapter`` it was prefilled under.  Idempotent and a no-op
        for non-deferred sequences."""
        meta = self._meta.get(seq_id)
        pages = self._tables.get(seq_id)
        if (not self.prefix_cache or not meta or not pages
                or not meta.pop("deferred", False)):
            return
        toks = tuple(int(t) for t in np.asarray(tokens).reshape(-1))
        ps = self.page_size
        full = min(len(toks) // ps, len(pages))
        parent = _root(adapter)
        for c in range(full):
            key = (parent, toks[c * ps:(c + 1) * ps])
            existing = self._index.get(key)
            if existing is not None:
                parent = existing
                continue
            page = pages[c]
            if page in self._key_of or page in self._tail_parent:
                parent = page         # already carries another key
                continue
            self._index[key] = page
            self._key_of[page] = key
            self._children.setdefault(parent, set()).add(page)
            parent = page
        off = len(toks) - full * ps
        if off > 0 and full < len(pages):
            page = pages[full]
            tail_toks = toks[full * ps:]
            tails = self._tails.setdefault(parent, {})
            if (tail_toks not in tails.values()
                    and page not in self._key_of
                    and page not in self._tail_parent):
                tails[page] = tail_toks
                self._tail_parent[page] = parent
                self._children.setdefault(parent, set()).add(page)
        _obs.flight("blocks", "publish_seq", seq=seq_id,
                    chunks=full, tail=off)
        _M_CACHED_PAGES.set(self.cached_pages)

    def seq_meta(self, seq_id: int) -> dict:
        """The prefill plan recorded at admission: ``cached_len`` tokens
        already resident (prefill runs only the suffix) and ``cow_src``,
        the tail page to copy-on-write from (or None)."""
        meta = self._meta.get(seq_id)
        if meta is None:
            return {"cached_len": 0, "cow_src": None}
        # "deferred" is internal publish bookkeeping, not plan state
        return {"cached_len": meta["cached_len"],
                "cow_src": meta["cow_src"]}

    def free_seq(self, seq_id: int):
        """Release ``seq_id``'s pages (idempotent).  Registered pages
        whose refcount hits 0 park in the LRU pool (still matchable);
        unregistered pages return to the free list."""
        pages = self._tables.pop(seq_id, None)
        self._meta.pop(seq_id, None)
        self._commit.pop(seq_id, None)
        if pages:
            if self.usage is not None:
                self.usage.on_release(seq_id, pages)
            for p in pages:
                self._decref(p)
        self._update_pool_gauges()

    def pages_of(self, seq_id: int):
        return list(self._tables.get(seq_id, ()))

    # ---------------------------------------------------------- recovery
    def flush_prefix_cache(self) -> int:
        """Invalidate every prefix-cache registration and free the
        parked LRU pages.  Called when the device KV pool is rebuilt
        (engine recovery): the chain index describes KV *content* that
        no longer exists, so any future match would share garbage.
        Live sequences keep their tables/refcounts — their content is
        regenerated by replay — but their pages are unregistered, so a
        later free sends them to the free list, not the LRU.  Returns
        the number of registrations dropped."""
        dropped = len(self._key_of) + len(self._tail_parent)
        for page in self._lru:
            self._free.append(page)
        self._lru.clear()
        self._index.clear()
        self._key_of.clear()
        self._tails.clear()
        self._tail_parent.clear()
        self._children.clear()
        _M_CACHED_PAGES.set(self.cached_pages)
        self._update_pool_gauges()
        if dropped:
            _obs.flight("blocks", "prefix_flush", dropped=dropped)
        return dropped

    def replay_plan(self, seq_id: int, tokens, adapter=None) -> dict:
        """Prefill plan for re-running ``seq_id``'s committed ``tokens``
        (prefilled under ``adapter``, ``None`` = dense) through the
        model after a runner rebuild (the sequence still owns its
        pages; only device KV content was lost).

        Walks the chain index like admission, but a chunk only counts
        as cached when the index maps it to **this sequence's own
        page** — sharers hold identical page ids, so once one of them
        has replayed, the others' leading chunks match and their
        replay prefills only the unshared suffix.  The replayed full
        chunks are (re-)registered on the sequence's own pages; partial
        tails are not re-registered (past the prompt they contain
        generated tokens, which admission-time tail matching must never
        see).  Returns ``{"cached_len", "hits", "misses"}``; at least
        one token is always left to recompute."""
        pages = self._tables.get(seq_id)
        if pages is None:
            raise ValueError(f"sequence {seq_id} owns no pages")
        if not self.prefix_cache:
            return {"cached_len": 0, "hits": 0, "misses": 0}
        tokens = tuple(int(t) for t in np.asarray(tokens).reshape(-1))
        ps = self.page_size
        full = len(tokens) // ps
        matched = 0
        parent = _root(adapter)
        for c in range(full):
            page = self._index.get((parent, tokens[c * ps:(c + 1) * ps]))
            if page is None or page != pages[c]:
                break
            matched += 1
            parent = page
        cached_len = min(matched * ps, len(tokens) - 1)
        self.prefix_hits += matched
        self.prefix_misses += full - matched
        if matched:
            _M_PREFIX_PAGES.labels("hit").inc(matched)
        if full - matched:
            _M_PREFIX_PAGES.labels("miss").inc(full - matched)
        if cached_len:
            self.cached_tokens += cached_len
            _M_PREFIX_TOKENS.inc(cached_len)
        # re-register the chunks this replay regenerates, chaining
        # through any page an identical chunk already re-cached
        for c in range(matched, full):
            key = (parent, tokens[c * ps:(c + 1) * ps])
            existing = self._index.get(key)
            if existing is not None:
                parent = existing
                continue
            page = pages[c]
            if page in self._key_of:      # already carries another key
                parent = page
                continue
            self._index[key] = page
            self._key_of[page] = key
            self._children.setdefault(parent, set()).add(page)
            parent = page
        _M_CACHED_PAGES.set(self.cached_pages)
        return {"cached_len": cached_len, "hits": matched,
                "misses": full - matched}

    # ------------------------------------ host spill tier (preemption)
    def spill_digest(self, tokens, chunk: int, adapter=None) -> str:
        """Content address of page ``chunk``'s KV: sha1 over the int32
        bytes of the absolute token prefix the page covers.  Greedy
        causal attention makes KV a pure function of that prefix and
        the adapter (its k/v deltas), so the digest is valid across
        sequences and across preempt/resume cycles of the same request;
        an adapter's name is hashed after the tokens (the dense digest
        is the reference's)."""
        ps = self.page_size
        data = np.asarray(tokens, np.int32).reshape(-1)[:(chunk + 1) * ps]
        h = hashlib.sha1(data.tobytes())
        if adapter is not None:
            h.update(b"\0adapter:" + str(adapter).encode())
        return h.hexdigest()

    def spill_plan(self, seq_id: int, tokens, adapter=None) -> list:
        """``(page, digest)`` pairs worth copying to host before
        ``seq_id`` is preempted: exclusive (refcount-1) pages holding a
        *complete* chunk of committed KV.  After a sync the device KV
        covers positions ``0..len(tokens)-2`` (the last emitted token's
        KV is written by the next decode step), so chunk ``c`` is
        complete iff ``(c+1)*page_size <= len(tokens)-1``.  Shared
        pages are skipped — they stay matchable through the chain
        index; pages whose digest is already parked are skipped too
        (content-addressed: the copy exists)."""
        if self.host_pages <= 0:
            return []
        pages = self._tables.get(seq_id)
        if not pages:
            return []
        toks = np.asarray(tokens, np.int32).reshape(-1)
        full = max(0, (toks.size - 1) // self.page_size)
        plan = []
        for c in range(min(full, len(pages))):
            page = pages[c]
            if self._ref.get(page, 0) != 1:
                continue
            digest = self.spill_digest(toks, c, adapter)
            if digest in self._host:
                self._host.move_to_end(digest)
                continue
            plan.append((page, digest))
        return plan

    def host_put(self, digest: str, *arrays):
        """Park one page's KV in the host tier (LRU-bounded).

        Variadic: dense pages park ``(k, v)``; int8 KV pages park
        ``(k, v, kscale, vscale)`` — the quantized bytes plus their f32
        scales, never a dequantized copy, which is what makes
        ``spill_bytes`` genuinely shrink under ``kv_quant``.  The byte
        ledger sums the actual itemsize of whatever was parked (torch
        tensors, from the runner, are kept as they are)."""
        arrays = tuple(a if hasattr(a, "nbytes") else np.asarray(a)
                       for a in arrays)
        self._host[digest] = arrays
        self._host.move_to_end(digest)
        while len(self._host) > self.host_pages:
            dropped, _ = self._host.popitem(last=False)
            if self.usage is not None:
                self.usage.on_host_evict(dropped)
        nbytes = sum(a.nbytes for a in arrays)
        self.spilled_pages += 1
        self.spill_bytes += nbytes
        _M_SPILLED.inc()
        _M_SPILL_BYTES.inc(nbytes)
        _M_HOST_PARKED.set(len(self._host))

    def host_probe(self, digest: str) -> bool:
        return digest in self._host

    @property
    def host_parked(self) -> int:
        """Pages currently parked in the host spill tier."""
        return len(self._host)

    def host_get(self, digest: str):
        """The parked array tuple for ``digest`` (LRU-touched), or
        None — ``(k, v)`` dense, ``(k, v, kscale, vscale)`` int8."""
        entry = self._host.get(digest)
        if entry is not None:
            self._host.move_to_end(digest)
        return entry

    def host_discard(self, digests):
        """Drop parked entries (failed-spill abort path)."""
        for d in digests:
            if self._host.pop(d, None) is not None \
                    and self.usage is not None:
                self.usage.on_host_evict(d)
        _M_HOST_PARKED.set(len(self._host))

    def note_restored(self, n: int = 1):
        """Account ``n`` host-parked pages copied back to device."""
        self.restored_pages += n
        _M_RESTORED.inc(n)

    def release_preempted(self, seq_id: int, tokens, adapter=None):
        """Release a preempted sequence's pages after its exclusive KV
        was spilled to host.  With the prefix cache on, the complete
        committed chunks are first (re-)registered in the chain index
        under ``adapter``'s root — replay_plan-style, on the sequence's
        own pages — so they park
        in the LRU instead of the free list and the resume admission
        matches them without recomputing.  Partial tails are never
        registered (past the prompt they hold generated tokens, which
        admission-time tail matching must not see)."""
        if self.prefix_cache and seq_id in self._tables:
            pages = self._tables[seq_id]
            toks = tuple(int(t)
                         for t in np.asarray(tokens).reshape(-1))
            ps = self.page_size
            full = min(max(0, (len(toks) - 1) // ps), len(pages))
            parent = _root(adapter)
            for c in range(full):
                key = (parent, toks[c * ps:(c + 1) * ps])
                existing = self._index.get(key)
                if existing is not None:
                    parent = existing
                    continue
                page = pages[c]
                if page in self._key_of:  # already carries another key
                    parent = page
                    continue
                self._index[key] = page
                self._key_of[page] = key
                self._children.setdefault(parent, set()).add(page)
                parent = page
            _M_CACHED_PAGES.set(self.cached_pages)
        self.free_seq(seq_id)

    # ------------------------------------- committed tokens (speculative)
    # Pages are reserved all-or-nothing at admission, so speculative
    # decoding never allocates mid-flight; what moves is the
    # committed-token ledger.  A verify step appends all k+1 proposed
    # positions, then rolls the rejected suffix back, so the ledger
    # charges pages (ceil(committed / page_size)) for ACCEPTED tokens
    # only.  Page ids never move and refcounts are untouched, which is
    # what keeps CoW/prefix-cache sharing safe under rollback: a
    # rejected position's stale KV sits past the sequence's visible
    # length (`lens = pos + 1` masks it) until a later append overwrites
    # it in place.

    def committed_tokens(self, seq_id: int) -> int:
        """Tokens durably owned by ``seq_id`` (prompt + accepted)."""
        return int(self._commit.get(seq_id, {}).get("committed", 0))

    def committed_pages(self, seq_id: int) -> int:
        """Pages charged for the committed tokens — the accepted-only
        page charge the speculative path reports against the all-or-
        nothing reservation."""
        c = self.committed_tokens(seq_id)
        return -(-c // self.page_size)

    def append(self, seq_id: int, n: int) -> int:
        """Advance ``seq_id``'s committed-token count by ``n`` (the
        multi-token path: a verify step appends all k+1 proposed
        positions at once).  Raises if the sequence is unknown or the
        append would overrun its admission reservation — admitted
        requests can never legally hit this.  Returns the new count."""
        c = self._commit.get(seq_id)
        if c is None:
            raise ValueError(f"sequence {seq_id} owns no pages")
        if n < 0:
            raise ValueError(f"append of {n} tokens (use rollback)")
        if c["committed"] + n > c["capacity"]:
            raise ValueError(
                f"sequence {seq_id}: appending {n} tokens overruns the "
                f"reservation ({c['committed']} committed, capacity "
                f"{c['capacity']})")
        c["committed"] += n
        return c["committed"]

    def rollback(self, seq_id: int, n: int) -> int:
        """Retreat ``seq_id``'s committed-token count by ``n`` rejected
        speculative positions.  Raises if that would drop below the
        admission content (the prompt) — rollback can only undo
        speculation, never durable tokens, so prefix-cache chunks
        registered at admission stay valid.  Returns the new count."""
        c = self._commit.get(seq_id)
        if c is None:
            raise ValueError(f"sequence {seq_id} owns no pages")
        if n < 0:
            raise ValueError(f"rollback of {n} tokens (use append)")
        if c["committed"] - n < c["floor"]:
            raise ValueError(
                f"sequence {seq_id}: rolling back {n} tokens drops below "
                f"the admission content ({c['committed']} committed, "
                f"floor {c['floor']})")
        c["committed"] -= n
        return c["committed"]

    # --------------------------------------------------- pool accounting
    def _update_pool_gauges(self):
        _M_PAGES_IN_USE.set(self.pages_in_use)
        _M_PAGES_FREE.set(len(self._free))

    def pool_accounting(self) -> dict:
        """Exact pool census from three independent structures.  Every
        allocatable page is in exactly one of: referenced by a live
        sequence (``live``), parked refcount-0 in the prefix LRU
        (``cached``), or on the free list (``free``) — ``leak`` is the
        shortfall and must be 0 (asserted by tests, surfaced here so a
        future accounting bug shows up in /debug/resources, not as a
        slow pool shrink)."""
        live = len(self._ref)
        cached = len(self._lru)
        free = len(self._free)
        return {"live": live, "cached": cached, "free": free,
                "total": self.num_pages,
                "allocated_total": self.pages_allocated,
                "host_parked": len(self._host),
                "leak": self.num_pages - (live + cached + free)}

    def prefix_digest(self, max_entries: int = 64) -> dict:
        """Compact cached-chain summary for the fleet plane: the sha1
        digest (first 16 hex chars) of every *root-level* cached chunk
        of the dense model's chains (adapter chains hang from their own
        roots and are not published),
        hashed over the same int32 token bytes as the router's
        affinity key — so the router can match an incoming prompt's
        first page-aligned chunk against a replica's published digests
        and estimate its expected prefix-hit rate without shipping
        token ids over the wire."""
        roots = sorted(
            hashlib.sha1(np.asarray(chunk, np.int32).tobytes())
            .hexdigest()[:16]
            for (parent, chunk) in self._index if parent == _ROOT)
        return {"page_size": self.page_size,
                "roots": roots[:max_entries],
                "dropped": max(0, len(roots) - max_entries),
                "cached_pages": self.cached_pages,
                "cached_tokens": self.cached_tokens}

    def pool_bytes(self, *, num_layers: int, num_kv_heads: int,
                   head_dim: int, dtype_itemsize: int, tp: int = 1,
                   kv_quant: bool = False) -> dict:
        """KV pool sizing for the engine's pool arrays, head-sharded
        over a tp-way mesh.  The pool the runner builds is
        ``2 * [L, num_pages+1, kvh, page_size, hd]`` (k + v, one extra
        dump row); sharding along the head axis divides exactly that by
        ``tp`` per device, while the page table (and this manager's
        whole accounting) stays host-side and mesh-agnostic — the same
        page ids address every shard.  ``kv_quant`` sizes the int8 page
        mode: 1-byte KV elements plus the two f32 scale pools
        (``2 * [L, rows, kvh, page_size]``)."""
        if tp < 1 or num_kv_heads % tp:
            raise ValueError(
                f"tp={tp} must be >= 1 and divide num_kv_heads="
                f"{num_kv_heads} (the pool shards along the head axis)")
        rows = self.num_pages + 1           # + dump page
        elems = (2 * num_layers * rows * num_kv_heads * self.page_size
                 * head_dim)
        if kv_quant:
            total = elems + (2 * num_layers * rows * num_kv_heads
                             * self.page_size * 4)
        else:
            total = elems * dtype_itemsize
        return {"total_bytes": total,
                "per_device_bytes": total // tp,
                "rows": rows, "tp": tp, "kv_quant": bool(kv_quant)}

    def _reclaimable(self) -> int:
        """Parked LRU pages an allocator under pressure could actually
        recycle: leaf-first eviction frees a parked page only once every
        cached child is gone, so a parked parent whose children include
        a *live* page is pinned.  Computed as a leaf-peeling fixpoint
        (peel parked pages whose cached children are all already
        peeled)."""
        parked = set(self._lru)
        reclaimed: set[int] = set()
        changed = True
        while changed:
            changed = False
            for page in parked - reclaimed:
                kids = self._children.get(page, set())
                # children outside `parked` are live (refcounted) and pin
                # this page; parked children must peel first
                if all(k in reclaimed for k in kids):
                    reclaimed.add(page)
                    changed = True
        return len(reclaimed)

    def fragmentation(self, need: int | None = None) -> float:
        """Fraction of *idle* pages (free + parked cached) that cannot
        serve a waiting request of ``need`` pages.  0.0 when nothing is
        waiting or every idle page is usable; 1.0 when the request
        cannot be placed at all even after evicting every reclaimable
        parked page."""
        idle = len(self._free) + len(self._lru)
        if not need or idle == 0:
            return 0.0
        usable = len(self._free) + self._reclaimable()
        if need <= usable:
            unusable = idle - usable      # pinned parked pages only
        else:
            unusable = idle               # request can't be placed
        return unusable / idle

    def record_fragmentation(self, need: int | None) -> float:
        """Compute :meth:`fragmentation` for the queue head's demand and
        publish it on the ``serving_page_fragmentation_ratio`` gauge."""
        ratio = self.fragmentation(need)
        _M_FRAG.set(ratio)
        return ratio

    def seq_footprint(self, seq_id: int) -> dict:
        """Per-request page footprint: total pages in the block table,
        split into ``shared`` (refcount > 1, also held by another live
        sequence or chain) and ``exclusive``, plus the admission plan's
        ``cached_len`` tokens."""
        pages = self._tables.get(seq_id, ())
        shared = sum(1 for p in pages if self._ref.get(p, 0) > 1)
        meta = self._meta.get(seq_id, {})
        return {"pages": len(pages), "shared": shared,
                "exclusive": len(pages) - shared,
                "cached_len": int(meta.get("cached_len", 0)),
                "committed_tokens": self.committed_tokens(seq_id),
                "committed_pages": self.committed_pages(seq_id)}

    # ------------------------------------------------- refcount internals
    def _incref(self, page: int):
        self._ref[page] = self._ref.get(page, 0) + 1
        self._lru.pop(page, None)

    def _decref(self, page: int):
        n = self._ref.get(page, 0) - 1
        if n > 0:
            self._ref[page] = n
            return
        self._ref.pop(page, None)
        if page in self._key_of or page in self._tail_parent:
            self._lru[page] = None       # parked, still matchable
        else:
            self._free.append(page)

    def _acquire(self, n: int):
        """Take ``n`` pages: free list first, then LRU eviction of
        cached refcount-0 pages (leaf-first, so a chain parent is never
        recycled while children could still match through it)."""
        if (n > 0 and self.faults is not None
                and self.faults.check("page_alloc", need=n) is not None):
            return None        # synthetic device-OOM -> backpressure
        got: list[int] = []
        while len(got) < n:
            if self._free:
                got.append(self._free.popleft())
            elif self._lru and self._evict_one():
                continue
            else:
                # rollback: nothing partially held on failure (restore
                # FIFO order at the head of the deque)
                self._free.extendleft(reversed(got))
                return None
        if got:
            self.pages_allocated += len(got)
            _M_PAGES_ALLOC.inc(len(got))
        return got

    def _evict_one(self) -> bool:
        for page in self._lru:            # oldest first
            if self._children.get(page):
                continue                  # not a leaf yet
            self._lru.pop(page)
            self._unregister(page)
            self._free.append(page)
            self.prefix_evictions += 1
            _obs.flight("blocks", "page_evict", page=page)
            _M_PREFIX_EVICT.inc()
            _M_CACHED_PAGES.set(self.cached_pages)
            return True
        return False

    def _unregister(self, page: int):
        key = self._key_of.pop(page, None)
        if key is not None:
            self._index.pop(key, None)
            self._children.get(key[0], set()).discard(page)
        parent = self._tail_parent.pop(page, None)
        if parent is not None:
            self._tails.get(parent, {}).pop(page, None)
            self._children.get(parent, set()).discard(page)

    # ------------------------------------------------------------- tables
    def table_row(self, seq_id: int, width: int) -> np.ndarray:
        """The sequence's block-table row, dump-padded to ``width``
        (the engine's static table shape)."""
        pages = self._tables.get(seq_id, ())
        if len(pages) > width:
            raise ValueError(
                f"sequence {seq_id} owns {len(pages)} pages, table width "
                f"is only {width}")
        row = np.full((width,), self.dump_page, np.int32)
        row[:len(pages)] = pages
        return row

    def empty_row(self, width: int) -> np.ndarray:
        """An all-dump row (idle slots write/read only the dump page)."""
        return np.full((width,), self.dump_page, np.int32)
