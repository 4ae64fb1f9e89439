"""Per-request cost attribution + tenant usage metering.

Ports ``paddle_tpu/observability/usage.py`` by copy (pure Python,
with the reference's metric names, span names, JSON fields and
routes).

Reference analog: the per-user accounting planes of a multi-tenant
serving fleet, where "what did tenant Y cost" is a first-class query,
not a log-scrape.  Every resource the serving engine consumes
is already counted *globally* (goodput tokens, pages allocated, spill
bytes); this module attributes them to the request and tenant that
consumed them:

  * scalar costs (queue seconds, prefill computed/cached token split,
    chunk counts, decode tokens, speculation proposed/accepted,
    spill/restore pages+bytes, preemptions, replays) accrue on the
    :class:`~paddle_tpu_torch.serving.request.Request` itself — plain int
    adds at the seams that already update the global mirrors, so the
    per-request ledger sums to the global counters *exactly* on
    deterministic workloads;
  * **KV page-seconds** — pages held × residency, integrated on the
    engine clock — are tracked here: the meter keeps a page → holders
    map fed by BlockManager hold/release hooks and charges each holder
    ``1/|holders|`` per shared page, so the conservation law

        sum over tenants of page_seconds == integral of live-pages dt

    holds identically (each live page contributes exactly 1 to the
    summed rate at every instant).  A separate host-tier track charges
    parked spill pages (content-addressed digests) to the tenant that
    parked them, across preempt -> spill -> resume;
  * a **tenant dimension** with bounded label cardinality: requests
    carry a tenant id (default ``"anon"``); the LRU
    :class:`TenantTable` caps distinct tenants, folding the
    least-recently-seen tenant's aggregates — python rows *and* its
    per-tenant metric series (:meth:`registry fold_label
    <paddle_tpu_torch.observability.registry._Metric.fold_label>`) — into a
    reserved ``"(evicted)"`` rollup, so a hostile client cycling
    tenant ids cannot explode the metrics registry and fleet totals
    still conserve.

Zero-overhead-off contract (same as profiling / fault injection): with
``FLAGS_serving_usage_meter`` unset no meter object exists and every
serving-path call site is a single ``is not None`` test (pinned by the
reference's perf-gate ``usage_meter`` scenario).
"""
from __future__ import annotations

import time
from collections import OrderedDict

from ..sanitizer import make_lock
from .registry import default_registry

__all__ = ["UsageMeter", "TenantTable", "EVICTED_TENANT",
           "request_ledger", "merge_usage", "active_usage",
           "set_active_usage"]

_REG = default_registry()

_M_TOKENS = _REG.counter(
    "serving_usage_tokens_total",
    "tokens attributed per tenant, split by kind (prefill_computed / "
    "prefill_cached / decode)", ("tenant", "kind"))
_M_REQS = _REG.counter(
    "serving_usage_requests_total",
    "finished requests attributed per tenant, by finish reason",
    ("tenant", "reason"))
_M_PAGE_SECONDS = _REG.counter(
    "serving_usage_page_seconds_total",
    "KV page-seconds (pages held x residency on the engine clock) "
    "attributed per tenant, by tier (device / host spill)",
    ("tenant", "tier"))
_M_QUEUE_SECONDS = _REG.counter(
    "serving_usage_queue_seconds_total",
    "queue-wait seconds attributed per tenant (admission + resume "
    "re-queues)", ("tenant",))
_M_SPILL_BYTES = _REG.counter(
    "serving_usage_spill_bytes_total",
    "preemption spill bytes attributed to the preempted tenant",
    ("tenant",))
_M_PREEMPT = _REG.counter(
    "serving_usage_preemptions_total",
    "preemptions suffered, attributed to the preempted tenant",
    ("tenant",))
_M_SLO = _REG.counter(
    "serving_usage_slo_total",
    "per-tenant SLO verdicts mirrored from the SLOTracker "
    "(dimension x good/violation)", ("tenant", "dimension", "result"))
_M_SHED = _REG.counter(
    "serving_usage_shed_total",
    "requests shed at admission, attributed per tenant",
    ("tenant",))
_M_ADAPTER_TOKENS = _REG.counter(
    "serving_usage_adapter_tokens_total",
    "decode tokens attributed per tenant and LoRA adapter (series "
    "exist only for requests that named an adapter; cardinality is "
    "bounded by the adapter registry)", ("tenant", "adapter"))
_M_TENANTS = _REG.gauge(
    "serving_usage_tenants",
    "distinct tenants currently tracked (LRU-bounded by "
    "FLAGS_serving_usage_max_tenants)")
_M_EVICTED = _REG.counter(
    "serving_usage_evicted_tenants_total",
    "tenants folded into the (evicted) rollup at the LRU cardinality "
    "cap")

# the reserved rollup label evicted tenants fold into — never evicted
# itself, so the registry's tenant cardinality is capped at the table
# capacity + 1 at every instant
EVICTED_TENANT = "(evicted)"

# metric families carrying a tenant label; eviction folds their series
_TENANT_METRICS = (_M_TOKENS, _M_REQS, _M_PAGE_SECONDS, _M_QUEUE_SECONDS,
                   _M_SPILL_BYTES, _M_PREEMPT, _M_SLO, _M_SHED,
                   _M_ADAPTER_TOKENS)

_AGG_INT_FIELDS = (
    "requests", "finished", "goodput_requests",
    "prefill_computed_tokens", "prefill_cached_tokens", "decode_tokens",
    "prefill_chunks", "spec_proposed_tokens", "spec_accepted_tokens",
    "pages_allocated", "spilled_pages", "spill_bytes",
    "restored_pages", "restore_bytes", "preemptions", "replays", "shed")
_AGG_FLOAT_FIELDS = ("queue_seconds", "page_seconds", "host_page_seconds")

_GOODPUT_REASONS = ("length", "eos")


def _zero_row() -> dict:
    row = {f: 0 for f in _AGG_INT_FIELDS}
    for f in _AGG_FLOAT_FIELDS:
        row[f] = 0.0
    row["slo"] = {}
    row["adapters"] = {}
    return row


def _merge_row(dst: dict, src: dict):
    """Raw-merge one tenant row into another: numeric fields sum,
    nested dicts (the slo verdict table) recurse — never averages, the
    same discipline the router applies to latency buckets."""
    for k, v in src.items():
        if isinstance(v, dict):
            _merge_row(dst.setdefault(k, {}), v)
        elif isinstance(v, (int, float)):
            dst[k] = dst.get(k, 0) + v
        else:
            dst.setdefault(k, v)


def request_ledger(req) -> dict:
    """The per-request cost ledger as a plain dict — every field reads
    off the Request, so this works with or without a live meter
    (page-seconds stay 0.0 until the meter folds them in)."""
    return {
        "tenant": getattr(req, "tenant", "anon"),
        "queue_seconds": req.queue_seconds,
        "prefill_computed_tokens": req.prefill_computed_tokens,
        "prefill_cached_tokens": req.prefill_cached_tokens,
        "prefill_chunks": req.prefill_chunks,
        "decode_tokens": req.num_generated,
        "spec_proposed_tokens": req.spec_proposed_tokens,
        "spec_accepted_tokens": req.spec_accepted_tokens,
        "pages_allocated": req.pages_allocated,
        "page_seconds": req.page_seconds,
        "host_page_seconds": req.host_page_seconds,
        "spilled_pages": req.spilled_pages,
        "spill_bytes": req.spill_bytes,
        "restored_pages": req.restored_pages,
        "restore_bytes": req.restore_bytes,
        "preemptions": req.preemptions,
        "replays": req.replays,
        "adapter": getattr(req, "adapter", None),
    }


class TenantTable:
    """LRU-bounded tenant aggregate table.

    ``resolve`` admits (or touches) a tenant and returns its aggregate
    row; admission past ``capacity`` evicts the least-recently-used
    tenant, folding its row into :attr:`overflow` (surfaced as the
    ``"(evicted)"`` tenant) and invoking :attr:`on_evict` so the meter
    can fold the matching metric series — bounded label cardinality at
    every instant, with totals conserved across eviction."""

    def __init__(self, capacity: int = 64):
        self.capacity = max(1, int(capacity))
        self._aggs: OrderedDict[str, dict] = OrderedDict()
        self.overflow = _zero_row()
        self.evicted_tenants = 0
        self.on_evict = None          # callable(name) — meter hook

    def __len__(self) -> int:
        return len(self._aggs)

    def __contains__(self, name) -> bool:
        return str(name) in self._aggs

    def items(self):
        return list(self._aggs.items())

    @staticmethod
    def canonical(tenant) -> str:
        name = str(tenant).strip() if tenant is not None else ""
        return name or "anon"

    def resolve(self, tenant) -> tuple[str, dict]:
        """Canonical ``(name, row)`` for ``tenant``, admitting it
        (evicting LRU at capacity) and marking it most-recent."""
        name = self.canonical(tenant)
        row = self._aggs.get(name)
        if row is not None:
            self._aggs.move_to_end(name)
            return name, row
        while len(self._aggs) >= self.capacity:
            victim, vrow = self._aggs.popitem(last=False)
            _merge_row(self.overflow, vrow)
            self.evicted_tenants += 1
            _M_EVICTED.inc()
            if self.on_evict is not None:
                self.on_evict(victim)
        row = _zero_row()
        self._aggs[name] = row
        _M_TENANTS.set(len(self._aggs))
        return name, row

    def charge_row(self, tenant) -> dict:
        """Aggregate row for charging *without* LRU promotion or
        admission; unknown (evicted) tenants charge the overflow
        rollup — late charges never resurrect an evicted label."""
        return self._aggs.get(str(tenant), self.overflow)


class UsageMeter:
    """Per-request / per-tenant cost meter for one serving engine.

    The engine binds its clock at construction time (``clock=None``
    inherits the engine's — fake clocks in tests, ``time.monotonic``
    in production) and calls the ``on_*`` hooks at the existing
    seams; the BlockManager feeds ``on_hold`` / ``on_release`` for the
    page-seconds integral.  Every hook ticks the integrator before
    mutating holder state, so residency is exact on the shared clock.
    """

    def __init__(self, *, max_tenants: int = 64, clock=None):
        self._clock = clock
        self._lock = make_lock("UsageMeter._lock")
        self.tenants = TenantTable(max_tenants)
        self.tenants.on_evict = self._fold_evicted_tenant
        # live requests: seq id -> (tenant, Request)
        self._live: dict[int, tuple] = {}
        # device tier: page -> holder seqs; seq -> charge rate
        # (sum of 1/|holders| over held pages) and unfolded accumulator
        self._holders: dict[int, list] = {}
        self._rate: dict[int, float] = {}
        self._acc: dict[int, float] = {}
        self._pool_acc = 0.0              # integral of live-pages dt
        # host spill tier: digest -> charged tenant / parking seq
        self._host_tenant: dict[str, str] = {}
        self._host_count: dict[str, int] = {}     # tenant -> digests
        self._host_parker: dict[str, int] = {}
        self._parked_by: dict[int, set] = {}      # seq -> digests
        self._host_req_acc: dict[int, float] = {}
        self._host_pool_acc = 0.0         # integral of parked-pages dt
        self._last: float | None = None

    # ------------------------------------------------------------ clock
    def now(self) -> float:
        return (self._clock or time.monotonic)()

    def _tick(self, now: float | None = None):
        """Advance both residency integrals to ``now`` (callers hold
        the lock).  Rates only change at hook boundaries, so piecewise-
        constant integration is exact."""
        now = self.now() if now is None else float(now)
        last = self._last
        if last is not None and now > last:
            dt = now - last
            if self._rate:
                acc = self._acc
                for s, r in self._rate.items():
                    acc[s] = acc.get(s, 0.0) + r * dt
            self._pool_acc += len(self._holders) * dt
            if self._host_count:
                for tenant, n in self._host_count.items():
                    amt = n * dt
                    self.tenants.charge_row(tenant)[
                        "host_page_seconds"] += amt
                    _M_PAGE_SECONDS.labels(tenant, "host").inc(amt)
                self._host_pool_acc += len(self._host_tenant) * dt
            if self._parked_by:
                for s, digests in self._parked_by.items():
                    self._host_req_acc[s] = (
                        self._host_req_acc.get(s, 0.0)
                        + len(digests) * dt)
        if last is None or now > last:
            self._last = now

    # -------------------------------------------------- request lifecycle
    def on_submit(self, req):
        """Admit the request's tenant and start attributing to it."""
        with self._lock:
            self._tick()
            tenant, row = self.tenants.resolve(
                getattr(req, "tenant", None))
            req.tenant = tenant          # canonicalized ("" -> "anon")
            self._live[req.id] = (tenant, req)
            row["requests"] += 1

    def on_finish(self, req, reason: str, now: float | None = None):
        """Fold the request's scalar ledger into its tenant aggregate.
        Page-seconds fold when the last page releases (the scheduler
        evicts — and frees pages — *after* the engine finalizes)."""
        with self._lock:
            self._tick(now)
            entry = self._live.get(req.id)
            if entry is None:
                return
            tenant, _ = entry
            row = self.tenants.charge_row(tenant)
            row["finished"] += 1
            if reason in _GOODPUT_REASONS:
                row["goodput_requests"] += 1
            row["prefill_computed_tokens"] += req.prefill_computed_tokens
            row["prefill_cached_tokens"] += req.prefill_cached_tokens
            row["decode_tokens"] += req.num_generated
            row["prefill_chunks"] += req.prefill_chunks
            row["spec_proposed_tokens"] += req.spec_proposed_tokens
            row["spec_accepted_tokens"] += req.spec_accepted_tokens
            row["queue_seconds"] += req.queue_seconds
            row["pages_allocated"] += req.pages_allocated
            row["spilled_pages"] += req.spilled_pages
            row["spill_bytes"] += req.spill_bytes
            row["restored_pages"] += req.restored_pages
            row["restore_bytes"] += req.restore_bytes
            row["preemptions"] += req.preemptions
            row["replays"] += req.replays
            _M_REQS.labels(tenant, str(reason)).inc()
            _M_TOKENS.labels(tenant, "prefill_computed").inc(
                req.prefill_computed_tokens)
            _M_TOKENS.labels(tenant, "prefill_cached").inc(
                req.prefill_cached_tokens)
            _M_TOKENS.labels(tenant, "decode").inc(req.num_generated)
            _M_QUEUE_SECONDS.labels(tenant).inc(req.queue_seconds)
            adapter = getattr(req, "adapter", None)
            if adapter:
                cell = row["adapters"].setdefault(
                    str(adapter), {"requests": 0, "decode_tokens": 0})
                cell["requests"] += 1
                cell["decode_tokens"] += req.num_generated
                _M_ADAPTER_TOKENS.labels(tenant, str(adapter)).inc(
                    req.num_generated)
            if req.spill_bytes:
                _M_SPILL_BYTES.labels(tenant).inc(req.spill_bytes)
            if req.preemptions:
                _M_PREEMPT.labels(tenant).inc(req.preemptions)
            # stop per-request host charging (the tenant keeps paying
            # for its parked digests until the host tier evicts them)
            self._release_host(req.id, req)
            if req.id not in self._rate:
                self._fold_pages(req.id, tenant, req)

    # ----------------------------------------------- device page-seconds
    def on_hold(self, seq: int, pages, fresh: int = 0):
        """``seq`` took references on ``pages`` (BlockManager admission
        hook); ``fresh`` of them were newly acquired from the pool."""
        with self._lock:
            self._tick()
            rate = self._rate.get(seq, 0.0)
            for p in pages:
                holders = self._holders.get(p)
                if holders is None:
                    self._holders[p] = [seq]
                    rate += 1.0
                else:
                    k = len(holders)
                    # existing holders' share drops 1/k -> 1/(k+1)
                    adj = 1.0 / (k + 1) - 1.0 / k
                    for h in holders:
                        self._rate[h] += adj
                    holders.append(seq)
                    rate += 1.0 / (k + 1)
            self._rate[seq] = rate
            self._acc.setdefault(seq, 0.0)
            if fresh:
                entry = self._live.get(seq)
                if entry is not None:
                    entry[1].pages_allocated += int(fresh)

    def on_release(self, seq: int, pages):
        """``seq`` dropped all its page references (free_seq)."""
        with self._lock:
            self._tick()
            for p in pages:
                holders = self._holders.get(p)
                if not holders or seq not in holders:
                    continue
                holders.remove(seq)
                k = len(holders)
                if k == 0:
                    del self._holders[p]
                else:
                    adj = 1.0 / k - 1.0 / (k + 1)
                    for h in holders:
                        self._rate[h] += adj
            self._rate.pop(seq, None)
            acc = self._acc.pop(seq, 0.0)
            entry = self._live.get(seq)
            if entry is None:
                # a sequence the engine never registered (unit tests
                # driving the BlockManager directly): conserve the
                # charge under the default tenant — resolve, not
                # charge_row, so the table row matches the metric
                # series instead of landing in the eviction rollup
                _, row = self.tenants.resolve("anon")
                row["page_seconds"] += acc
                _M_PAGE_SECONDS.labels("anon", "device").inc(acc)
                return
            tenant, req = entry
            req.page_seconds += acc
            if req.is_finished():
                self._fold_pages(seq, tenant, req)

    def _fold_pages(self, seq: int, tenant: str, req):
        """Terminal fold: the request is finished and holds no pages —
        move its total page-seconds into the tenant row exactly once
        (dropping it from the live map makes a second fold impossible)."""
        if self._live.pop(seq, None) is None:
            return
        row = self.tenants.charge_row(tenant)
        row["page_seconds"] += req.page_seconds
        _M_PAGE_SECONDS.labels(tenant, "device").inc(req.page_seconds)

    # ------------------------------------------------- host (spill) tier
    def on_host_park(self, req, digest: str):
        """One spilled page parked under ``digest`` for ``req``."""
        with self._lock:
            self._tick()
            if digest in self._host_tenant:
                return
            entry = self._live.get(req.id)
            tenant = entry[0] if entry is not None \
                else self.tenants.canonical(getattr(req, "tenant", None))
            self._host_tenant[digest] = tenant
            self._host_count[tenant] = \
                self._host_count.get(tenant, 0) + 1
            self._host_parker[digest] = req.id
            self._parked_by.setdefault(req.id, set()).add(digest)

    def on_host_evict(self, digest: str):
        """The host tier dropped ``digest`` (LRU bound or discard)."""
        with self._lock:
            self._tick()
            tenant = self._host_tenant.pop(digest, None)
            if tenant is None:
                return
            n = self._host_count.get(tenant, 0) - 1
            if n > 0:
                self._host_count[tenant] = n
            else:
                self._host_count.pop(tenant, None)
            parker = self._host_parker.pop(digest, None)
            if parker is not None:
                held = self._parked_by.get(parker)
                if held is not None:
                    held.discard(digest)
                    if not held:
                        del self._parked_by[parker]

    def on_host_release(self, req):
        """``req`` resumed (or finished): stop charging its ledger for
        parked digests; the tenant track keeps accruing until the host
        tier evicts the copies."""
        with self._lock:
            self._tick()
            self._release_host(req.id, req)

    def _release_host(self, seq: int, req):
        req.host_page_seconds += self._host_req_acc.pop(seq, 0.0)
        for digest in self._parked_by.pop(seq, ()):
            self._host_parker.pop(digest, None)

    # ---------------------------------------------------- SLO / shedding
    def slo_verdict(self, req, dim: str, ok: bool):
        """``SLOTracker.verdict_hook`` adapter: mirror each per-request
        SLO verdict onto the request's tenant."""
        with self._lock:
            entry = self._live.get(req.id)
            tenant = entry[0] if entry is not None \
                else self.tenants.canonical(getattr(req, "tenant", None))
            row = self.tenants.charge_row(tenant)
            result = "good" if ok else "violation"
            cell = row["slo"].setdefault(str(dim),
                                         {"good": 0, "violation": 0})
            cell[result] += 1
            _M_SLO.labels(tenant, str(dim), result).inc()

    def on_shed(self, tenant):
        with self._lock:
            name, row = self.tenants.resolve(tenant)
            row["shed"] += 1
            _M_SHED.labels(name).inc()

    def heaviest_tenant(self) -> str | None:
        """The tenant with the largest page-second bill (device + host,
        live accrual included) — the fair-share shed/preempt target.
        Excludes the ``"(evicted)"`` rollup; deterministic tie-break."""
        with self._lock:
            self._tick()
            totals: dict[str, float] = {}
            for name, row in self.tenants.items():
                totals[name] = (row["page_seconds"]
                                + row["host_page_seconds"])
            for seq, (tenant, req) in self._live.items():
                totals[tenant] = (totals.get(tenant, 0.0)
                                  + req.page_seconds
                                  + self._acc.get(seq, 0.0))
            if not totals:
                return None
            return max(totals.items(), key=lambda kv: (kv[1], kv[0]))[0]

    # ---------------------------------------------- eviction / snapshot
    def _fold_evicted_tenant(self, name: str):
        """TenantTable eviction hook: fold the tenant's metric series
        into the rollup label and re-key any parked host digests so
        later ticks charge the rollup instead of resurrecting the
        evicted label."""
        for fam in _TENANT_METRICS:
            fam.fold_label("tenant", name, EVICTED_TENANT)
        # the hook only ever fires from TenantTable calls made by meter
        # methods that already hold self._lock (a plain Lock — taking
        # it again here would deadlock), so these writes are protected
        moved = 0
        for digest, tenant in list(self._host_tenant.items()):
            if tenant == name:
                # tpu-lint: disable=lock-unlocked-write
                self._host_tenant[digest] = EVICTED_TENANT
                moved += 1
        if moved:
            self._host_count.pop(name, None)
            # tpu-lint: disable=lock-unlocked-write
            self._host_count[EVICTED_TENANT] = \
                self._host_count.get(EVICTED_TENANT, 0) + moved
        # live requests of the evicted tenant keep charging it by name;
        # their terminal fold lands in the overflow row (charge_row)

    def conservation(self) -> dict:
        """The conservation identities, as charged-vs-pool deltas.
        Both are exactly zero up to float associativity; tests and the
        perf-gate pin ``round(delta, 6) == 0``."""
        with self._lock:
            self._tick()
            return self._conservation_locked()

    def _conservation_locked(self) -> dict:
        charged = self.tenants.overflow["page_seconds"]
        for _name, row in self.tenants.items():
            charged += row["page_seconds"]
        for seq, (_tenant, req) in self._live.items():
            charged += req.page_seconds
        # unfolded accumulators (live holders + unregistered seqs)
        charged += sum(self._acc.values())
        # requests that finished+released already folded; requests that
        # released but were never registered folded into "anon"
        host = self.tenants.overflow["host_page_seconds"]
        for _name, row in self.tenants.items():
            host += row["host_page_seconds"]
        return {
            "device_page_seconds": self._pool_acc,
            "device_delta": round(self._pool_acc - charged, 6),
            "host_page_seconds": self._host_pool_acc,
            "host_delta": round(self._host_pool_acc - host, 6),
            "live_pages": len(self._holders),
            "host_parked": len(self._host_tenant),
        }

    def snapshot(self) -> dict:
        """The per-tenant usage table (live page-second accrual folded
        in), mergeable across replicas with :func:`merge_usage`."""
        with self._lock:
            self._tick()
            tenants: dict[str, dict] = {}
            for name, row in self.tenants.items():
                copy = {k: (dict(v) if isinstance(v, dict) else v)
                        for k, v in row.items()}
                copy["slo"] = {d: dict(c)
                               for d, c in row["slo"].items()}
                copy["adapters"] = {a: dict(c)
                                    for a, c in row["adapters"].items()}
                tenants[name] = copy
            for seq, (tenant, req) in self._live.items():
                dst = tenants.setdefault(tenant, _zero_row())
                dst["page_seconds"] += (req.page_seconds
                                        + self._acc.get(seq, 0.0))
            if any(v for k, v in self.tenants.overflow.items()
                   if k != "slo") or self.tenants.overflow["slo"]:
                _merge_row(tenants.setdefault(EVICTED_TENANT,
                                              _zero_row()),
                           self.tenants.overflow)
            return {
                "tenants": tenants,
                "evicted_tenants": self.tenants.evicted_tenants,
                "live_requests": len(self._live),
                "conservation": self._conservation_locked(),
            }


def merge_usage(snapshots) -> dict:
    """Raw-merge per-replica usage snapshots: per-tenant counters sum
    (recursing into the slo table), never averaging derived values —
    the same discipline as the fleet latency-bucket merge.  ``None``
    entries (dead replicas, metering off) are skipped."""
    tenants: dict[str, dict] = {}
    evicted = 0
    live = 0
    merged = 0
    for snap in snapshots:
        if not snap:
            continue
        merged += 1
        for name, row in (snap.get("tenants") or {}).items():
            _merge_row(tenants.setdefault(name, {}), row)
        evicted += int(snap.get("evicted_tenants") or 0)
        live += int(snap.get("live_requests") or 0)
    return {"tenants": tenants, "evicted_tenants": evicted,
            "live_requests": live, "replicas": merged}


# --------------------------------------------------- active-meter global
_active: UsageMeter | None = None


def active_usage() -> UsageMeter | None:
    """The process's live usage meter (None = metering off)."""
    return _active


def set_active_usage(meter: UsageMeter | None):
    global _active
    _active = meter
