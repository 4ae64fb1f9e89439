"""Multi-LoRA adapter store: host parking + LRU device residency.

Ports ``paddle_tpu/serving/lora/store.py``.  Rank-r adapter pairs
``(A [r, in], B [r, out])`` per projection and layer, applied as
``h W + (alpha/r) * (h A^T) B``.  The :class:`AdapterStore` owns the
host half:

  * ``register`` validates an adapter loudly (all seven projection
    keys, per-key shapes against the model config, one rank, floating
    dtype) and parks a float32 CPU copy;
  * ``acquire``/``release`` manage the LRU-bounded device residency over
    the runner's packed bank (``capacity`` usable rows; row 0 is the
    zeroed no-adapter row): an acquire on a parked adapter loads it into
    a free row, evicting the least-recently-used *idle* resident when
    full.  Rows with live requests are pinned (refcounts taken at submit
    and dropped at finalize);
  * ``attach`` binds a runner and (re)loads every resident adapter.

An adapter is ``{key: (A [L, r, in], B [L, r, out])}`` over
:data:`LORA_KEYS`, as tensors or numpy arrays (``models.convert.
adapter_from_numpy`` carries the reference's dicts over).  Bank rows
hold float32 regardless of the base dtype.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ... import observability as _obs
from ...sanitizer import make_lock

__all__ = ["AdapterStore", "LORA_KEYS", "lora_key_dims",
           "random_adapter", "merge_adapter"]

# the seven projection outputs an adapter touches, named like
# models.generation._layer_weights
LORA_KEYS = ("q", "k", "v", "o", "gate", "up", "down")

# short key -> state-dict weight path (for merged-weight references)
_STATE_PATHS = {
    "q": "self_attn.q_proj.weight", "k": "self_attn.k_proj.weight",
    "v": "self_attn.v_proj.weight", "o": "self_attn.o_proj.weight",
    "gate": "mlp.gate_proj.weight", "up": "mlp.up_proj.weight",
    "down": "mlp.down_proj.weight",
}

_M_LOADS = _obs.counter(
    "serving_lora_loads_total",
    "adapter loads into the device bank (cold acquires)")
_M_EVICTIONS = _obs.counter(
    "serving_lora_evictions_total",
    "idle adapters evicted from the device bank to make room")
_M_RESIDENT = _obs.gauge(
    "serving_lora_resident",
    "adapters currently resident in the device bank")


def lora_key_dims(config) -> dict:
    """``{key: (in_dim, out_dim)}`` of each adapted projection — what
    the store validates against and the runner sizes its bank from."""
    h = config.hidden_size
    hd = config.head_dim
    qd = config.num_attention_heads * hd
    kvd = config.num_key_value_heads * hd
    inter = config.intermediate_size
    return {"q": (h, qd), "k": (h, kvd), "v": (h, kvd), "o": (qd, h),
            "gate": (h, inter), "up": (h, inter), "down": (inter, h)}


def _as_tensor(a) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach()
    return torch.from_numpy(np.array(a))


def _validate_adapter(config, name, weights) -> int:
    """Loud shape/dtype/rank validation; returns the adapter's rank."""
    if not isinstance(weights, dict):
        raise ValueError(
            f"adapter {name!r}: weights must be a dict "
            f"{{key: (A, B)}}, got {type(weights).__name__}")
    missing = [k for k in LORA_KEYS if k not in weights]
    extra = [k for k in weights if k not in LORA_KEYS]
    if missing or extra:
        raise ValueError(
            f"adapter {name!r}: expected exactly keys {LORA_KEYS}, "
            f"missing {missing}, unexpected {extra}")
    L = config.num_hidden_layers
    dims = lora_key_dims(config)
    rank = None
    for key in LORA_KEYS:
        pair = weights[key]
        if not (isinstance(pair, (tuple, list)) and len(pair) == 2):
            raise ValueError(
                f"adapter {name!r}[{key!r}]: expected an (A, B) pair, "
                f"got {type(pair).__name__}")
        a, b = _as_tensor(pair[0]), _as_tensor(pair[1])
        if not (a.is_floating_point() and b.is_floating_point()):
            raise ValueError(
                f"adapter {name!r}[{key!r}]: A/B must be floating, "
                f"got {a.dtype}/{b.dtype}")
        if a.dim() != 3 or b.dim() != 3:
            raise ValueError(
                f"adapter {name!r}[{key!r}]: A/B must be "
                f"[layers, r, dim], got {tuple(a.shape)}/{tuple(b.shape)}")
        r = a.shape[1]
        if rank is None:
            rank = r
        ind, outd = dims[key]
        if tuple(a.shape) != (L, rank, ind):
            raise ValueError(
                f"adapter {name!r}[{key!r}]: A shape {tuple(a.shape)} != "
                f"expected {(L, rank, ind)} (layers, r, in_dim)")
        if tuple(b.shape) != (L, rank, outd):
            raise ValueError(
                f"adapter {name!r}[{key!r}]: B shape {tuple(b.shape)} != "
                f"expected {(L, rank, outd)} (layers, r, out_dim)")
    return rank


class AdapterStore:
    """Host registry + LRU device residency for LoRA adapters.

    ``capacity`` is the number of usable bank rows the runner allocates
    (+1 internally for the zeroed no-adapter row 0).  ``rank`` may be
    given up front or inferred from the first registration; every
    adapter must match it exactly (the packed bank has one rank axis)."""

    def __init__(self, config, *, capacity: int = 4,
                 rank: int | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if rank is not None and rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        self.config = config
        self.capacity = int(capacity)
        self.rank = None if rank is None else int(rank)
        self._lock = make_lock("lora.AdapterStore")
        self._host: dict[str, dict] = {}      # name -> parked weights
        self._alpha: dict[str, float] = {}
        self._resident: OrderedDict[str, int] = OrderedDict()  # -> row
        self._refs: dict[str, int] = {}       # live-request pins
        self._requests: dict[str, int] = {}   # per-adapter acquire census
        self._runner = None
        self.loads = 0
        self.evictions = 0

    # ------------------------------------------------------------ registry
    def register(self, name: str, weights: dict, *, alpha: float = 1.0):
        """Validate and park an adapter on the host.  ``weights`` is
        ``{key: (A [L, r, in], B [L, r, out])}`` over :data:`LORA_KEYS`;
        the applied delta is ``(alpha / r) * (h A^T) B``."""
        name = str(name).strip()
        if not name:
            raise ValueError("adapter name must be non-empty")
        if float(alpha) <= 0.0:
            raise ValueError(f"adapter {name!r}: alpha must be > 0, "
                             f"got {alpha}")
        r = _validate_adapter(self.config, name, weights)
        with self._lock:
            if self.rank is None:
                self.rank = r
            elif r != self.rank:
                raise ValueError(
                    f"adapter {name!r}: rank {r} != store rank "
                    f"{self.rank} (the packed bank has one static "
                    "rank axis — pad or re-train)")
            if name in self._resident:
                raise ValueError(
                    f"adapter {name!r} is device-resident; release it "
                    "before re-registering")
            self._host[name] = {
                key: (_as_tensor(a).to("cpu", torch.float32, copy=True),
                      _as_tensor(b).to("cpu", torch.float32, copy=True))
                for key, (a, b) in weights.items()}
            self._alpha[name] = float(alpha)
            self._requests.setdefault(name, 0)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._host)

    def resident(self) -> list[str]:
        """Resident adapter names in LRU order (oldest first)."""
        with self._lock:
            return list(self._resident)

    def parked(self) -> list[str]:
        with self._lock:
            return sorted(set(self._host) - set(self._resident))

    def row_of(self, name: str) -> int | None:
        with self._lock:
            return self._resident.get(name)

    # ----------------------------------------------------------- residency
    def attach(self, runner):
        """Bind the device runner and (re)load every resident adapter
        into its bank — host parking is the source of truth."""
        if getattr(runner, "lora_slots", 0) != self.capacity:
            raise ValueError(
                f"runner bank has {getattr(runner, 'lora_slots', 0)} "
                f"rows, store capacity is {self.capacity}")
        if self.rank is not None and runner.lora_rank != self.rank:
            raise ValueError(
                f"runner bank rank {runner.lora_rank} != store rank "
                f"{self.rank}")
        with self._lock:
            self._runner = runner
            for name, row in self._resident.items():
                self._load(name, row)

    def _load(self, name: str, row: int):
        if self._runner is not None:
            host = self._host[name]
            self._runner.load_adapter(
                row, {k: ab[0] for k, ab in host.items()},
                {k: ab[1] for k, ab in host.items()},
                self._alpha[name] / self.rank)
        self.loads += 1
        _M_LOADS.inc()

    def acquire(self, name: str | None) -> int:
        """Pin ``name`` for one request and return its bank row (0 for
        ``None``).  Loads parked adapters on demand, evicting the LRU
        *idle* resident when the bank is full; raises when every row is
        pinned by live requests."""
        if name is None:
            return 0
        with self._lock:
            if name not in self._host:
                raise KeyError(
                    f"unknown adapter {name!r}; registered: "
                    f"{sorted(self._host)}")
            self._requests[name] = self._requests.get(name, 0) + 1
            if name in self._resident:
                self._resident.move_to_end(name)
                self._refs[name] = self._refs.get(name, 0) + 1
                return self._resident[name]
            row = self._free_row()
            self._resident[name] = row
            self._refs[name] = 1
            self._load(name, row)
            _M_RESIDENT.set(len(self._resident))
            return row

    def _free_row(self) -> int:
        used = set(self._resident.values())
        for row in range(1, self.capacity + 1):
            if row not in used:
                return row
        for victim in list(self._resident):       # LRU order
            if self._refs.get(victim, 0) == 0:
                row = self._resident.pop(victim)
                self._refs.pop(victim, None)
                self.evictions += 1
                _M_EVICTIONS.inc()
                return row
        raise RuntimeError(
            f"all {self.capacity} adapter bank rows are pinned by live "
            "requests — raise the store capacity or drain first")

    def release(self, name: str | None):
        """Drop one request's pin (the adapter stays resident and
        becomes evictable once idle)."""
        if name is None:
            return
        with self._lock:
            if self._refs.get(name, 0) <= 0:
                raise RuntimeError(
                    f"release of adapter {name!r} without a matching "
                    "acquire")
            self._refs[name] -= 1

    # ---------------------------------------------------------------- info
    def bank_bytes(self) -> int:
        """Device bytes of the packed bank (all rows, f32)."""
        if self.rank is None:
            return 0
        per_row = sum(ind + outd
                      for ind, outd in lora_key_dims(self.config).values())
        rows = self.capacity + 1
        layers = self.config.num_hidden_layers
        return layers * rows * self.rank * per_row * 4 + rows * 4

    def snapshot(self) -> dict:
        """JSON-able census of the store."""
        with self._lock:
            return {
                "capacity": self.capacity,
                "rank": self.rank,
                "registered": sorted(self._host),
                "resident": list(self._resident),
                "parked": sorted(set(self._host) - set(self._resident)),
                "pinned": {n: c for n, c in self._refs.items() if c > 0},
                "bank_bytes": self.bank_bytes(),
                "loads": self.loads,
                "evictions": self.evictions,
                "requests": dict(self._requests),
            }


# ---------------------------------------------------------------- helpers
def random_adapter(config, rank: int, *, seed: int = 0,
                   scale: float = 0.5) -> dict:
    """Deterministic random adapter weights for tests and benches, as
    float32 CPU tensors — the same numbers as the reference's
    ``random_adapter`` for the same seed (numpy draws both).  A and B
    are both non-zero (real LoRA zero-inits B; a zero delta would make
    every parity check vacuous)."""
    rng = np.random.default_rng(seed)
    L = config.num_hidden_layers
    out = {}
    for key, (ind, outd) in lora_key_dims(config).items():
        a = rng.normal(0.0, scale / np.sqrt(ind), (L, rank, ind))
        b = rng.normal(0.0, scale / np.sqrt(rank), (L, rank, outd))
        out[key] = (torch.from_numpy(a.astype(np.float32)),
                    torch.from_numpy(b.astype(np.float32)))
    return out


def merge_adapter(state: dict, config, weights: dict,
                  *, alpha: float = 1.0) -> dict:
    """Dense merged-weights reference: ``W + (alpha/r) A^T B`` folded
    into a copy of a float state dict (on the weights' device) — the
    ground truth the bank-applied path must match token for token under
    greedy."""
    rank = _validate_adapter(config, "<merge>", weights)
    s = float(alpha) / rank
    out = dict(state)
    for key, (a, b) in weights.items():
        a, b = _as_tensor(a), _as_tensor(b)
        for i in range(config.num_hidden_layers):
            name = f"llama.layers.{i}.{_STATE_PATHS[key]}"
            w = out[name]
            delta = s * (a[i].to(w.device, torch.float32).T
                         @ b[i].to(w.device, torch.float32))
            out[name] = (w.float() + delta).to(w.dtype)
    return out
