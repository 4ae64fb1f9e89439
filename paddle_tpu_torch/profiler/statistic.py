"""Op-level summary statistics for the profiler (the port's copy of
``paddle_tpu/profiler/statistic.py``; the rest of ``profiler/`` waits).
On the card a span synchronizes CUDA before it closes.

Reference analog: python/paddle/profiler/profiler_statistic.py — the
SortedKeys enum, per-op EventSummary aggregation, and the formatted
"Operator Summary" table.  The collector sits on the eager dispatch path
(ops/registry.apply_op) and on user spans.  While collection is enabled
each dispatched op synchronizes its device before its span closes, so
the recorded time is the op's execution time, not its launch time.
"""
from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field

__all__ = ["SortedKeys", "EventSummary", "enable_collection",
           "disable_collection", "collection_enabled", "record_span",
           "reset", "op_summary", "gen_summary_table"]


class SortedKeys(enum.IntEnum):
    """Sort orders for the op summary table (reference
    profiler_statistic.py SortedKeys; the CPU/GPU pairs collapse — one
    synchronized host span per op covers the device work).  IntEnum so
    reference-style integer keys keep working."""
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


@dataclass
class EventSummary:
    """Aggregate of every span with one name (reference
    profiler_statistic.EventSummary.ItemBase)."""
    name: str
    kind: str = "op"            # "op" (dispatch) | "user" (RecordEvent)
    call: int = 0
    total: float = 0.0          # seconds
    max: float = 0.0
    min: float = field(default=float("inf"))

    def add(self, dt: float):
        self.call += 1
        self.total += dt
        self.max = max(self.max, dt)
        self.min = min(self.min, dt)

    @property
    def avg(self) -> float:
        return self.total / self.call if self.call else 0.0


ENABLED = False
_STATS: dict[tuple[str, str], EventSummary] = {}
# RecordEvent spans close from whatever thread ran them — under the
# threaded serving server that means concurrent record_span calls, so
# the aggregate map needs a lock (EventSummary.add is a read-modify-
# write of three fields).
_STATS_LOCK = threading.Lock()


def enable_collection(on: bool = True):
    global ENABLED
    ENABLED = bool(on)


def disable_collection():
    enable_collection(False)


def collection_enabled() -> bool:
    return ENABLED


def reset():
    with _STATS_LOCK:
        _STATS.clear()


def record_span(name: str, dt: float, kind: str = "op"):
    key = (kind, name)
    with _STATS_LOCK:
        s = _STATS.get(key)
        if s is None:
            s = _STATS[key] = EventSummary(name=name, kind=kind)
        s.add(dt)


def op_summary() -> list[EventSummary]:
    with _STATS_LOCK:
        return list(_STATS.values())


_UNITS = {"s": 1.0, "ms": 1e3, "us": 1e6, "ns": 1e9}

_SORT_ATTR = {
    SortedKeys.CPUTotal: "total", SortedKeys.GPUTotal: "total",
    SortedKeys.CPUAvg: "avg", SortedKeys.GPUAvg: "avg",
    SortedKeys.CPUMax: "max", SortedKeys.GPUMax: "max",
    SortedKeys.CPUMin: "min", SortedKeys.GPUMin: "min",
}


def gen_summary_table(sorted_by=SortedKeys.CPUTotal, time_unit="ms",
                      op_detail=True) -> str:
    """Render the collected spans as the reference-shaped summary table
    (profiler_statistic._build_table's Operator Summary section)."""
    if time_unit not in _UNITS:
        raise ValueError(f"time_unit must be one of {sorted(_UNITS)}, "
                         f"got {time_unit!r}")
    try:
        sorted_by = SortedKeys(sorted_by)
    except ValueError:
        raise TypeError(f"sorted_by must be a SortedKeys, got {sorted_by!r}")
    items = sorted(op_summary(), key=lambda s: getattr(s, _SORT_ATTR[
        sorted_by]), reverse=sorted_by not in (SortedKeys.CPUMin,
                                               SortedKeys.GPUMin))
    mult = _UNITS[time_unit]

    name_w = max([len(s.name) + 7 for s in items] + [12]) + 2
    head = (f"{'Name':<{name_w}}{'Calls':>8}{'Total(' + time_unit + ')':>14}"
            f"{'Avg(' + time_unit + ')':>12}{'Max(' + time_unit + ')':>12}"
            f"{'Min(' + time_unit + ')':>12}{'Ratio(%)':>10}")
    bar = "-" * len(head)
    lines = []
    # two sections, reference-style: Operator Summary for dispatched ops,
    # UserDefined Summary for RecordEvent spans (which NEST ops — merging
    # them would double-count and bury the op ranking)
    for kind, title in (("op", "Operator Summary"),
                        ("user", "UserDefined Summary")):
        sect = [s for s in items if s.kind == kind]
        if not sect or (kind == "user" and not op_detail):
            continue
        grand = sum(s.total for s in sect) or 1.0
        lines += [title, bar, head, bar]
        for s in sect:
            nm = s.name if s.kind == "op" else f"{s.name} (user)"
            lines.append(
                f"{nm:<{name_w}}{s.call:>8}{s.total * mult:>14.4f}"
                f"{s.avg * mult:>12.4f}{s.max * mult:>12.4f}"
                f"{(0.0 if s.min == float('inf') else s.min) * mult:>12.4f}"
                f"{100.0 * s.total / grand:>10.2f}")
        lines.append(bar)
    return "\n".join(lines)
