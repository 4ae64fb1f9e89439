"""Offline batch lane: drip-feed a JSONL job at the lowest priority.

Ports ``paddle_tpu/serving/lora/batch.py`` by copy (pure Python,
with the reference's metric names, span names, JSON fields and
routes).

Reference analog: the offline scoring lanes of the reference's
recommendation stack — bulk work shares the serving fleet but must
never displace interactive traffic.  The serving-era mechanism is
already built: the priority scheduler admits the highest class first
and preempts-and-swaps lower-class residents, so a batch job
is just a feeder that (a) submits at a class BELOW every interactive
name and (b) keeps only a small window in flight, letting interactive
arrivals win every admission race and evict batch slots on demand.

A :class:`BatchJob` owns one input file's lifecycle: records validate
up front, ``pump()`` (called from the engine loop between steps) reaps
finished requests into the output JSONL and tops the in-flight window
back up, ``progress()`` is the JSON the ``/v1/batches/<id>`` endpoint
serves.  No threads: the job advances exactly when the engine does.
"""
from __future__ import annotations

import itertools
import json
import os
import time

from ..request import GenerationConfig
from ...sanitizer import make_lock

__all__ = ["BatchJob", "BATCH_PRIORITY"]

# below every interactive class (server names low/normal/high ->
# -1/0/1): interactive arrivals admit first and preempt batch residents
BATCH_PRIORITY = -2

_job_ids = itertools.count()
_job_ids_lock = make_lock("lora.batch._job_ids")


def _validate_records(records) -> list[dict]:
    out = []
    for i, rec in enumerate(records):
        if not isinstance(rec, dict):
            raise ValueError(f"batch record {i}: expected an object, "
                             f"got {type(rec).__name__}")
        prompt = rec.get("prompt")
        if not isinstance(prompt, (list, tuple)) or not prompt \
                or not all(isinstance(t, int) for t in prompt):
            raise ValueError(
                f"batch record {i}: 'prompt' must be a non-empty list "
                "of token ids")
        mnt = rec.get("max_tokens", None)
        if mnt is not None and (not isinstance(mnt, int) or mnt < 1):
            raise ValueError(
                f"batch record {i}: 'max_tokens' must be a positive "
                f"int, got {mnt!r}")
        out.append(rec)
    if not out:
        raise ValueError("batch job has no records")
    return out


class BatchJob:
    """One offline job: validated records in, JSONL results out.

    ``pump(submit)`` is the whole engine contract — ``submit`` has the
    ``engine.submit`` shape (``submit(prompt, gen, priority=, tenant=,
    adapter=)``) and the job never holds more than ``window`` requests
    in flight, so a saturating job occupies at most ``window`` decode
    slots for interactive traffic to preempt."""

    def __init__(self, records, *, window: int = 2,
                 max_tokens: int = 16, output_path: str | None = None,
                 tenant: str | None = None, adapter: str | None = None,
                 job_id: str | None = None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.records = _validate_records(records)
        self.window = int(window)
        self.max_tokens = int(max_tokens)
        self.output_path = output_path
        self.tenant = tenant
        self.adapter = adapter
        with _job_ids_lock:
            self.id = job_id or f"batch-{next(_job_ids)}"
        self.created_at = time.monotonic()
        self.finished_at: float | None = None
        self._next = 0                    # next record index to submit
        self._inflight: dict[int, object] = {}     # index -> Request
        self.completed = 0
        self.failed = 0
        self.preemptions = 0              # summed over reaped requests
        self.output_tokens = 0
        self.error: str | None = None
        self._out = None

    @classmethod
    def from_jsonl(cls, path: str, **kw):
        """Load records from a JSONL file of ``{"prompt": [ids], ...}``
        objects; the default output lands beside it as
        ``<path>.out.jsonl`` unless ``output_path`` is given."""
        records = []
        with open(path) as f:
            for ln, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError as e:
                    raise ValueError(
                        f"{path}:{ln + 1}: invalid JSON: {e}") from None
        kw.setdefault("output_path", path + ".out.jsonl")
        return cls(records, **kw)

    # ------------------------------------------------------------- pumping
    @property
    def done(self) -> bool:
        return self._next >= len(self.records) and not self._inflight

    def pump(self, submit) -> bool:
        """Reap finished in-flight requests, then top the window back
        up.  Returns True while the job still has work (so engine
        loops can ``while job.pump(...) or engine.step(): ...``)."""
        for idx in list(self._inflight):
            req = self._inflight[idx]
            if not req.is_finished():
                continue
            del self._inflight[idx]
            self.preemptions += req.preemptions
            self.output_tokens += req.num_generated
            if req.finish_reason == "error":
                self.failed += 1
            else:
                self.completed += 1
            self._write_result(idx, req)
        while (self._next < len(self.records)
               and len(self._inflight) < self.window):
            idx = self._next
            self._next += 1
            rec = self.records[idx]
            gen = GenerationConfig(
                max_new_tokens=rec.get("max_tokens", self.max_tokens))
            try:
                req = submit(rec["prompt"], gen,
                             priority=BATCH_PRIORITY,
                             tenant=rec.get("tenant", self.tenant),
                             adapter=rec.get("adapter", self.adapter))
            except Exception as e:            # bad record (e.g. unknown
                self.failed += 1              # adapter): fail the row,
                self.error = str(e)           # keep the job moving
                self._write_result(idx, None, error=str(e))
                continue
            self._inflight[idx] = req
        if self.done and self.finished_at is None:
            self.finished_at = time.monotonic()
            if self._out is not None:
                self._out.close()
                self._out = None
        return not self.done

    def _write_result(self, idx: int, req, *, error: str | None = None):
        rec = self.records[idx]
        row = {"index": idx, "prompt": list(rec["prompt"])}
        if rec.get("id") is not None:
            row["id"] = rec["id"]
        if req is not None:
            row["tokens"] = list(req.output_tokens)
            row["finish_reason"] = req.finish_reason
            if req.adapter:
                row["adapter"] = req.adapter
            if req.error:
                row["error"] = req.error
        else:
            row["finish_reason"] = "error"
            row["error"] = error
        if self.output_path is None:
            return
        if self._out is None:
            self._out = open(self.output_path, "a")
        self._out.write(json.dumps(row) + "\n")
        self._out.flush()
        os.fsync(self._out.fileno())

    # ------------------------------------------------------------ progress
    def progress(self) -> dict:
        """The ``GET /v1/batches/<id>`` payload."""
        total = len(self.records)
        return {
            "id": self.id,
            "status": "completed" if self.done else "running",
            "total": total,
            "submitted": self._next,
            "inflight": len(self._inflight),
            "completed": self.completed,
            "failed": self.failed,
            "preemptions": self.preemptions,
            "output_tokens": self.output_tokens,
            "output_path": self.output_path,
            "adapter": self.adapter,
            "error": self.error,
        }
