"""Speculative decoding: host-side drafting + acceptance bookkeeping.

Ports ``paddle_tpu/serving/spec.py`` by copy (host-side, no device
code): the same drafter and the same ``serving_spec_*`` metrics, so one
token history drafts the same tokens in both packages.

The draft-and-verify scheme (Leviathan et al. 2023): a cheap drafter
proposes up to ``k`` continuation tokens per slot, the target model
scores all ``k+1`` positions in ONE device step (the runner's verify
program), and the engine keeps the longest proposed prefix that matches
the target's own greedy choices plus the one correction/bonus token the
verify step produced at the first divergence.  Greedy outputs are
token-for-token identical to non-speculative decoding by construction:
position ``j`` is accepted only when the draft token equals the argmax
the target computed from exactly the context a plain decode would have
had, so the accepted chain IS the plain greedy chain — speculation can
only change how many steps it takes, never which tokens come out.

The first proposer is model-free **prompt lookup / n-gram drafting**
(Saxena 2023; vLLM's `ngram` speculative method): each request's prompt
+ generated tokens are indexed by their trailing n-grams, and when the
current tail n-gram has occurred before, the tokens that followed the
previous occurrence become the draft.  This costs microseconds on the
host, needs no second model, and shines exactly where decode is most
wasteful — repetitive spans (code, JSON, extractive summaries, chat
echoes) — while degrading to plain decode (empty drafts) on novel text.

The :class:`NgramProposer` is deliberately a narrow interface
(``register / extend / propose / drop`` keyed by request id) so a later
draft-model proposer — or the parallel-sampling (n>1) verify described
in the reference's roadmap — can slot in behind the same engine hooks
unchanged.

:class:`SpecStats` owns the ``serving_spec_*`` metrics and the
python-side mirrors the engine's ``stats()`` / perf gate read.
"""
from __future__ import annotations

from .. import observability as _obs

__all__ = ["NgramProposer", "SpecStats"]

_M_SPEC_TOKENS = _obs.counter(
    "serving_spec_tokens_total",
    "speculative draft tokens by outcome (proposed / accepted / "
    "rejected); accepted + rejected == proposed once all verifies land",
    ("result",))
_M_SPEC_STEPS = _obs.counter(
    "serving_spec_verify_steps_total",
    "verify-program device steps (each scores k+1 positions per slot)")
_M_SPEC_RATE = _obs.gauge(
    "serving_spec_acceptance_rate",
    "cumulative accepted / proposed draft tokens (0 when none proposed)")
# tokens, not seconds/bytes: the reference's name, kept for scrapes
_M_SPEC_PER_STEP = _obs.histogram(
    "serving_spec_tokens_per_step",
    "tokens committed per verify step (accepted + 1 correction/bonus)",
    buckets=(1, 2, 3, 4, 6, 8, 12, 16))


class NgramProposer:
    """Prompt-lookup drafter: index every request's token history by
    trailing n-grams; propose the continuation of the most recent prior
    occurrence of the current tail.

    For each ``n`` in ``max_n .. min_n`` (longest first, so the most
    specific context wins) the index maps an n-gram to the position
    *after* its latest completed occurrence.  The tail n-gram of the
    live history always maps to the end of the history (an empty
    continuation), so the index also keeps the previous occurrence —
    that one has real continuation tokens to draft from.  Updates are
    O(max_n) per token; proposals are O(max_n) dict probes, independent
    of history length.
    """

    def __init__(self, k: int, *, max_n: int = 3, min_n: int = 1):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if not 1 <= min_n <= max_n:
            raise ValueError(
                f"need 1 <= min_n <= max_n, got {min_n}..{max_n}")
        self.k = int(k)
        self.max_n = int(max_n)
        self.min_n = int(min_n)
        self._hist: dict[int, list[int]] = {}
        # (n-gram tuple) -> continuation start of its latest occurrence,
        # plus the occurrence before that (the tail's own entry always
        # points at the history end, where nothing follows yet)
        self._idx: dict[int, dict[tuple, int]] = {}
        self._prev: dict[int, dict[tuple, int]] = {}

    # ------------------------------------------------------------ history
    def register(self, req_id: int, tokens) -> None:
        """Seed a request's history with its prompt."""
        self._hist[req_id] = []
        self._idx[req_id] = {}
        self._prev[req_id] = {}
        for t in tokens:
            self.extend(req_id, int(t))

    def extend(self, req_id: int, token: int) -> None:
        """Append one generated (or prompt) token and index the n-grams
        it completes."""
        hist = self._hist[req_id]
        hist.append(int(token))
        L = len(hist)
        idx, prev = self._idx[req_id], self._prev[req_id]
        for n in range(self.min_n, self.max_n + 1):
            if L < n:
                break
            ng = tuple(hist[L - n:])
            old = idx.get(ng)
            if old is not None:
                prev[ng] = old
            idx[ng] = L          # continuation starts after the n-gram
        return None

    def drop(self, req_id: int) -> None:
        """Forget a request (finished or evicted).  Idempotent."""
        self._hist.pop(req_id, None)
        self._idx.pop(req_id, None)
        self._prev.pop(req_id, None)

    def history_len(self, req_id: int) -> int:
        return len(self._hist.get(req_id, ()))

    # ----------------------------------------------------------- proposal
    def propose(self, req_id: int, max_tokens: int | None = None):
        """Draft up to ``min(k, max_tokens)`` continuation tokens for
        ``req_id``, or ``[]`` when its tail n-gram has no prior
        occurrence (the engine then takes the plain decode step)."""
        hist = self._hist.get(req_id)
        if not hist:
            return []
        cap = self.k if max_tokens is None else min(self.k, max_tokens)
        if cap <= 0:
            return []
        L = len(hist)
        idx, prev = self._idx[req_id], self._prev[req_id]
        for n in range(min(self.max_n, L), self.min_n - 1, -1):
            ng = tuple(hist[L - n:])
            start = idx.get(ng)
            if start == L:                  # the tail matching itself
                start = prev.get(ng)
            if start is None or start >= L:
                continue
            return list(hist[start:start + cap])
        return []


class SpecStats:
    """Acceptance bookkeeping: one ``record`` per verify-step slot, with
    python mirrors for ``Engine.stats()`` and the perf gate."""

    def __init__(self):
        self.proposed = 0
        self.accepted = 0
        self.rejected = 0
        self.verify_steps = 0
        self.committed_tokens = 0   # accepted + correction/bonus tokens

    def record_step(self) -> None:
        """One verify-program device step (any number of drafted slots)."""
        self.verify_steps += 1
        _M_SPEC_STEPS.inc()

    def record(self, proposed: int, accepted: int) -> None:
        """One slot's outcome inside a verify step: ``proposed`` draft
        tokens, of which ``accepted`` matched the target; the slot also
        committed one correction/bonus token on top."""
        rejected = proposed - accepted
        self.proposed += proposed
        self.accepted += accepted
        self.rejected += rejected
        self.committed_tokens += accepted + 1
        if proposed:
            _M_SPEC_TOKENS.labels("proposed").inc(proposed)
        if accepted:
            _M_SPEC_TOKENS.labels("accepted").inc(accepted)
        if rejected:
            _M_SPEC_TOKENS.labels("rejected").inc(rejected)
        _M_SPEC_PER_STEP.observe(accepted + 1)
        _M_SPEC_RATE.set(self.acceptance_rate)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    def snapshot(self) -> dict:
        return {"spec_proposed": self.proposed,
                "spec_accepted": self.accepted,
                "spec_rejected": self.rejected,
                "spec_verify_steps": self.verify_steps,
                "spec_committed_tokens": self.committed_tokens,
                "spec_acceptance_rate": self.acceptance_rate}
