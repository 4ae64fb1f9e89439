"""paddle_tpu_torch.sanitizer — runtime concurrency sanitizer.

Ports ``paddle_tpu/sanitizer/``: instrumented Lock/RLock/Condition
wrappers (lock-order recording + runtime ABBA detection), Eraser-style
per-field candidate locksets, and a live lock-wait graph for hang
dumps.

Production code adopts the ``make_lock``/``make_rlock``/
``make_condition`` factories; with ``FLAGS_sanitizer`` off they return
plain ``threading`` primitives, so the instrumented path costs nothing
unless explicitly enabled (env ``FLAGS_sanitizer=1`` or
``set_flags({"FLAGS_sanitizer": True})``).

Findings use the reference's schema, fingerprints and text report
(``findings.py``) and surface in the flight recorder under the
"sanitizer" track.
"""
from .lockset import (RULES, SanitizedLock, SanitizedRLock,  # noqa: F401
                      TrackedField, clear, enabled, findings,
                      lock_wait_graph, make_condition, make_lock,
                      make_rlock, render)

__all__ = ["RULES", "SanitizedLock", "SanitizedRLock", "TrackedField",
           "clear", "enabled", "findings", "lock_wait_graph",
           "make_condition", "make_lock", "make_rlock", "render"]
