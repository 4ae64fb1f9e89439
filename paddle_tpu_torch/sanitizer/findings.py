"""The sanitizer's finding record and its text report.

A copy of :class:`Finding` (``paddle_tpu/analysis/core.py``) and
``render_text`` (``paddle_tpu/analysis/reporters.py``): the same fields,
the same line-free fingerprint and the same one-line rendering, so a
sanitizer report of the port reads like one of the reference and
baselines match across the two packages.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

__all__ = ["Finding", "render_text"]


@dataclass
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str               # repo-relative, posix separators
    line: int
    message: str
    severity: str = "error"
    hint: str = ""
    col: int = 0

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"

    @property
    def fingerprint(self) -> str:
        """Stable identity for baseline matching.  Deliberately excludes
        the line number — adding code above a known finding must not
        turn it into a "new" one."""
        raw = f"{self.rule}|{self.path}|{self.message}"
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "severity": self.severity, "message": self.message,
                "hint": self.hint, "fingerprint": self.fingerprint}

    def render(self) -> str:
        text = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            text += f"  (fix: {self.hint})"
        return text


def render_text(findings: list[Finding], baselined: int = 0) -> str:
    """One line per finding, sorted by location, plus a summary line."""
    lines = [f.render() for f in
             sorted(findings, key=lambda f: (f.path, f.line, f.rule))]
    by_rule: dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    summary = (f"{len(findings)} finding"
               f"{'' if len(findings) == 1 else 's'}")
    if by_rule:
        summary += " (" + ", ".join(
            f"{n} {r}" for r, n in sorted(by_rule.items())) + ")"
    if baselined:
        summary += f"; {baselined} baselined finding" \
                   f"{'' if baselined == 1 else 's'} suppressed"
    lines.append(summary)
    return "\n".join(lines)
