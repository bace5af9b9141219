"""Layer-1 driver: walk files, run rules, apply noqa + baseline suppression.

The engine is pure stdlib (``ast``/``json``/``pathlib``) so the source
lint runs on any box, with or without torch installed. Entry points:

- :func:`analyze_source` — lint one source string under a virtual path
  (what the per-rule fixtures in ``tests/test_torch_analysis.py`` use).
- :func:`run_source_analysis` — lint a set of real paths, returning
  ``(active, baselined)`` findings after suppression.

Suppression, two forms (as in ``repro.analysis``):

- inline: a trailing ``# repro: noqa RPR004`` (or ``RPR004,RPR005``) on
  the flagged line;
- baseline: an entry in ``analysis-baseline-torch.json`` keyed by
  ``(rule, path, stripped line text)`` with a one-line justification.
  Keying on line *content* instead of line numbers keeps the baseline
  stable under unrelated edits above the finding.
"""

from __future__ import annotations

import ast
import json
import pathlib
import re
from typing import Iterable, Sequence

from .rules import RULES, Finding

__all__ = [
    "analyze_source", "run_source_analysis", "collect_files",
    "load_baseline", "Baseline", "BaselineEntry",
]

_NOQA_RE = re.compile(r"#\s*repro:\s*noqa\b[:\s]*([A-Z0-9,\s]*)")


# --------------------------------------------------------------------------
# Baseline
# --------------------------------------------------------------------------

class BaselineEntry:
    __slots__ = ("rule", "path", "line_text", "justification")

    def __init__(self, rule: str, path: str, line_text: str,
                 justification: str = ""):
        self.rule = rule
        self.path = path
        self.line_text = line_text.strip()
        self.justification = justification

    @property
    def key(self) -> tuple:
        return (self.rule, self.path, self.line_text)


class Baseline:
    """Content-keyed suppression list loaded from
    ``analysis-baseline-torch.json``."""

    def __init__(self, entries: Sequence[BaselineEntry] = ()):
        self._by_key = {e.key: e for e in entries}

    def __len__(self) -> int:
        return len(self._by_key)

    def matches(self, finding: Finding) -> bool:
        key = (finding.code, finding.path, finding.line_text.strip())
        return key in self._by_key

    @classmethod
    def from_dict(cls, data: dict) -> "Baseline":
        entries = [
            BaselineEntry(e["rule"], e["path"], e["line_text"],
                          e.get("justification", ""))
            for e in data.get("entries", ())
        ]
        return cls(entries)


def load_baseline(path: str | pathlib.Path | None) -> Baseline:
    if path is None:
        return Baseline()
    p = pathlib.Path(path)
    if not p.exists():
        return Baseline()
    with open(p) as fh:
        return Baseline.from_dict(json.load(fh))


# --------------------------------------------------------------------------
# Core analysis
# --------------------------------------------------------------------------

def _noqa_codes(line: str) -> set[str] | None:
    """Codes suppressed on this line; empty set means 'suppress all'."""
    m = _NOQA_RE.search(line)
    if not m:
        return None
    codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
    return codes


def analyze_source(source: str, rel_path: str) -> list[Finding]:
    """Run every applicable rule over one source blob.

    ``rel_path`` is the repo-relative posix path the rules use for module
    classification — fixtures can impersonate any module (e.g.
    ``src/repro_torch/core/simulate.py``) without touching the real file.
    """
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [Finding(code="RPR000", path=rel_path,
                        line=exc.lineno or 1, col=exc.offset or 0,
                        message=f"syntax error: {exc.msg}",
                        line_text="")]
    lines = source.splitlines()
    findings: list[Finding] = []
    for rule in RULES:
        if not rule.applies(rel_path):
            continue
        findings.extend(rule.check(tree, lines, rel_path))

    kept = []
    for f in findings:
        if 0 < f.line <= len(lines):
            codes = _noqa_codes(lines[f.line - 1])
            if codes is not None and (not codes or f.code in codes):
                continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return kept


def collect_files(paths: Iterable[str | pathlib.Path],
                  root: pathlib.Path) -> list[pathlib.Path]:
    """Expand files/directories into a sorted list of ``.py`` files."""
    out: set[pathlib.Path] = set()
    for p in paths:
        p = pathlib.Path(p)
        if not p.is_absolute():
            p = root / p
        if p.is_dir():
            out.update(q for q in p.rglob("*.py") if q.is_file())
        elif p.is_file() and p.suffix == ".py":
            out.add(p)
    return sorted(out)


def run_source_analysis(
    paths: Sequence[str | pathlib.Path],
    root: str | pathlib.Path,
    baseline: Baseline | None = None,
) -> tuple[list[Finding], list[Finding]]:
    """Lint ``paths`` (files or dirs) relative to ``root``.

    Returns ``(active, baselined)``: findings that survive suppression,
    and the ones a baseline entry absorbed (shown separately so the
    summary table can report both).
    """
    root = pathlib.Path(root).resolve()
    baseline = baseline or Baseline()
    files = collect_files(paths, root)
    active: list[Finding] = []
    suppressed: list[Finding] = []
    for path in files:
        rel = path.resolve().relative_to(root).as_posix()
        source = path.read_text()
        for f in analyze_source(source, rel):
            (suppressed if baseline.matches(f) else active).append(f)
    return active, suppressed
