"""Rendering for the analysis CLI: text / json formats + the summary table."""

from __future__ import annotations

import json
from typing import Sequence

from .rules import RULES, Finding

__all__ = ["render_text", "render_json", "summary_table"]


def summary_table(active: Sequence[Finding],
                  baselined: Sequence[Finding]) -> str:
    """Per-rule counts, one row per rule code, stable order."""
    act: dict[str, int] = {}
    base: dict[str, int] = {}
    for f in active:
        act[f.code] = act.get(f.code, 0) + 1
    for f in baselined:
        base[f.code] = base.get(f.code, 0) + 1
    rows = []
    header = f"{'rule':<8} {'contract':<58} {'active':>6} {'baselined':>9}"
    rows.append(header)
    rows.append("-" * len(header))
    for rule in RULES:
        contract = rule.contract if len(rule.contract) <= 58 \
            else rule.contract[:55] + "..."
        rows.append(f"{rule.code:<8} {contract:<58} "
                    f"{act.get(rule.code, 0):>6} {base.get(rule.code, 0):>9}")
    known = {r.code for r in RULES}
    for code in sorted((set(act) | set(base)) - known):
        rows.append(f"{code:<8} {'(parse error)':<58} "
                    f"{act.get(code, 0):>6} {base.get(code, 0):>9}")
    rows.append("-" * len(header))
    rows.append(f"{'total':<8} {'':<58} {len(active):>6} {len(baselined):>9}")
    return "\n".join(rows)


def render_text(active: Sequence[Finding],
                baselined: Sequence[Finding]) -> str:
    parts = []
    for f in active:
        parts.append(f"{f.location}:{f.col}: {f.code} {f.message}")
        if f.line_text:
            parts.append(f"    {f.line_text}")
    if parts:
        parts.append("")
    parts.append(summary_table(active, baselined))
    return "\n".join(parts)


def render_json(active: Sequence[Finding],
                baselined: Sequence[Finding]) -> str:
    """Stable JSON: findings sorted, keys sorted, no volatile fields."""
    payload = {
        "version": 1,
        "findings": [f.to_dict() for f in active],
        "baselined": [f.to_dict() for f in baselined],
        "counts": {
            "active": len(active),
            "baselined": len(baselined),
        },
    }
    return json.dumps(payload, indent=2, sort_keys=True)
