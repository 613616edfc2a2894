"""Device time of named kernels in a traced window."""

from __future__ import annotations

import re


def device_seconds(trace: dict | None, patterns) -> float | None:
    """Seconds the kernels whose names match any of ``patterns`` (regular
    expressions) ran inside the window; None without a trace or where
    none ran."""
    if not trace:
        return None
    regs = [re.compile(p) for p in patterns]
    t = sum(s for name, s in trace["kernels_s"].items()
            if any(r.search(name) for r in regs))
    return t or None
