"""Per-layer metrics of the kind ``device_idle``: the share (%) of the
traced window in which no kernel, copy or memset ran on the card, from
the profiler's device events."""

from __future__ import annotations

from ..trace import busy_intervals


def install(name: str, spec: dict, trace) -> None:
    """Nothing to wrap: the profiler runs over every traced window."""


def read(name: str, spec: dict, trace) -> float | None:
    lo, hi = trace.window
    busy = sum(t - s for s, t in busy_intervals(trace.device_events, lo, hi))
    if busy <= 0 or hi <= lo:
        return None
    return 100.0 * (1.0 - busy / (hi - lo))
