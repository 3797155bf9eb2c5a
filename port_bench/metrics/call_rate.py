"""Per-layer metrics of the kind ``call_rate``: the input unitigs of the
CLI calls completed in the traced window over the time from the first
one's start to the last one's end (host clock), one rate over the whole
window."""

from __future__ import annotations


def install(name: str, spec: dict, trace) -> None:
    """Nothing to wrap: the harness records every call's start and end."""


def read(name: str, spec: dict, trace) -> float | None:
    if not trace.calls:
        return None
    span = trace.calls[-1][1] - trace.calls[0][0]
    return trace.unitigs * len(trace.calls) / span if span > 0 else None
