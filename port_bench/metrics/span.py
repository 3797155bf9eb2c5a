"""Per-layer metrics of the kind ``span``: the host seconds spent in the
program's functions named by ``targets`` (``[module, attribute]`` pairs,
wrapped where the program's callers look them up), summed over the
window and divided by the CLI calls completed in it."""

from __future__ import annotations


def install(name: str, spec: dict, trace) -> None:
    for module, attr in spec["targets"]:
        trace.span(module, attr, name)


def read(name: str, spec: dict, trace) -> float | None:
    spans = trace.spans_named(name)
    if not spans or not trace.calls:
        return None
    return sum(s.end - s.start for s in spans) / len(trace.calls)
