"""Per-layer metrics of the kind ``program_span``: what the program's own
tracer (``matchtigs_tpu_torch/utils/tracing.py``) records in the traced
window.

``install`` turns the tracer on by wrapping its ``sink``: every finished
span is kept here with its ids and counters, and appended to the trace's
spans, so the breakdown names the idle gaps by the program's innermost
span.  A program without the tracer gives no reading of any of these
metrics.  A spec gives one of:

- ``spans``: names whose seconds are summed over the window and divided
  by the CLI calls completed in it;
- ``share``: 100 x the sum of the ``of`` counters over the sum of the
  ``over`` counters, each a ``[span name, counter]`` pair;
- ``untraced``: the share (%) of the completed calls' time (the harness's
  call intervals) in no leaf span (a span no other span names as its
  parent): the tracer's own coverage.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

from ..trace import Span

TRACER = "matchtigs_tpu_torch.utils.tracing"


@dataclass
class Record:
    name: str
    start: float
    end: float
    id: int
    parent: int  # 0 for a root
    root: int
    counters: dict
    call: int  # index of the CLI call it ran in


def install(name: str, spec: dict, trace) -> None:
    if getattr(trace, "program_spans", None) is not None:
        return  # another metric of this kind turned the tracer on already
    try:
        importlib.import_module(TRACER)
    except ImportError:
        return
    records = trace.program_spans = []

    def make(original):
        def keep(sp):
            records.append(Record(sp.name, sp.start, sp.end, sp.id, sp.parent, sp.root,
                                  dict(sp.counters), trace.call_index))
            trace.spans.append(Span(sp.name, sp.start, sp.end, trace.call_index))
            original(sp)
        return keep

    trace.wrap(TRACER, "sink", make)


def _union(intervals: list) -> float:
    total, end = 0.0, None
    for s, t in sorted(intervals):
        if end is None or s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total


def untraced_share(records: list, calls: list) -> float | None:
    """The share (%) of the ``calls`` intervals that no leaf record covers."""
    parents = {r.parent for r in records}
    leaves = [(r.start, r.end) for r in records if r.id not in parents]
    wall = sum(t1 - t0 for t0, t1 in calls)
    if wall <= 0:
        return None
    covered = sum(_union([(max(s, t0), min(t, t1)) for s, t in leaves if s < t1 and t > t0])
                  for t0, t1 in calls)
    return 100.0 * (1.0 - covered / wall)


def counter_sum(records: list, pairs: list) -> float:
    return sum(r.counters.get(counter, 0) for span, counter in pairs
               for r in records if r.name == span)


def read(name: str, spec: dict, trace) -> float | None:
    records = getattr(trace, "program_spans", None)
    if not records or not trace.calls:
        return None
    if "untraced" in spec:
        return untraced_share(records, trace.calls)
    if "share" in spec:
        over = counter_sum(records, spec["share"]["over"])
        return 100.0 * counter_sum(records, spec["share"]["of"]) / over if over else None
    names = set(spec["spans"])
    return sum(r.end - r.start for r in records if r.name in names) / len(trace.calls)
