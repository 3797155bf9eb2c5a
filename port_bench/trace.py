"""What a traced run records, for the per-layer metrics to read.

Spans are host-clock intervals around functions of the program, wrapped
where its callers look them up (a module attribute), only while a traced
window runs.  Log records are those of the program's loggers.  Kernel
calls are the bytes and operations of a wrapped kernel entry's calls (for
its roofline).  Device events are the profiler's kernels,
copies and memsets, on the host clock.  Nothing here is installed in an
untraced run.
"""

from __future__ import annotations

import functools
import importlib
import logging
import time
from dataclasses import dataclass, field


@dataclass
class Span:
    name: str
    start: float
    end: float
    call: int  # index of the CLI call it ran in


@dataclass
class DeviceEvent:
    name: str
    start: float  # host clock, seconds
    seconds: float


@dataclass
class KernelCall:
    bytes_moved: int  # the call's input and output tensors, each once
    ops: object  # a 0-dim device tensor, enqueued behind the call


@dataclass
class Trace:
    """The records of one traced window."""

    spans: list = field(default_factory=list)
    records: list = field(default_factory=list)
    kernel_calls: dict = field(default_factory=dict)
    device_events: list = field(default_factory=list)
    calls: list = field(default_factory=list)  # (start, end) of completed CLI calls
    unitigs: int = 0  # input unitigs of one call
    window: tuple = (0.0, 0.0)
    call_index: int = 0
    _undo: list = field(default_factory=list)
    _loggers: dict = field(default_factory=dict)

    def wrap(self, module: str, attr: str, make_wrapper) -> None:
        """Replace ``module.attr`` by ``make_wrapper(original)`` until
        ``restore``; wrapping the same attribute twice stacks."""
        mod = importlib.import_module(module)
        original = getattr(mod, attr)
        setattr(mod, attr, functools.wraps(original)(make_wrapper(original)))
        self._undo.append((mod, attr, original))

    def span(self, module: str, attr: str, name: str) -> None:
        """Record a span named ``name`` around every call of
        ``module.attr``."""
        def make(original):
            def timed(*args, **kwargs):
                t0 = time.monotonic()
                try:
                    return original(*args, **kwargs)
                finally:
                    self.spans.append(Span(name, t0, time.monotonic(), self.call_index))
            return timed
        self.wrap(module, attr, make)

    def listen(self, logger_name: str) -> None:
        """Keep the records of ``logger_name`` (at INFO and above)."""
        if logger_name in self._loggers:
            return
        handler = _Keep(self.records)
        logger = logging.getLogger(logger_name)
        self._loggers[logger_name] = (logger, handler, logger.level)
        if logger.getEffectiveLevel() > logging.INFO:
            logger.setLevel(logging.INFO)
        logger.addHandler(handler)

    def restore(self) -> None:
        for mod, attr, original in reversed(self._undo):
            setattr(mod, attr, original)
        self._undo.clear()
        for logger, handler, level in self._loggers.values():
            logger.removeHandler(handler)
            logger.setLevel(level)
        self._loggers.clear()

    def spans_named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]


class _Keep(logging.Handler):
    def __init__(self, records: list):
        super().__init__(logging.INFO)
        self.out = records

    def emit(self, record) -> None:
        self.out.append(record)


def device_events(prof, started: float) -> list:
    """The profiler's device operations (kernels, copies, memsets) as
    ``DeviceEvent``s on the host's monotonic clock (``time.monotonic``).
    The trace's start is on that clock; where it reads more than a minute
    from ``started`` (the host time just after the profiler started) it is
    taken to be on another, and ``started`` stands in for it."""
    from torch.autograd import DeviceType

    host_start = prof.profiler.kineto_results.trace_start_ns() / 1e9
    if abs(host_start - started) > 60:
        host_start = started
    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append(DeviceEvent(e.name, host_start + e.time_range.start / 1e6,
                                   e.time_range.elapsed_us() / 1e6))
    out.sort(key=lambda d: d.start)
    return out


def busy_intervals(events: list, lo: float, hi: float) -> list:
    """The union of the events' intervals, clipped to [lo, hi]."""
    merged: list = []
    for e in events:
        s, t = max(lo, e.start), min(hi, e.start + e.seconds)
        if t <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged
