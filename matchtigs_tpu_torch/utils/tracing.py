"""Spans: the named phases of a call, on the host's monotonic clock.

``with span("load.read") as sp: ...; sp.add(records=n)`` marks a phase.
A span records its name, its start and end (``time.monotonic()``), its
own id, the id of its parent (the span open around it on the same
thread: each thread has its own stack) and the id of its root (the
outermost span, one per CLI call), and the scalar counters added to it
where the work happens.  Counters are numbers, never arrays.

Tracing is off by default.  Then ``span(name)`` returns ``NOOP``, one
shared object whose methods do nothing, after one check: nothing is
allocated and nothing is kept.  A span that times something the program
uses or logs (``timed=True``; its INFO line set with ``Span.lap``) is
always a real span: it times, and on exit logs its line with its seconds
in the place of ``ELAPSED``.  The others are real while tracing is on or
this module's logger is enabled for DEBUG (the CLI's ``--log-level
Debug``): each then logs its name, seconds and counters at DEBUG on exit.

Tracing is on while ``sink``, the function every finished real span is
passed to, is anything but ``discard``: a caller turns it on by putting
its own function in this module attribute, and off by putting
``discard`` back.  The sink runs on the thread that closed the span.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time

logger = logging.getLogger(__name__)


class _Elapsed:
    __slots__ = ()

    def __repr__(self) -> str:
        return "ELAPSED"


# in a lap line's arguments: the span's own seconds
ELAPSED = _Elapsed()


def discard(span: "Span") -> None:
    """The sink while tracing is off; ``span`` never calls it."""


sink = discard
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One phase.  ``parent`` is 0 for a root; ``end`` and ``seconds``
    are set when the ``with`` block exits."""

    __slots__ = ("name", "start", "end", "id", "parent", "root", "counters", "_lap")

    def __init__(self, name: str):
        self.name = name
        self.start = self.end = 0.0
        self.id = next(_ids)
        self.parent = 0
        self.root = self.id
        self.counters: dict = {}
        self._lap = None

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        stack.append(self)
        self.start = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end = time.monotonic()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # a child left open by an exception
            del stack[stack.index(self):]
        if self._lap is not None:
            if exc_type is None:
                log, msg, args = self._lap
                log.info(msg, *(self.seconds if a is ELAPSED else
                                self.end - a.start if isinstance(a, Span) else a
                                for a in args))
        elif logger.isEnabledFor(logging.DEBUG):
            logger.debug("span %s %.6fs%s", self.name, self.seconds,
                         "".join(f" {k}={v}" for k, v in self.counters.items()))
        if sink is not discard:
            sink(self)
        return False

    def __bool__(self) -> bool:
        return True

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def add(self, **counters) -> None:
        """Add each value to the counter of its name (from 0)."""
        for key, value in counters.items():
            self.counters[key] = self.counters.get(key, 0) + value

    def lap(self, log: logging.Logger, msg: str, *args) -> None:
        """Log ``msg`` at INFO on ``log`` when the block exits without an
        exception, with ``ELAPSED`` among ``args`` replaced by this span's
        seconds and a ``Span`` by the seconds since it started."""
        self._lap = (log, msg, args)


class _Noop:
    """The span while tracing is off: falsy, so a caller can skip work
    that only feeds counters (``if sp: sp.add(...)``)."""

    __slots__ = ()

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def add(self, **counters) -> None:
        pass


NOOP = _Noop()


def span(name: str, timed: bool = False):
    """A phase named ``name``: a new ``Span``, or ``NOOP`` unless
    ``timed``, tracing is on, or DEBUG logging is."""
    if not timed and sink is discard and not logger.isEnabledFor(logging.DEBUG):
        return NOOP
    return Span(name)
