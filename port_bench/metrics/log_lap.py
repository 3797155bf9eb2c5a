"""Per-layer metrics of the kind ``log_lap``: seconds that the program
itself logs.  ``logger`` names the program's logger; each entry of
``laps`` gives a record's format string (``msg``, matched whole) and the
index (``arg``) of the seconds among its arguments.  The value is the sum
over the window's records divided by the CLI calls completed in it."""

from __future__ import annotations


def install(name: str, spec: dict, trace) -> None:
    trace.listen(spec["logger"])


def read(name: str, spec: dict, trace) -> float | None:
    found, total = 0, 0.0
    for lap in spec["laps"]:
        for r in trace.records:
            if r.name == spec["logger"] and r.msg == lap["msg"]:
                total += float(r.args[lap["arg"]])
                found += 1
    if not found or not trace.calls:
        return None
    return total / len(trace.calls)
