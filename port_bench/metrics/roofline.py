"""Per-layer metrics of the kind ``roofline``: a kernel's share (%) of
its roofline, the least time the card could take over the time the
profiler saw the kernel run.

The least time of a call is the larger of its bytes at the HBM rate and
its operations at the core rate (NVIDIA H100 SXM data sheet: 3.35 TB/s,
and 67 T/s outside the tensor cores; the kernels' integer work runs on
those cores).  Bytes: each tensor the call takes and each it returns,
counted once at its size.  Operations: the relaxations of the balls the
call found (``search_ops``).

``entry`` is the program's ``[module, attribute]`` of the kernel's
launcher, wrapped where its callers look it up.  ``per_call`` is the name
of the kernel the launcher starts once per call; ``kernels`` lists every
kernel name whose device time counts (matched as substrings), and with
``memset_before`` the memset that the launcher enqueues right before
``per_call`` counts too.  A window whose profiler lost a launch (fewer
``per_call`` kernels than wrapped calls) gives no reading.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
# packed search rows hold (node << DIST_BITS) | dist (the program's
# output contract of its search stage)
DIST_BITS = 7


def bound_seconds(bytes_moved: int, ops: int) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time the card could
    take."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / CORE_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensor_bytes(*values) -> int:
    """Bytes of every tensor among ``values``, each counted once."""
    seen, total = set(), 0
    for v in values:
        if isinstance(v, torch.Tensor) and id(v) not in seen:
            seen.add(id(v))
            total += v.numel() * v.element_size()
    return total


def search_ops(adj: torch.Tensor, rows: torch.Tensor, dist, over: torch.Tensor):
    """Relaxations of a bounded-ball search: one per adjacency slot of
    every member of the balls found (a ball that overflowed its capacity C
    counts C + 1 members), as a 0-dim tensor on the rows' device.  Packed
    rows (``dist`` None) hold the node in their high bits; unpacked rows
    hold it alone; empty slots hold the sentinel, ``adj``'s last row."""
    sentinel = adj.shape[0] - 1
    nodes = rows if dist is not None else rows >> DIST_BITS
    done = (over == 0).unsqueeze(1)
    members = ((nodes != sentinel) & done).sum()
    members = members + (over != 0).sum() * (rows.shape[1] + 1)
    return members * adj.shape[1]


def install(name: str, spec: dict, trace) -> None:
    from ..trace import KernelCall

    module, attr = spec["entry"]
    key = f"{module}.{attr}"
    if key in trace.kernel_calls:
        return  # another metric wrapped it already
    calls = trace.kernel_calls[key] = []

    def make(original):
        def recorded(*args, **kwargs):
            result = original(*args, **kwargs)
            out = result if isinstance(result, tuple) else (result,)
            # (rows, flags) or (rows, dist, flags); the count is enqueued
            # behind the launch: no synchronize here
            dist = out[1] if len(out) == 3 else None
            calls.append(KernelCall(tensor_bytes(*args, *kwargs.values(), *out),
                                    search_ops(args[0], out[0], dist, out[-1])))
            return result
        return recorded

    trace.wrap(module, attr, make)


def device_seconds(spec: dict, events: list) -> tuple[float, int]:
    """(seconds, launches): the device time of the kernels ``spec`` names
    and the number of its ``per_call`` kernels among ``events`` (sorted
    by start)."""
    seconds, launches = 0.0, 0
    for i, e in enumerate(events):
        if any(k in e.name for k in spec["kernels"]):
            seconds += e.seconds
        if spec["per_call"] in e.name:
            launches += 1
            if spec.get("memset_before") and i and "memset" in events[i - 1].name.lower():
                seconds += events[i - 1].seconds
    return seconds, launches


def read(name: str, spec: dict, trace) -> float | None:
    calls = trace.kernel_calls.get(".".join(spec["entry"]), [])
    if not calls:
        return None
    seconds, launches = device_seconds(spec, trace.device_events)
    if launches != len(calls) or seconds <= 0:
        return None
    bound = sum(bound_seconds(c.bytes_moved, int(c.ops))[0] for c in calls)
    return 100.0 * bound / seconds
