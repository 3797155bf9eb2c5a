"""The roofline arithmetic against the bounds on record (PERF.md §6)."""

import pytest
import torch

from port_bench.metrics import roofline
from port_bench.trace import DeviceEvent


def meta(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_sssp_pool_bound_at_60_mbp():
    """60 Mbp, C=4: packed adjacency [10,238,351, 4], 4,468,927 sources,
    packed rows [S, 4] and flags: 0.0769 ms, bound by bytes."""
    n, s = 10_238_350, 4_468_927
    moved = roofline.tensor_bytes(meta(n + 1, 4), meta(s), meta(s, 4),
                                  meta(s, dtype=torch.uint8))
    ops_at_most = s * 5 * 4  # every source overflowing: C + 1 members
    seconds, by = roofline.bound_seconds(moved, ops_at_most)
    assert (round(seconds * 1e3, 4), by) == (0.0769, "bytes")


def test_sssp_wide_bound_past_2_24_nodes():
    """17,081,052 nodes, C=4: the unpacked pair (nbr, nw) [N + 1, 4] each,
    7,474,596 sources, rows and distances [S, 4] and flags: 0.2457 ms."""
    n, s = 17_081_052, 7_474_596
    moved = roofline.tensor_bytes(meta(n + 1, 4), meta(s), meta(n + 1, 4), meta(s, 4),
                                  meta(s, 4), meta(s, dtype=torch.uint8))
    seconds, by = roofline.bound_seconds(moved, s * 5 * 4)
    assert (round(seconds * 1e3, 4), by) == (0.2457, "bytes")


def test_a_tensor_counts_once():
    t = meta(10)
    assert roofline.tensor_bytes(t, t, 3, None) == 40


def test_bound_by_operations():
    assert roofline.bound_seconds(0, 67e12) == (1.0, "operations")


@pytest.mark.parametrize("packed", [True, False])
def test_search_ops(packed):
    """Three sources at C=3 over a degree-2 adjacency with sentinel 9: a
    ball of 2, a ball of 3, and one that overflowed (C + 1 = 4 members):
    (2 + 3 + 4) x 2 relaxations."""
    adj = torch.zeros(10, 2, dtype=torch.int32)
    nodes = torch.tensor([[1, 2, 9], [3, 4, 5], [9, 9, 9]], dtype=torch.int32)
    over = torch.tensor([0, 0, 1], dtype=torch.uint8)
    if packed:
        rows, dist = (nodes << roofline.DIST_BITS) | 5, None
    else:
        rows, dist = nodes, torch.zeros_like(nodes)
    assert int(roofline.search_ops(adj, rows, dist, over)) == 18


def test_device_seconds_with_the_memset_before_the_kernel():
    spec = dict(per_call="tier1", kernels=["tier1", "tier2"], memset_before=True)
    events = [DeviceEvent("Memcpy HtoD", 0.0, 1.0), DeviceEvent("Memset (Device)", 1.0, 0.5),
              DeviceEvent("void tier1<4>(Params)", 2.0, 2.0), DeviceEvent("tier2", 5.0, 1.0),
              DeviceEvent("Memset (Device)", 6.0, 9.0)]
    assert roofline.device_seconds(spec, events) == (3.5, 1)
    spec["memset_before"] = False
    assert roofline.device_seconds(spec, events) == (3.0, 1)
