"""The port's search stage in every single-device mode against the JAX
package's: any capacity, the pool and the batch schedule (K3), packed and
unpacked adjacency and rows, more than four slots per row, and the
on-device compaction (K4).  All comparisons are integer and exact.

The JAX pool stage leaves ``max_weight + 1`` (or 127) in its unpacked
empty slots where the port, like the JAX batch schedule, writes INF; the
sentinel node marks those slots either way, so the JAX side maps
``dist > max_weight`` to INF before comparing."""

import numpy as np
import pytest
import torch

from matchtigs_tpu import testing
from matchtigs_tpu.graph.build import build_bigraph_from_unitigs
from matchtigs_tpu.ops import sssp as jsssp
from matchtigs_tpu.ops.device_graph import DeviceGraph as JDeviceGraph
from matchtigs_tpu.ops.device_graph import build_device_graph
from matchtigs_tpu.ops.matching import unbalanced_nodes
from matchtigs_tpu_torch import testing as testing_torch
from matchtigs_tpu_torch.interop import device_graph_from_numpy
from matchtigs_tpu_torch.ops import sssp as tsssp

from test_torch_sssp import STAGE_CASES


def _graphs(case):
    store, _, k = testing.make_unitig_store(**case)
    g = build_bigraph_from_unitigs(store, k)
    jdg = build_device_graph(g)
    tdg = device_graph_from_numpy(jdg.n_nodes, jdg.nbr, jdg.nw, jdg.deg_pad)
    return g, jdg, tdg, k


def _assert_stage_equal(jdg, tdg, sources, max_weight, capacity, schedule):
    jn, jd, jo = jsssp.batched_bounded_sssp(
        jdg, sources, max_weight=max_weight, capacity=capacity, batch_size=16,
        schedule=schedule,
    )
    tn, td, to = tsssp.batched_bounded_sssp(
        tdg, sources, max_weight, capacity, schedule=schedule, device="cpu"
    )
    jd = np.where(jd > max_weight, tsssp.INF, jd)
    assert np.array_equal(to, jo)
    done = ~to
    assert np.array_equal(tn[done], jn[done])
    assert np.array_equal(td[done], jd[done])
    # empty slots hold (sentinel, INF) in both schedules
    empty = tn[done] == tdg.sentinel
    assert np.all(td[done][empty] == tsssp.INF)
    return to


def _unpack_gates(monkeypatch):
    for mod in (jsssp, tsssp):
        monkeypatch.setattr(mod, "_can_pack_out", lambda *a: False)
        monkeypatch.setattr(mod, "_can_pack_adj", lambda *a: False)


@pytest.mark.parametrize("schedule", ["pool", "batch"])
@pytest.mark.parametrize("capacity", [5, 64, 128, 1024])
@pytest.mark.parametrize("layout", ["packed", "unpacked"])
@pytest.mark.parametrize("name", list(STAGE_CASES))
def test_stage_matches_jax(monkeypatch, name, layout, capacity, schedule):
    """Unpacked: both sides' packing gates forced off at the k-1 bound."""
    case, pick = STAGE_CASES[name]
    _, jdg, tdg, k = _graphs(case)
    if layout == "unpacked":
        _unpack_gates(monkeypatch)
    sources = pick(jdg.n_nodes).astype(np.int32)
    _assert_stage_equal(jdg, tdg, sources, k - 1, capacity, schedule)


@pytest.mark.parametrize("schedule", ["pool", "batch"])
@pytest.mark.parametrize("capacity", [5, 128])
@pytest.mark.parametrize("name", list(STAGE_CASES))
def test_stage_matches_jax_above_127(name, capacity, schedule):
    """max_weight 130 (the k=131 bound) takes the unpacked layouts on both
    sides without any patching."""
    case, pick = STAGE_CASES[name]
    _, jdg, tdg, _ = _graphs(case)
    assert not tsssp._can_pack_adj(tdg, 130) and not tsssp._can_pack_out(tdg, 130)
    sources = pick(jdg.n_nodes).astype(np.int32)
    _assert_stage_equal(jdg, tdg, sources, 130, capacity, schedule)


def _deg5_graph():
    """A node of out-degree 5 (and a cycle back to it), built by hand."""
    n, deg = 8, 5
    nbr = np.full((n + 1, deg), n, np.int32)
    nw = np.full((n + 1, deg), 1 << 20, np.int32)
    nbr[0], nw[0] = [1, 2, 3, 4, 5], [1, 2, 3, 1, 2]
    nbr[1, :2], nw[1, :2] = [6, 7], [1, 3]
    nbr[6, 0], nw[6, 0] = 0, 2
    nbr[7, 0], nw[7, 0] = 5, 1
    jdg = JDeviceGraph(n_nodes=n, nbr=nbr, nw=nw, deg_pad=deg)
    return jdg, device_graph_from_numpy(n, nbr, nw, deg)


@pytest.mark.parametrize("max_weight", [4, 130])
@pytest.mark.parametrize("schedule", ["pool", "batch"])
@pytest.mark.parametrize("capacity", [4, 8])
def test_deg_pad_5_matches_jax(capacity, schedule, max_weight):
    jdg, tdg = _deg5_graph()
    sources = np.arange(jdg.n_nodes + 1, dtype=np.int32)  # sentinel included
    over = _assert_stage_equal(jdg, tdg, sources, max_weight, capacity, schedule)
    assert over[0] == (capacity < 8)  # node 0's ball has 8 nodes at bound 4+


W = tsssp.WARP_TIER_CAPACITY


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
@pytest.mark.parametrize("schedule", ["pool", "batch"])
@pytest.mark.parametrize("capacity", [W, W + 1, 256])
@pytest.mark.parametrize("ball", [W, W + 1, 2 * W])
def test_ball_at_the_warp_tier_edge_matches_jax(monkeypatch, ball, capacity, schedule,
                                                 layout):
    """Node 0's ball has exactly W, W + 1 or 2W nodes (the wide kernel's
    warp tier holds W members, so these balls stay in it, just spill, or
    spill far), at capacities on both sides of W; the other sources give
    the subtrees' smaller balls."""
    n, nbr, nw, max_weight = testing_torch.ball_graph(ball, 2)
    jdg = JDeviceGraph(n_nodes=n, nbr=nbr, nw=nw, deg_pad=4)
    tdg = device_graph_from_numpy(n, nbr, nw, 4)
    if layout == "unpacked":
        _unpack_gates(monkeypatch)
    sources = np.arange(n + 1, dtype=np.int32)  # sentinel included
    over = _assert_stage_equal(jdg, tdg, sources, max_weight, capacity, schedule)
    assert over[0] == (ball > capacity)


# C = 2, 5, 127 and 128 are the compaction kernel's boundary shapes (rows
# not 16-byte aligned, the int8/int32 counts); C = 1 overflows every ball
# with a neighbour, so it has no candidates to compare
@pytest.mark.parametrize("budget", [None, 7])
@pytest.mark.parametrize("capacity", [2, 4, 5, 16, 127, 128])
def test_compact_candidates_match_jax(capacity, budget):
    """The compact fetch gives the full fetch's candidate columns and JAX's
    compact dispatch's, with a budget that fits and one that overruns
    (then the full rows are fetched)."""
    g, jdg, tdg, k = _graphs(dict(genome_length=6000, k=11, seed=3))
    sources = np.arange(min(96, jdg.n_nodes), dtype=np.int32)
    in_mask = np.ones(jdg.n_nodes + 1, dtype=np.int8)
    in_mask[::3] = 0  # nontrivial mask
    jh = jsssp.batched_bounded_sssp_dispatch(
        jdg, sources, k - 1, capacity=capacity, batch_size=16, compact=True,
        budget=budget,
    )
    jtri, jover = jh.fetch_candidates(jdg, sources, in_mask)
    full = tsssp.batched_bounded_sssp_dispatch(tdg, sources, k - 1, capacity, "cpu")
    ftri, fover = full.fetch_candidates(tdg, sources, in_mask)
    th = tsssp.batched_bounded_sssp_dispatch(
        tdg, sources, k - 1, capacity, "cpu", compact=True, budget=budget
    )
    vals, counts, total = th._compacted
    if budget is not None:
        assert int(total) > budget  # exercises the full-fetch fallback
    ttri, tover = th.fetch_candidates(tdg, sources, in_mask)
    assert np.array_equal(tover, fover) and np.array_equal(tover, jover)
    assert len(ttri) > 0
    for col in ("u", "v", "d"):
        assert np.array_equal(getattr(ttri, col), getattr(ftri, col)), col
        assert np.array_equal(getattr(ttri, col), getattr(jtri, col)), col
    if int(total) <= th._budget:  # the compact download is the smaller
        assert th.bytes_fetched < full.bytes_fetched


def test_compact_rows_plain_counts_and_order():
    """The plain compaction: per-row counts (int8 at C <= 127, else
    int32), their int64 total, and the valid values row by row."""
    _, jdg, tdg, k = _graphs(dict(genome_length=3000, k=9, seed=0))
    sources = np.arange(jdg.n_nodes + 1, dtype=np.int32)
    for capacity in (2, 4, 5, 127, 128):
        rows, _, over = tsssp.batched_bounded_sssp(
            tdg, sources, k - 1, capacity, return_packed=True, device="cpu"
        )
        vals, counts, total = tsssp.compact_rows(
            torch.from_numpy(rows), torch.from_numpy(over.astype(np.uint8)),
            tdg.sentinel, k - 1, rows.size,
        )
        node, dist = rows >> tsssp.DIST_BITS, rows & tsssp.DIST_CAP
        valid = (node != tdg.sentinel) & (dist >= 1) & (dist <= k - 1) & ~over[:, None]
        assert counts.dtype == (torch.int8 if capacity <= 127 else torch.int32)
        assert np.array_equal(counts.numpy(), valid.sum(1))
        assert total.dtype == torch.int64 and int(total) == valid.sum()
        assert np.array_equal(vals[: int(total)].numpy(), rows[valid])


def test_unpacked_device_buffers_match_jax():
    _, jdg, tdg, _ = _graphs(dict(genome_length=3000, k=9, seed=0))
    nbr, nw = tdg.device_buffers("cpu", adj_packed=False)
    jnbr, jnw = jdg.device_buffers(adj_packed=False)
    assert np.array_equal(nbr.numpy(), np.asarray(jnbr))
    assert np.array_equal(nw.numpy(), np.asarray(jnw))
    assert tdg.device_buffers("cpu", adj_packed=False)[0] is nbr
    assert tdg.device_buffers("cpu") is not nbr


def test_extracted_unpacked_candidates_match_jax_numpy_extraction():
    """The numpy extraction of unpacked rows (k >= 128) against the JAX
    package's, which its collect_candidates runs inline."""
    g, jdg, tdg, _ = _graphs(dict(genome_length=6000, k=11, seed=3))
    out_nodes, in_mask, _ = unbalanced_nodes(g)
    sources = out_nodes.astype(np.int32)
    h = tsssp.batched_bounded_sssp_dispatch(tdg, sources, 130, 64, "cpu")
    tri, over = h.fetch_candidates(tdg, sources, in_mask)
    jn, jd, jo = jsssp.batched_bounded_sssp(
        jdg, sources, max_weight=130, capacity=64, batch_size=16
    )
    assert np.array_equal(over, jo)
    done = ~jo
    dn, dd, srcs = jn[done], jd[done], sources[done]
    valid = (dn != jdg.sentinel) & (dd >= 1) & (dd < jsssp.INF)
    valid &= in_mask[np.minimum(dn, len(in_mask) - 1)]
    s_idx, c_idx = np.nonzero(valid)
    assert len(tri) == len(s_idx) > 0
    assert np.array_equal(tri.u, srcs[s_idx])
    assert np.array_equal(tri.v, dn[s_idx, c_idx])
    assert np.array_equal(tri.d, dd[s_idx, c_idx])
