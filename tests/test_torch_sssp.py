"""The port's pool search stage (K1+K2) against the JAX package's pool
scheduler: equal overflow flags, bit-equal rows wherever the ball fit,
and equal extracted candidates.  Both sides read the same adjacency.
The other stage modes are in test_torch_stage_modes.py."""

import numpy as np
import pytest
import torch

from matchtigs_tpu import testing
from matchtigs_tpu.graph.build import build_bigraph_from_unitigs
from matchtigs_tpu.ops import sssp as jsssp
from matchtigs_tpu.ops.device_graph import build_device_graph
from matchtigs_tpu.ops.matching import unbalanced_nodes
from matchtigs_tpu_torch.interop import device_graph_from_numpy
from matchtigs_tpu_torch.ops import sssp as tsssp


def _random_sources(n_nodes, seed=0):
    rng = np.random.default_rng(seed)
    return rng.choice(n_nodes, size=min(32, n_nodes), replace=False)


# (make_unitig_store case, source picker): the graphs and sources of
# tests/test_sssp.py's matches-host-Dijkstra, overflow-flag and
# pool-packed-output tests.
STAGE_CASES = {
    "dijkstra-k9": (dict(genome_length=3000, k=9, seed=0), _random_sources),
    "dijkstra-k11": (dict(genome_length=6000, k=11, seed=1), _random_sources),
    "dijkstra-k7": (dict(genome_length=2000, k=7, seed=2), _random_sources),
    "overflow": (
        dict(genome_length=6000, k=9, seed=3),
        lambda n: np.arange(min(16, n)),
    ),
    "pool-packed": (
        dict(genome_length=4000, k=9, seed=7),
        lambda n: np.arange(min(50, n)),
    ),
}


def _graphs(case):
    store, _, k = testing.make_unitig_store(**case)
    g = build_bigraph_from_unitigs(store, k)
    jdg = build_device_graph(g)
    tdg = device_graph_from_numpy(jdg.n_nodes, jdg.nbr, jdg.nw, jdg.deg_pad)
    return g, jdg, tdg, k


@pytest.mark.parametrize("capacity", [4, 16])
@pytest.mark.parametrize("name", list(STAGE_CASES))
def test_plain_stage_matches_jax_pool(name, capacity):
    case, pick = STAGE_CASES[name]
    _, jdg, tdg, k = _graphs(case)
    sources = pick(jdg.n_nodes).astype(np.int32)
    jkey, _, jover = jsssp.batched_bounded_sssp(
        jdg, sources, max_weight=k - 1, capacity=capacity, batch_size=16,
        schedule="pool", return_packed=True,
    )
    tkey, none, tover = tsssp.batched_bounded_sssp(
        tdg, sources, k - 1, capacity, return_packed=True, device="cpu"
    )
    assert none is None and tkey.dtype == np.int32
    assert np.array_equal(tover, jover)
    done = ~tover
    assert np.array_equal(tkey[done], jkey[done])
    # and each complete row is the host oracle's ball
    for i in np.flatnonzero(done):
        row = tkey[i]
        got = {
            int(n): int(d)
            for n, d in zip(row >> tsssp.DIST_BITS, row & tsssp.DIST_CAP)
            if d != tsssp.DIST_CAP
        }
        assert got == tsssp.sssp_reference_host(tdg, int(sources[i]), k - 1)


@pytest.mark.parametrize("capacity", [4, 16])
def test_extracted_candidates_match_jax(capacity):
    g, jdg, tdg, k = _graphs(dict(genome_length=6000, k=11, seed=3))
    out_nodes, in_mask, _ = unbalanced_nodes(g)
    sources = out_nodes.astype(np.int32)
    jh = jsssp.batched_bounded_sssp_dispatch(
        jdg, sources, k - 1, capacity=capacity, batch_size=16
    )
    jtri, jover = jh.fetch_candidates(jdg, sources, in_mask)
    th = tsssp.batched_bounded_sssp_dispatch(
        tdg, sources, k - 1, capacity, "cpu"
    )
    assert th.kernel_seconds() is None  # no device clock on the CPU
    ttri, tover = th.fetch_candidates(tdg, sources, in_mask)
    assert np.array_equal(tover, jover)
    assert len(ttri) > 0
    for col in ("u", "v", "d"):
        assert np.array_equal(getattr(ttri, col), getattr(jtri, col)), col


def test_unpacked_view_and_empty_sources():
    _, jdg, tdg, k = _graphs(dict(genome_length=3000, k=9, seed=0))
    sources = np.arange(20, dtype=np.int32)
    jn, jd, jo = jsssp.batched_bounded_sssp(
        jdg, sources, max_weight=k - 1, capacity=16, batch_size=8,
        schedule="pool",
    )
    tn, td, to = tsssp.batched_bounded_sssp(
        tdg, sources, k - 1, 16, device="cpu"
    )
    assert np.array_equal(to, jo)
    assert np.array_equal(tn[~to], jn[~to]) and np.array_equal(td[~to], jd[~to])
    key, _, over = tsssp.batched_bounded_sssp(
        tdg, np.empty(0, np.int32), k - 1, 4, return_packed=True, device="cpu"
    )
    assert key.shape == (0, 4) and over.shape == (0,)


def test_sentinel_source_row_is_empty():
    _, jdg, tdg, k = _graphs(dict(genome_length=3000, k=9, seed=0))
    sources = np.array([0, jdg.n_nodes, 1], dtype=np.int32)
    jkey, _, jover = jsssp.batched_bounded_sssp(
        jdg, sources, max_weight=k - 1, capacity=4, batch_size=3,
        schedule="pool", return_packed=True,
    )
    tkey, _, tover = tsssp.batched_bounded_sssp(
        tdg, sources, k - 1, 4, return_packed=True, device="cpu"
    )
    assert np.array_equal(tover, jover) and np.array_equal(tkey, jkey)
    empty = (jdg.n_nodes << tsssp.DIST_BITS) | tsssp.DIST_CAP
    assert np.all(tkey[1] == empty)


def test_pool_sssp_rejects_what_the_kernel_cannot_take():
    """Capacity 5, max_weight 127 and the batch schedule, once refused,
    now run and match the JAX stage; wrong dtypes, a packed adjacency
    bounded at 127 and a source id out of range are still refused."""
    _, jdg, tdg, k = _graphs(dict(genome_length=3000, k=9, seed=0))
    adj = tdg.device_buffers("cpu")
    src = torch.arange(4, dtype=torch.int32)
    key, over = tsssp.pool_sssp(adj, src, k - 1, 5)
    jkey, _, jover = jsssp.batched_bounded_sssp(
        jdg, src.numpy(), max_weight=k - 1, capacity=5, batch_size=4,
        schedule="pool", return_packed=True,
    )
    assert np.array_equal(over.numpy().astype(bool), jover)
    assert np.array_equal(key.numpy()[~jover], jkey[~jover])
    with pytest.raises(ValueError):
        tsssp.pool_sssp(adj, src.long(), k - 1, 4)
    with pytest.raises(ValueError):
        tsssp.pool_sssp(adj.long(), src, k - 1, 4)
    with pytest.raises(ValueError, match="max_weight"):
        tsssp.pool_sssp(adj, src, 127, 4)  # clamped packed weights
    with pytest.raises(ValueError, match="source id"):
        tsssp.batched_bounded_sssp(
            tdg, np.array([tdg.n_nodes + 1]), k - 1, 4, device="cpu"
        )
    for schedule, max_weight in (("pool", 127), ("batch", k - 1)):
        tn, td, to = tsssp.batched_bounded_sssp(
            tdg, np.arange(4), max_weight, 4, schedule=schedule, device="cpu"
        )
        jn, jd, jo = jsssp.batched_bounded_sssp(
            jdg, np.arange(4, dtype=np.int32), max_weight=max_weight,
            capacity=4, batch_size=4, schedule=schedule,
        )
        jd = np.where(jd > max_weight, tsssp.INF, jd)
        assert np.array_equal(to, jo)
        assert np.array_equal(tn[~to], jn[~to]) and np.array_equal(td[~to], jd[~to])
