"""The CUDA kernels of the port on the card: each against its plain torch
version, and on the greedy and optimal matchtigs paths.

These tests import only the port, so they also run where JAX is absent
(``tests/conftest.py`` imports jax; skip it there):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a CUDA device they skip.  All comparisons are integer and exact.
"""

import numpy as np
import pytest
import torch

from matchtigs_tpu_torch import testing
from matchtigs_tpu_torch.algos.greedytigs import (
    GreedytigConfig,
    SearchStats,
    compute_greedytigs,
)
from matchtigs_tpu_torch.algos.matchtigs import MatchtigConfig, compute_matchtigs
from matchtigs_tpu_torch.graph.build import build_bigraph_from_unitigs
from matchtigs_tpu_torch.interop import device_graph_from_numpy
from matchtigs_tpu_torch.ops import mesh_sort, sssp
from matchtigs_tpu_torch.ops.device_graph import build_device_graph
from matchtigs_tpu_torch.parallel import mesh

pytestmark = pytest.mark.cuda

CASES = [dict(genome_length=40000, k=13, seed=7), dict(genome_length=3000, k=9, seed=0)]
CASE_IDS = ["40k-k13", "3k-k9"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _device_graph(case):
    store, _, k = testing.make_unitig_store(**case)
    return build_device_graph(build_bigraph_from_unitigs(store, k)), k


def _assert_rows_equal(got, want):
    """(rows, dist, over) of a kernel against its plain version: equal
    flags, equal rows wherever the ball fit."""
    rows, dist, over = (None if t is None else t.cpu() for t in got)
    prows, pdist, pover = want
    assert torch.equal(over, pover)
    done = over == 0
    assert torch.equal(rows[done], prows[done])
    if pdist is not None:
        assert torch.equal(dist[done], pdist[done])


# (graph, capacity): the 40k graph has no overflow at C=4, the 3k k=9 graph
# overflows some rows at C=4 and none at C=16.
@pytest.mark.parametrize("capacity", [4, 16])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_kernel_matches_plain(cuda_device, case, capacity):
    dg, k = _device_graph(case)
    src = torch.arange(dg.n_nodes + 1, dtype=torch.int32)  # sentinel included
    before = dict(sssp.KERNEL_LAUNCHES)
    key, over = sssp.pool_sssp(
        dg.device_buffers(cuda_device), src.to(cuda_device), k - 1, capacity
    )
    torch.cuda.synchronize()
    assert sssp.KERNEL_LAUNCHES["sssp_pool"] == before["sssp_pool"] + 1
    assert sssp.KERNEL_LAUNCHES["sssp_wide"] == before["sssp_wide"]
    want = sssp.pool_sssp_plain(dg.device_buffers("cpu"), src, k - 1, capacity)
    _assert_rows_equal((key, None, over), want)


@pytest.fixture(scope="module")
def pangenome_sources():
    """A pangenome from the flagship's generator (k=31, 7 strains, 1%
    mutations, repeats), cut to 300 kbp: its device graph and its device
    sources in the caller's order, of which the first 20,000 are used."""
    from matchtigs_tpu_torch.algos.greedytigs import split_device_sources
    from matchtigs_tpu_torch.ops.matching import unbalanced_nodes

    store, _, k = testing.make_pangenome_store(
        genome_length=300_000, k=31, n_strains=7, mutation_rate=0.01, seed=0,
        with_repeats=True,
    )
    g = build_bigraph_from_unitigs(store, k)
    dg = build_device_graph(g)
    pending, _ = split_device_sources(
        dg, unbalanced_nodes(g)[0], GreedytigConfig.host_route_threshold
    )
    assert len(pending) >= 20_000
    return dg, k, torch.from_numpy(np.ascontiguousarray(pending, np.int32))


@pytest.mark.parametrize("S", [0, 1, 31, 33, 1000, 20_000])
@pytest.mark.parametrize("capacity", [*sssp.CAPACITIES, 64])
def test_pool_matches_plain_at_every_capacity(cuda_device, pangenome_sources, capacity, S):
    """The register kernel at each of its capacities, and C = 64 on the
    wide kernel, on the first S device sources of a flagship-style
    pangenome (S = 1000 is no multiple of the 256-thread block)."""
    dg, k, pending = pangenome_sources
    src = pending[:S].contiguous()
    kernel = "sssp_pool" if capacity in sssp.CAPACITIES else "sssp_wide"
    before = dict(sssp.KERNEL_LAUNCHES)
    key, over = sssp.pool_sssp(dg.device_buffers(cuda_device), src.to(cuda_device), k - 1, capacity)
    torch.cuda.synchronize()
    assert key.shape == (S, capacity) and over.shape == (S,)
    assert sssp.KERNEL_LAUNCHES[kernel] == before[kernel] + (S > 0)
    assert sum(sssp.KERNEL_LAUNCHES.values()) == sum(before.values()) + (S > 0)
    want = sssp.pool_sssp_plain(dg.device_buffers("cpu"), src, k - 1, capacity)
    _assert_rows_equal((key, None, over), want)


@pytest.mark.parametrize("capacity", sssp.CAPACITIES)
def test_pool_sentinel_and_out_of_range_sources(cuda_device, pangenome_sources, capacity):
    """The sentinel source gets an empty row and no flag; ids outside
    [0, sentinel] are flagged, never read."""
    dg, k, pending = pangenome_sources
    sentinel = dg.n_nodes
    src = torch.tensor([sentinel, -1, sentinel + 1, (1 << 30), -(1 << 31), *pending[:27].tolist()],
                       dtype=torch.int32)
    key, over = sssp.pool_sssp(dg.device_buffers(cuda_device), src.to(cuda_device), k - 1, capacity)
    key, over = key.cpu(), over.cpu()
    assert over[:5].tolist() == [0, 1, 1, 1, 1]
    empty = (sentinel << sssp.DIST_BITS) | sssp.DIST_CAP
    assert key[0].tolist() == [empty] * capacity
    want = sssp.pool_sssp_plain(dg.device_buffers("cpu"), src, k - 1, capacity)
    _assert_rows_equal((key, None, over), want)


def test_pool_back_to_back_calls_on_one_stream(cuda_device, pangenome_sources):
    """Calls enqueued one after another without a synchronize, at every
    capacity and twice each: each equals the plain version (state left
    behind by one launch would show in the next)."""
    dg, k, pending = pangenome_sources
    adj = dg.device_buffers(cuda_device)
    src = pending[:20_000].contiguous()
    dev_src = src.to(cuda_device)
    runs = [(C, sssp.pool_sssp(adj, dev_src, k - 1, C)) for C in sssp.CAPACITIES for _ in range(2)]
    torch.cuda.synchronize()
    for C, got in runs:
        _assert_rows_equal((got[0], None, got[1]),
                           sssp.pool_sssp_plain(dg.device_buffers("cpu"), src, k - 1, C))


def test_pool_on_a_device_that_is_not_current(cuda_device, pangenome_sources):
    """Operands on cuda:0 while cuda:1 is current: the launch goes to the
    operands' device."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dg, k, pending = pangenome_sources
    dev0 = torch.device("cuda", 0)
    src = pending[:1000].contiguous()
    adj, dev_src = dg.device_buffers(dev0), src.to(dev0)
    with torch.cuda.device(1):
        key, over = sssp.pool_sssp(adj, dev_src, k - 1, 4)
        torch.cuda.synchronize(dev0)
    _assert_rows_equal((key, None, over),
                       sssp.pool_sssp_plain(dg.device_buffers("cpu"), src, k - 1, 4))


def test_pool_kernel_spills_nothing(cuda_device):
    """The working set of C keys stays in registers at every capacity."""
    for capacity in sssp.CAPACITIES:
        regs, local = sssp.pool_kernel_attributes(capacity)
        assert 0 < regs <= 255 and local == 0, (capacity, regs, local)


# (layout, max_weight offset): packed at k-1; the unpacked pair and rows at
# max_weight 30 and 130 (the k=131 bound).
LAYOUTS = {"packed": None, "unpacked-30": 30, "unpacked-130": 130}


@pytest.mark.parametrize("schedule", ["pool", "batch"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("capacity", [1, 5, 128, 1024, 20000])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_wide_matches_plain(cuda_device, case, capacity, layout, schedule):
    """C=20000 puts the working set in the global slab, the rest in
    shared memory."""
    dg, k = _device_graph(case)
    src = torch.arange(dg.n_nodes + 1, dtype=torch.int32)
    mw = LAYOUTS[layout]
    if mw is None:
        mw, adj, nw = k - 1, dg.device_buffers(cuda_device), None
    else:
        adj, nw = dg.device_buffers(cuda_device, adj_packed=False)
    if capacity == 20000:
        src = src[:64]  # the slab path; a few rows suffice
    src = src.to(cuda_device)
    before = sssp.KERNEL_LAUNCHES["sssp_wide"]
    got = sssp.wide_sssp(
        adj, src, mw, capacity, nw=nw, pack_out=nw is None, schedule=schedule,
    )
    torch.cuda.synchronize()
    assert sssp.KERNEL_LAUNCHES["sssp_wide"] == before + 1
    # the plain version on the card too: the same inputs, faster
    want = sssp.pool_sssp_plain(adj, src, mw, capacity, nw=nw, pack_out=nw is None)
    _assert_rows_equal(got, tuple(None if t is None else t.cpu() for t in want))


def test_wide_takes_deg_pad_5(cuda_device):
    """A node of out-degree 5, built by hand: the packed and the unpacked
    adjacency with five slots per row."""
    n, deg = 8, 5
    nbr = np.full((n + 1, deg), n, np.int32)
    nw = np.full((n + 1, deg), 1 << 20, np.int32)
    nbr[0] = [1, 2, 3, 4, 5]
    nw[0] = [1, 2, 3, 1, 2]
    nbr[1, :2], nw[1, :2] = [6, 7], [1, 3]
    nbr[6, 0], nw[6, 0] = 0, 2
    dg = device_graph_from_numpy(n, nbr, nw, deg)
    src = torch.arange(n + 1, dtype=torch.int32)
    for capacity in (4, 8):
        got = sssp.pool_sssp(dg.device_buffers(cuda_device), src.to(cuda_device), 4, capacity)
        want = sssp.pool_sssp_plain(dg.device_buffers("cpu"), src, 4, capacity)
        _assert_rows_equal((got[0], None, got[1]), want)
        nbr_d, nw_d = dg.device_buffers(cuda_device, adj_packed=False)
        got = sssp.wide_sssp(
            nbr_d, src.to(cuda_device), 4, capacity, nw=nw_d, pack_out=False
        )
        cpu_nbr, cpu_nw = dg.device_buffers("cpu", adj_packed=False)
        want = sssp.pool_sssp_plain(cpu_nbr, src, 4, capacity, nw=cpu_nw, pack_out=False)
        _assert_rows_equal(got, want)


W = sssp.WARP_TIER_CAPACITY


def _wide_vs_plain(n, nbr, nw, deg, src, max_weight, capacity, layout, schedule, device):
    """The wide kernel on ``device`` against its plain version on the CPU,
    over a hand-built adjacency; returns the kernel's overflow flags."""
    dg = device_graph_from_numpy(n, nbr, nw, deg)
    if layout == "packed":
        adj, w = dg.device_buffers("cpu"), None
    else:
        adj, w = dg.device_buffers("cpu", adj_packed=False)
    src = torch.as_tensor(src, dtype=torch.int32)
    got = sssp.wide_sssp(adj.to(device), src.to(device), max_weight, capacity,
                         nw=None if w is None else w.to(device), pack_out=w is None,
                         schedule=schedule)
    torch.cuda.synchronize()
    want = sssp.pool_sssp_plain(adj, src, max_weight, capacity, nw=w, pack_out=w is None)
    _assert_rows_equal(got, want)
    return got[2].cpu()


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
@pytest.mark.parametrize("schedule", ["pool", "batch"])
@pytest.mark.parametrize("capacity", [W, W + 1, 256])
@pytest.mark.parametrize("ball", [W, W + 1, 2 * W])
def test_wide_ball_at_the_warp_tier_edge(cuda_device, ball, capacity, schedule, layout):
    """Node 0's ball has exactly W, W + 1 or 2W nodes: it stays in the warp
    tier, just spills to the second tier, or spills far; the other sources
    give the subtrees' smaller balls."""
    n, nbr, nw, mw = testing.ball_graph(ball, 2)
    over = _wide_vs_plain(n, nbr, nw, 4, np.arange(n + 1), mw, capacity, layout,
                          schedule, cuda_device)
    assert int(over[0]) == (ball > capacity)


@pytest.mark.parametrize("schedule", ["pool", "batch"])
@pytest.mark.parametrize("capacity", [2 * W, 256, 1024, 2048, 20000])
def test_wide_every_source_spills(cuda_device, capacity, schedule):
    """Every source has a 2W-node ball, so the warp tier hands all of them
    to the second tier: one warp per source (C <= 1024), a block in shared
    memory (2048) or in the global slab (20000)."""
    n, nbr, nw, mw = testing.ball_graph(2 * W, 3)
    src = np.zeros(3000 if capacity < 20000 else 300, np.int64)
    for layout in ("packed", "unpacked"):
        over = _wide_vs_plain(n, nbr, nw, 4, src, mw, capacity, layout, schedule,
                              cuda_device)
        assert not over.any()


def test_wide_unpacked_c4_past_a_million_sources(cuda_device):
    """The default stage of a graph past 2^24 nodes: the wide kernel's pool
    schedule at C=4 over the unpacked adjacency, unpacked rows, one launch
    and no register-kernel launch, on the sources of a ball graph repeated
    past 2^20 (balls from one node to past the capacity)."""
    n, nbr, nw, mw = testing.ball_graph(2 * W, 3)
    src = np.tile(np.arange(n + 1), (1 << 20) // (n + 1) + 2)
    assert len(src) > 1 << 20
    before = dict(sssp.KERNEL_LAUNCHES)
    over = _wide_vs_plain(n, nbr, nw, 4, src, mw, 4, "unpacked", "pool", cuda_device)
    assert sssp.KERNEL_LAUNCHES["sssp_wide"] == before["sssp_wide"] + 1
    assert sssp.KERNEL_LAUNCHES["sssp_pool"] == before["sssp_pool"]
    assert over.any() and not over.all()


@pytest.mark.parametrize("capacity", [4, 5, 16, 256])
def test_wide_on_five_node_chains(cuda_device, capacity):
    """The flagship's typical overflow ball: a chain of five nodes (five
    levels), 20,000 disjoint chains, every node a source."""
    chains, length = 20_000, 5
    n = chains * length
    nbr = np.full((n + 1, 4), n, np.int32)
    nw = np.full((n + 1, 4), 1 << 20, np.int32)
    node = np.arange(n).reshape(chains, length)
    nbr[node[:, :-1], 0] = node[:, 1:]
    nw[node[:, :-1], 0] = 1 + node[:, 1:] % 3
    for schedule in sssp.SCHEDULES:
        over = _wide_vs_plain(n, nbr, nw, 4, np.arange(n + 1), 12, capacity, "packed",
                              schedule, cuda_device)
        assert int(over[node[:, 0]].sum()) == (chains if capacity < length else 0)


def test_wide_repeats_exactly(cuda_device):
    """The same 200k sources at C=256 searched 20 times give one result:
    a race between the tiers or in the atomics would show as a run that
    differs."""
    dg, k = _device_graph(CASES[0])
    rng = np.random.default_rng(5)
    src = torch.from_numpy(rng.integers(0, dg.n_nodes + 1, 200_000).astype(np.int32))
    adj = dg.device_buffers(cuda_device)
    src_d = src.to(cuda_device)
    want = sssp.pool_sssp_plain(adj, src_d, k - 1, 256)
    want = tuple(None if t is None else t.cpu() for t in want)
    for schedule in sssp.SCHEDULES:
        runs = [sssp.wide_sssp(adj, src_d, k - 1, 256, schedule=schedule)
                for _ in range(10)]
        torch.cuda.synchronize()
        for got in runs:
            _assert_rows_equal(got, want)
            assert torch.equal(got[0].cpu(), runs[0][0].cpu())


# C = 1 overflows nearly every ball at its source; 5000 is more slots than
# a tile of the kernel holds, so its rows are walked in pieces
@pytest.mark.parametrize("budget", [None, 7, 0, "all"])
@pytest.mark.parametrize("capacity", [1, 3, 4, 5, 127, 128, 256, 5000])
def test_compact_matches_plain(cuda_device, capacity, budget):
    dg, k = _device_graph(CASES[1])
    src = torch.arange(dg.n_nodes + 1, dtype=torch.int32)
    key, over = sssp.pool_sssp(dg.device_buffers(cuda_device), src.to(cuda_device), k - 1, capacity)
    budget = {None: key.numel() // 4, "all": key.numel()}.get(budget, budget)
    before = sssp.KERNEL_LAUNCHES["sssp_compact"]
    vals, counts, total = sssp.compact_rows(key, over, dg.sentinel, k - 1, budget)
    torch.cuda.synchronize()
    assert sssp.KERNEL_LAUNCHES["sssp_compact"] == before + 1
    pvals, pcounts, ptotal = sssp.compact_rows_plain(
        key.cpu(), over.cpu(), dg.sentinel, k - 1, budget
    )
    assert int(total) == int(ptotal)
    assert int(ptotal) > 0 or capacity == 1
    assert counts.dtype == pcounts.dtype and torch.equal(counts.cpu(), pcounts)
    n = min(int(ptotal), budget)
    assert torch.equal(vals[:n].cpu(), pvals[:n])


def _random_rows(S, C, over_frac, seed=0):
    """Packed rows of random nodes (a fifth of them the sentinel 1000) and
    distances in [0, 127], and overflow flags."""
    rng = np.random.default_rng(seed + S * 7 + C)
    node = np.where(rng.random((S, C)) < 0.2, 1000, rng.integers(0, 1000, (S, C)))
    dist = rng.integers(0, 128, (S, C))
    rows = (node << sssp.DIST_BITS | dist).astype(np.int32)
    over = (rng.random(S) < over_frac).astype(np.uint8)
    return torch.from_numpy(rows), torch.from_numpy(over)


# (S, C, share of rows overflowed): one row; S not a multiple of the rows
# per tile (4096 / C); C = 3 and 5 (rows not 16-byte aligned); C around the
# int8 counts; rows longer than a tile; every row overflowed
RANDOM_ROWS = {
    "S1-C4": (1, 4, 0.0), "S1-C5000": (1, 5000, 0.0), "ragged-C4": (3 * 1024 + 7, 4, 0.1),
    "C1": (10_000, 1, 0.1), "C3": (5000, 3, 0.1), "C5": (2000, 5, 0.1),
    "C127": (300, 127, 0.1), "C128": (300, 128, 0.1), "C4097": (5, 4097, 0.2),
    "C20000": (7, 20000, 0.2), "all-overflowed": (2000, 4, 1.0),
}


@pytest.mark.parametrize("budget", ["zero", "half", "above"])
@pytest.mark.parametrize("name", list(RANDOM_ROWS))
def test_compact_matches_plain_on_random_rows(cuda_device, name, budget):
    S, C, over_frac = RANDOM_ROWS[name]
    rows, over = _random_rows(S, C, over_frac)
    _, _, want_total = sssp.compact_rows_plain(rows, over, 1000, 30, 0)
    budget = {"zero": 0, "half": int(want_total) // 2, "above": int(want_total) + 5}[budget]
    pvals, pcounts, ptotal = sssp.compact_rows_plain(rows, over, 1000, 30, budget)
    vals, counts, total = sssp.compact_rows(rows.to(cuda_device), over.to(cuda_device),
                                            1000, 30, budget)
    torch.cuda.synchronize()
    assert int(total) == int(ptotal)
    assert counts.dtype == pcounts.dtype == (torch.int8 if C <= 127 else torch.int32)
    assert torch.equal(counts.cpu(), pcounts)
    n = min(int(ptotal), budget)
    assert torch.equal(vals[:n].cpu(), pvals[:n])


def test_device_engine_runs_the_kernel(cuda_device):
    store, kmers, k = testing.make_pangenome_store(
        genome_length=20000, k=13, n_strains=4, mutation_rate=0.02, seed=11,
        with_repeats=True,
    )
    g = build_bigraph_from_unitigs(store, k)
    want = compute_greedytigs(g.copy(), GreedytigConfig(k=k, engine="host"))
    for option in ({}, dict(overflow_mode="ladder"), dict(device_schedule="batch")):
        sssp.reset_kernel_launches()
        stats = SearchStats()
        gg = g.copy()
        got = compute_greedytigs(gg, GreedytigConfig(k=k, **option), stats)
        launches = dict(sssp.KERNEL_LAUNCHES)
        if not option:  # the default path: one launch of the register kernel
            assert launches == {"sssp_pool": 1, "sssp_wide": 0, "sssp_compact": 0,
                                "mesh_sort": 0, "mesh_merge_split": 0}
        assert sum(launches.values()) == len(stats.stage_kernel_times) >= 1
        assert all(t > 0 for t in stats.stage_kernel_times)
        assert np.array_equal(got.flat, want.flat), option
        assert np.array_equal(got.offsets, want.offsets), option
        testing.assert_tigs_spell_kmer_set(gg, got, store, k, kmers, allow_duplicates=True)


def test_matchtigs_run_the_kernel_once(cuda_device):
    """Optimal matchtigs on the card, by default: one launch of the register
    kernel, and the host engine's walks."""
    store, kmers, k = testing.make_pangenome_store(
        genome_length=20000, k=13, n_strains=4, mutation_rate=0.02, seed=11,
        with_repeats=True,
    )
    g = build_bigraph_from_unitigs(store, k)
    want = compute_matchtigs(g.copy(), MatchtigConfig(k=k, engine="host"))
    sssp.reset_kernel_launches()
    gg = g.copy()
    got = compute_matchtigs(gg, MatchtigConfig(k=k))
    assert dict(sssp.KERNEL_LAUNCHES) == {"sssp_pool": 1, "sssp_wide": 0, "sssp_compact": 0,
                                          "mesh_sort": 0, "mesh_merge_split": 0}
    assert np.array_equal(got.flat, want.flat)
    assert np.array_equal(got.offsets, want.offsets)
    testing.assert_tigs_spell_kmer_set(gg, got, store, k, kmers, allow_duplicates=True)


@pytest.mark.parametrize("k,repeats", [(9, False), (21, True), (31, True)])
def test_pangenome_store_on_the_card_equals_numpy(cuda_device, k, repeats):
    """The torch generator on the card: codes, offsets and k-mers equal the
    numpy path's bit for bit."""
    case = dict(genome_length=200000, k=k, n_strains=7, mutation_rate=0.01, seed=3,
                with_repeats=repeats)
    want, want_kmers, _ = testing.make_pangenome_store(**case)
    got, got_kmers, _ = testing.make_pangenome_store(**case, device=cuda_device)
    assert np.array_equal(got_kmers, want_kmers)
    assert np.array_equal(got.offsets, want.offsets)
    assert np.array_equal(got.codes, want.codes)


@pytest.mark.parametrize("k", [32, 33, 63])
def test_two_word_generator_on_the_card_equals_cpu(cuda_device, k):
    """The torch generator's two-word keys (k = 32: hi holds no base) on the
    card against its own run on the CPU, bit for bit."""
    case = dict(genome_length=200000, k=k, n_strains=7, mutation_rate=0.01, seed=5,
                with_repeats=True)
    want, want_kmers, _ = testing.make_pangenome_store(**case, device="cpu")
    got, got_kmers, _ = testing.make_pangenome_store(**case, device=cuda_device)
    assert got_kmers.dtype == np.dtype("V16") and np.array_equal(got_kmers, want_kmers)
    assert np.array_equal(got.offsets, want.offsets)
    assert np.array_equal(got.codes, want.codes)


@pytest.mark.parametrize("k", [31, 32, 63])
def test_spelled_kmers_on_the_card_equal_numpy(cuda_device, k):
    """The smoke's k-mer oracle (one word and two) on the card against the
    numpy multiset of the same sequences."""
    store, _, _ = testing.make_pangenome_store(
        genome_length=100000, k=k, n_strains=4, mutation_rate=0.01, seed=6, with_repeats=True)
    got = testing.kmers_to_numpy(testing.spelled_kmers_torch(store, k, cuda_device))
    want = testing.kmer_multiset_of_walk_seqs([store.get(i) for i in range(len(store))], k)
    assert np.array_equal(np.sort(got), want)


@pytest.mark.parametrize("renumber", [False, True])
def test_greedy_renumber_runs_the_kernel_once(cuda_device, renumber):
    """``renumber=True`` on the card: one register-kernel launch and the
    host engine's walks."""
    store, kmers, k = testing.make_pangenome_store(
        genome_length=20000, k=13, n_strains=4, mutation_rate=0.02, seed=11,
        with_repeats=True,
    )
    g = build_bigraph_from_unitigs(store, k)
    want = compute_greedytigs(g.copy(), GreedytigConfig(k=k, engine="host"))
    sssp.reset_kernel_launches()
    got = compute_greedytigs(g.copy(), GreedytigConfig(k=k, renumber=renumber))
    assert sssp.KERNEL_LAUNCHES["sssp_pool"] == 1
    assert np.array_equal(got.flat, want.flat)
    assert np.array_equal(got.offsets, want.offsets)


def test_k131_runs_the_wide_kernel(cuda_device):
    store, kmers, k = testing.make_unitig_store_strings(
        genome_length=4000, k=131, seed=131, n_sequences=3
    )
    g = build_bigraph_from_unitigs(store, k)
    want = compute_greedytigs(g.copy(), GreedytigConfig(k=k, engine="host"))
    sssp.reset_kernel_launches()
    gg = g.copy()
    got = compute_greedytigs(gg, GreedytigConfig(k=k, engine="device"))
    assert sssp.KERNEL_LAUNCHES["sssp_wide"] >= 1
    assert np.array_equal(got.flat, want.flat)
    assert np.array_equal(got.offsets, want.offsets)
    testing.assert_tigs_spell_kmer_strings(gg, got, store, k, kmers)


def test_kernel_rejects_what_it_cannot_take(cuda_device):
    """A capacity outside the register kernel's set goes to the wide
    kernel; operands on two devices and a packed adjacency bounded at 127
    are refused."""
    dg, k = _device_graph(CASES[1])
    adj = dg.device_buffers(cuda_device)
    src = torch.arange(4, dtype=torch.int32)
    before = dict(sssp.KERNEL_LAUNCHES)
    key, over = sssp.pool_sssp(adj, src.to(cuda_device), k - 1, 5)
    torch.cuda.synchronize()
    assert sssp.KERNEL_LAUNCHES["sssp_wide"] == before["sssp_wide"] + 1
    assert sssp.KERNEL_LAUNCHES["sssp_pool"] == before["sssp_pool"]
    assert key.shape == (4, 5) and over.shape == (4,)
    with pytest.raises(ValueError, match="one device"):
        sssp.pool_sssp(adj, src, k - 1, 4)
    with pytest.raises(ValueError, match="one device"):
        sssp.wide_sssp(adj, src, k - 1, 5)
    with pytest.raises(ValueError, match="max_weight"):
        sssp.wide_sssp(adj, src.to(cuda_device), 127, 5)  # packed adjacency


# sizes around 2048 and around the radix sort's tile (mesh_sort.TILE), many
# look-back tiles, and 2^20 + 3 keys
SORT_SIZES = [1, 2, 2047, 2048, 2049, mesh_sort.TILE - 1, mesh_sort.TILE,
              mesh_sort.TILE + 1, 100_000, 64 * mesh_sort.TILE + 1, (1 << 20) + 3]
SORT_KINDS = ["random", "duplicates", "padding", "top-byte", "constant-middle",
              "all-padding", "all-equal", "negative"]


def _keys(n, kind, seed=0):
    rng = np.random.default_rng(seed + n)
    if kind == "random":
        return rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    if kind == "duplicates":  # the d << 56 clusters of the acceptance keys
        return rng.integers(0, 5, n, dtype=np.int64) << 56
    if kind == "top-byte":  # only the top digit, the sign bit's, differs
        return (rng.integers(-128, 128, n, dtype=np.int64) << 56) | 0x123456789ABC
    if kind == "constant-middle":  # digits 1-6 equal in every key: skipped passes
        return ((rng.integers(-128, 128, n, dtype=np.int64) << 56)
                | (0x3C << 24) | rng.integers(0, 256, n, dtype=np.int64))
    if kind == "all-padding":
        return np.full(n, mesh.KEY_PAD, dtype=np.int64)
    if kind == "all-equal":
        return np.full(n, -12345678901, dtype=np.int64)
    if kind == "negative":
        return rng.integers(-(1 << 63), 0, n, dtype=np.int64)
    keys = np.full(n, mesh.KEY_PAD, dtype=np.int64)  # mostly padding
    keys[: n // 3] = rng.integers(0, 1 << 62, n // 3, dtype=np.int64)
    return keys


@pytest.mark.parametrize("kind", SORT_KINDS)
@pytest.mark.parametrize("n", SORT_SIZES)
def test_mesh_sort_matches_plain(cuda_device, n, kind):
    keys = torch.from_numpy(_keys(n, kind))
    dev_keys = keys.to(cuda_device)
    before = sssp.KERNEL_LAUNCHES["mesh_sort"]
    got = mesh_sort.sort_keys(dev_keys)
    torch.cuda.synchronize()
    assert sssp.KERNEL_LAUNCHES["mesh_sort"] == before + 1
    assert torch.equal(got.cpu(), mesh_sort.sort_keys_plain(keys))
    assert torch.equal(dev_keys.cpu(), keys)  # the input is left as it was


def test_mesh_sort_repeats_exactly(cuda_device):
    """The same 1 M keys sorted 20 times give one result: a race in the
    look-back would show as a run that differs."""
    keys = torch.from_numpy(_keys(1 << 20, "random")).to(cuda_device)
    want = mesh_sort.sort_keys_plain(keys.cpu())
    runs = [mesh_sort.sort_keys(keys) for _ in range(20)]
    torch.cuda.synchronize()
    for got in runs:
        assert torch.equal(got.cpu(), want)


def test_mesh_sort_takes_an_unaligned_view(cuda_device):
    """A view one key into its storage: the histogram's 16-byte loads do
    not apply."""
    base = torch.from_numpy(_keys(100_001, "random")).to(cuda_device)
    keys = base[1:]
    assert keys.data_ptr() % 16 == 8
    got = mesh_sort.sort_keys(keys)
    assert torch.equal(got.cpu(), mesh_sort.sort_keys_plain(keys.cpu()))


def test_mesh_sort_past_a_30_bit_count(cuda_device):
    """2^30 + 4097 random keys, more than a 30-bit look-back count holds,
    equal torch.sort's (~45 GB of the card while torch.sort checks them;
    all of it is freed after)."""
    n = (1 << 30) + 4097
    keys = got = want = None
    try:
        gen = torch.Generator(device=cuda_device).manual_seed(30)
        keys = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), dtype=torch.int64,
                             device=cuda_device, generator=gen)
        got = mesh_sort.sort_keys(keys)
        want = torch.sort(keys).values
        keys = None
        assert torch.equal(got, want)
    finally:
        del keys, got, want
        torch.cuda.empty_cache()


@pytest.mark.parametrize("keep_high", [False, True])
@pytest.mark.parametrize("L", [1, 7, 2049, 2303, 2304, 2305, 100_000, 2_593_945])
def test_mesh_merge_split_matches_plain(cuda_device, L, keep_high):
    a = torch.from_numpy(np.sort(_keys(L, "duplicates", seed=1)))
    b = torch.from_numpy(np.sort(_keys(L, "padding", seed=2)))
    before = sssp.KERNEL_LAUNCHES["mesh_merge_split"]
    got = mesh_sort.merge_split(a.to(cuda_device), b.to(cuda_device), keep_high)
    torch.cuda.synchronize()
    assert sssp.KERNEL_LAUNCHES["mesh_merge_split"] == before + 1
    assert torch.equal(got.cpu(), mesh_sort.merge_split_plain(a, b, keep_high))


def test_mesh_sort_takes_empty_blocks_and_refuses_two_devices(cuda_device):
    before = dict(sssp.KERNEL_LAUNCHES)
    empty = torch.empty(0, dtype=torch.int64, device=cuda_device)
    assert mesh_sort.sort_keys(empty).numel() == 0
    assert mesh_sort.merge_split(empty, empty, True).numel() == 0
    assert sssp.KERNEL_LAUNCHES == before  # nothing to launch
    with pytest.raises(ValueError, match="one device"):
        mesh_sort.merge_split(empty, torch.empty(0, dtype=torch.int64), False)


def test_sharded_stage_on_four_shards_of_one_card(cuda_device):
    """K6: four shards on one card launch the register kernel once each;
    the real rows equal the single-device stage's."""
    dg, k = _device_graph(CASES[0])
    sources = np.arange(dg.n_nodes, dtype=np.int32)
    four = mesh.make_mesh([cuda_device] * 4)
    for schedule in sssp.SCHEDULES:
        sssp.reset_kernel_launches()
        rows, _, over, srcs = mesh.sharded_bounded_sssp(
            dg, sources, k - 1, 4, four, schedule=schedule
        )
        launched = dict(sssp.KERNEL_LAUNCHES)
        assert launched["sssp_pool" if schedule == "pool" else "sssp_wide"] == 4
        real = srcs != dg.n_nodes
        one_rows, _, one_over = sssp.batched_bounded_sssp(
            dg, srcs[real], k - 1, 4, return_packed=True, schedule=schedule,
            device=cuda_device,
        )
        assert np.array_equal(over[real], one_over)
        done = ~one_over
        assert np.array_equal(rows[real][done], one_rows[done])


def test_sharded_accept_sort_on_four_shards_of_one_card(cuda_device):
    """K7: 4 block sorts and 12 merge-splits (4 rounds: 2, 1, 2, 1 pairs)."""
    keys = _keys(300_001, "duplicates") | np.arange(300_001, dtype=np.int64)
    sssp.reset_kernel_launches()
    got = mesh.sharded_accept_key_sort(keys, mesh.make_mesh([cuda_device] * 4))
    assert np.array_equal(got, np.sort(keys))
    assert sssp.KERNEL_LAUNCHES["mesh_sort"] == 4
    assert sssp.KERNEL_LAUNCHES["mesh_merge_split"] == 12


def test_mesh_greedytigs_on_one_card(cuda_device):
    store, kmers, k = testing.make_pangenome_store(
        genome_length=20000, k=13, n_strains=4, mutation_rate=0.02, seed=11,
        with_repeats=True,
    )
    g = build_bigraph_from_unitigs(store, k)
    want = compute_greedytigs(g.copy(), GreedytigConfig(k=k, engine="host"))
    sssp.reset_kernel_launches()
    gg = g.copy()
    got = compute_greedytigs(gg, GreedytigConfig(
        k=k, use_mesh=True, device=[cuda_device] * 4,
    ))
    assert sssp.KERNEL_LAUNCHES["sssp_pool"] == 4
    assert sssp.KERNEL_LAUNCHES["mesh_sort"] == 4
    assert np.array_equal(got.flat, want.flat)
    assert np.array_equal(got.offsets, want.offsets)
    testing.assert_tigs_spell_kmer_set(gg, got, store, k, kmers, allow_duplicates=True)
