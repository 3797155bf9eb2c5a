"""The port's mesh layer (``parallel/mesh.py``) against the JAX package's,
on the CPU: the sharded search stage (K6) on an 8-shard mesh of CPU
devices against JAX's on its 8 virtual CPU devices, the sharded acceptance
sort (K7) on 8 and 3 shards, the mesh accept path, and greedy matchtigs
over the mesh.  On the CPU the kernels run their plain torch versions.
All comparisons are integer and exact.

The JAX pool stage leaves ``max_weight + 1`` in its unpacked empty slots
where the port writes INF; the sentinel node marks those slots either
way, so the JAX side maps ``dist > max_weight`` to INF before comparing."""

import jax
import numpy as np
import pytest
import torch

from matchtigs_tpu import testing as jtesting
from matchtigs_tpu.graph.build import build_bigraph_from_unitigs as j_build
from matchtigs_tpu.ops import sssp as jsssp
from matchtigs_tpu.ops.device_graph import build_device_graph as j_device_graph
from matchtigs_tpu.ops.matching import unbalanced_nodes as j_unbalanced
from matchtigs_tpu.parallel import mesh as jmesh
from matchtigs_tpu_torch import testing as ttesting
from matchtigs_tpu_torch.algos.greedytigs import GreedytigConfig, SearchStats
from matchtigs_tpu_torch.algos.greedytigs import compute_greedytigs
from matchtigs_tpu_torch.graph.build import build_bigraph_from_unitigs as t_build
from matchtigs_tpu_torch.interop import device_graph_from_numpy
from matchtigs_tpu_torch.ops import mesh_sort
from matchtigs_tpu_torch.ops import sssp as tsssp
from matchtigs_tpu_torch.parallel import mesh as tmesh

CPU8 = ["cpu"] * 8
STAGE_GRAPH = dict(genome_length=5000, k=11, seed=0)
# the stage's bound: packed rows at k - 1; at 130 (the k=131 bound) the
# unpacked adjacency and rows, without any patching
BOUNDS = {"packed": lambda k: k - 1, "unpacked-130": lambda k: 130}


def _stage_graphs():
    store, _, k = jtesting.make_unitig_store(**STAGE_GRAPH)
    g = j_build(store, k)
    jdg = j_device_graph(g)
    tdg = device_graph_from_numpy(jdg.n_nodes, jdg.nbr, jdg.nw, jdg.deg_pad)
    out_nodes, in_mask, _ = j_unbalanced(g)
    mask = np.zeros(jdg.n_nodes + 1, dtype=bool)
    mask[: len(in_mask)] = in_mask
    return jdg, tdg, k, np.asarray(out_nodes, dtype=np.int32), mask


def _candidate_set(c):
    return set(zip(c.u.tolist(), c.v.tolist(), c.d.tolist()))


def test_jax_has_8_cpu_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("capacity", [4, 64])
@pytest.mark.parametrize("schedule", ["pool", "batch"])
@pytest.mark.parametrize("layout", list(BOUNDS))
def test_sharded_stage_matches_jax(layout, schedule, capacity):
    """Equal striped sources, equal overflow flags and rows on the real
    rows that fit, and equal candidate sets (C=4 overflows some sources)."""
    jdg, tdg, k, sources, mask = _stage_graphs()
    mw = BOUNDS[layout](k)
    jrows, jdist, jover, jsrcs = jmesh.sharded_bounded_sssp(
        jdg, sources, max_weight=mw, capacity=capacity, mesh=jmesh.make_mesh(),
        schedule=schedule,
    )
    trows, tdist, tover, tsrcs = tmesh.sharded_bounded_sssp(
        tdg, sources, mw, capacity, tmesh.make_mesh(CPU8), schedule=schedule,
    )
    assert np.array_equal(tsrcs, jsrcs)
    real = tsrcs != tdg.n_nodes
    assert int(real.sum()) == len(sources)
    assert np.array_equal(tover[real], jover[real])
    done = real & ~tover
    assert np.array_equal(trows[done], jrows[done])
    assert (tdist is None) == (jdist is None) == (layout == "packed")
    if tdist is None:
        jc = jsssp.extract_packed_candidates(jdg, jrows, jsrcs, done, mask)
        tc = tsssp.extract_packed_candidates(tdg, trows, tsrcs, done, mask)
    else:
        jdist = np.where(jdist > mw, tsssp.INF, jdist)
        assert np.array_equal(tdist[done], jdist[done])
        jc = tsssp.extract_unpacked_candidates(tdg, jrows, jdist, jsrcs, done, mask)
        tc = tsssp.extract_unpacked_candidates(tdg, trows, tdist, tsrcs, done, mask)
    assert len(tc) > 0 and _candidate_set(tc) == _candidate_set(jc)


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_sharded_stage_fetch_candidates_matches_one_device(n_dev):
    """The stage handle's candidates and per-source overflow flags (in the
    order of the sources given) equal the single-device stage's."""
    jdg, tdg, k, sources, mask = _stage_graphs()
    one = tsssp.batched_bounded_sssp_dispatch(tdg, sources, k - 1, 4, "cpu")
    tri1, over1 = one.fetch_candidates(tdg, sources, mask)
    stage = tmesh.sharded_bounded_sssp_dispatch(
        tdg, sources, k - 1, 4, tmesh.make_mesh(["cpu"] * n_dev)
    )
    tri, over = stage.fetch_candidates(tdg, sources, mask)
    assert over1.any() and np.array_equal(over, over1)
    assert _candidate_set(tri) == _candidate_set(tri1)
    assert stage.kernel_seconds() is None


def test_sharded_stage_unpacks_rows_on_request():
    jdg, tdg, k, sources, _ = _stage_graphs()
    mesh = tmesh.make_mesh(CPU8)
    packed, none, over, srcs = tmesh.sharded_bounded_sssp(tdg, sources, k - 1, 16, mesh)
    nodes, dist, over2, _ = tmesh.sharded_bounded_sssp(
        tdg, sources, k - 1, 16, mesh, return_packed=False
    )
    assert none is None and np.array_equal(over, over2)
    assert np.array_equal(nodes, packed >> tsssp.DIST_BITS)
    empty = (packed & tsssp.DIST_CAP) == tsssp.DIST_CAP
    assert np.all(dist[empty] == tsssp.INF)
    assert np.array_equal(dist[~empty], (packed & tsssp.DIST_CAP)[~empty])


SORT_SIZES = [0, 1, 7, 16, 1000, 54321]


@pytest.mark.parametrize("m", SORT_SIZES)
@pytest.mark.parametrize("n_dev", [8, 3])
def test_sharded_accept_key_sort_matches_jax_and_numpy(n_dev, m):
    rng = np.random.default_rng(m)
    keys = rng.integers(0, 1 << 62, m, dtype=np.int64)
    got = tmesh.sharded_accept_key_sort(keys, tmesh.make_mesh(["cpu"] * n_dev))
    assert got.dtype == np.int64 and np.array_equal(got, np.sort(keys))
    want = jmesh.sharded_accept_key_sort(keys, jmesh.make_mesh(jax.devices()[:n_dev]))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_dev", [8, 3])
def test_sharded_accept_key_sort_low_entropy_duplicates(n_dev):
    """The d << 56 key space clusters: many equal keys across blocks."""
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 5, 10000, dtype=np.int64)
    keys[::7] <<= 56
    got = tmesh.sharded_accept_key_sort(keys, tmesh.make_mesh(["cpu"] * n_dev))
    assert np.array_equal(got, np.sort(keys))
    want = jmesh.sharded_accept_key_sort(keys, jmesh.make_mesh(jax.devices()[:n_dev]))
    assert np.array_equal(got, want)


def _accept_case():
    """tests/test_multichip.py's accept case: a graph with self-mirrors and
    random multiplicities, three candidate chunks."""
    rng = np.random.default_rng(3)
    n = 5000
    mirror = np.arange(n, dtype=np.int32).reshape(-1, 2)[:, ::-1].reshape(-1)
    mirror[n - 200:] = np.arange(n - 200, n)
    m0 = np.empty(n, dtype=np.int64)
    half = rng.integers(-2, 3, n // 2)
    m0[0::2] = half
    m0[1::2] = -half
    m0[n - 200:] = rng.integers(0, 2, 200)
    cols = [
        tuple(rng.integers(lo, hi, m).astype(np.int64)
              for lo, hi in ((0, n), (0, n), (1, 31)))
        for m in (4000, 1, 2500)
    ]
    return n, mirror, m0, cols


def test_mesh_accept_path_matches_host_accept():
    """pack_accept_keys -> sharded sort -> packed scan accepts the same set
    (and leaves the same multiplicities) as the host greedy_accept, and
    as the JAX package's mesh accept path."""
    import matchtigs_tpu.ops.matching as JM
    import matchtigs_tpu_torch.ops.matching as TM
    from matchtigs_tpu.graph.bigraph import Bigraph as JBigraph
    from matchtigs_tpu.ops.candidates import Candidates as JCandidates
    from matchtigs_tpu_torch.graph.bigraph import Bigraph as TBigraph
    from matchtigs_tpu_torch.ops.candidates import Candidates as TCandidates

    n, mirror, m0, cols = _accept_case()
    tg = TBigraph(n, mirror.copy())
    chunks = [TCandidates(*(c.copy() for c in col)) for col in cols]
    keys = TM.pack_accept_keys(chunks)
    assert keys is not None
    m_mesh, m_host, m_jax = m0.copy(), m0.copy(), m0.copy()
    sorted_keys = tmesh.sharded_accept_key_sort(keys, tmesh.make_mesh(CPU8))
    acc_mesh = TM.greedy_accept_sorted_keys(tg, sorted_keys, m_mesh)
    acc_host = TM.greedy_accept(tg, TCandidates.concat(chunks), m_host)
    assert len(acc_mesh) > 0
    assert np.array_equal(acc_mesh, acc_host) and np.array_equal(m_mesh, m_host)
    jkeys = JM.pack_accept_keys([JCandidates(*(c.copy() for c in col)) for col in cols])
    acc_jax = JM.greedy_accept_sorted_keys(
        JBigraph(n, mirror.copy()), jmesh.sharded_accept_key_sort(jkeys), m_jax
    )
    assert np.array_equal(acc_mesh, acc_jax) and np.array_equal(m_mesh, m_jax)


@pytest.mark.parametrize("keep_high", [False, True])
@pytest.mark.parametrize("L", [1, 5, 2049])
def test_merge_split_plain_matches_numpy(L, keep_high):
    rng = np.random.default_rng(L)
    a = np.sort(rng.integers(0, 50, L, dtype=np.int64) << 56)
    b = np.sort(np.concatenate([
        rng.integers(0, 50, L - L // 2, dtype=np.int64) << 56,
        np.full(L // 2, tmesh.KEY_PAD, dtype=np.int64),
    ]))
    merged = np.sort(np.concatenate([a, b]))
    want = merged[L:] if keep_high else merged[:L]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for fn in (mesh_sort.merge_split, mesh_sort.merge_split_plain):
        got = fn(ta, tb, keep_high)
        assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


def test_sort_keys_plain_matches_numpy_and_checks_its_input():
    rng = np.random.default_rng(0)
    keys = rng.integers(-(1 << 62), 1 << 62, 3000, dtype=np.int64)
    keys[:5] = tmesh.KEY_PAD
    for fn in (mesh_sort.sort_keys, mesh_sort.sort_keys_plain):
        assert np.array_equal(fn(torch.from_numpy(keys)).numpy(), np.sort(keys))
    with pytest.raises(ValueError, match="int64"):
        mesh_sort.sort_keys(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="one length"):
        mesh_sort.merge_split(torch.zeros(4, dtype=torch.int64),
                              torch.zeros(3, dtype=torch.int64), False)


def test_make_mesh_names_its_devices():
    mesh = tmesh.make_mesh(["cpu", "cpu", torch.device("cpu")])
    assert mesh.size == 3 and mesh.first == 0 and mesh.world_size == 1
    assert all(d == torch.device("cpu") for d in mesh.devices)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()
    with pytest.raises(ValueError):
        tmesh.make_mesh([])
    assert tmesh.process_source_slice(np.arange(5)).tolist() == list(range(5))
    assert tmesh.distributed_euler_break(None, 31) is None


MESH_GRAPH = dict(genome_length=40000, k=13, seed=7)


@pytest.mark.parametrize(
    "option",
    [dict(host_route_threshold=-1, initial_capacity=64),
     dict(),
     dict(overflow_mode="ladder"),
     dict(device_schedule="batch", initial_capacity=5)],
    ids=["C64-no-routing", "default", "ladder", "batch-C5"],
)
def test_mesh_greedytigs_identical_to_jax_and_host(option):
    """Greedy matchtigs over the 8-shard mesh: walks equal the JAX
    package's mesh run on its 8 virtual devices and the port's host
    engine; the k-mer set is spelled exactly."""
    from matchtigs_tpu.algos.greedytigs import GreedytigConfig as JConfig
    from matchtigs_tpu.algos.greedytigs import compute_greedytigs as j_greedy

    store, _, k = jtesting.make_unitig_store(**MESH_GRAPH)
    want = j_greedy(j_build(store, k), JConfig(
        k=k, use_mesh=True, engine="device", batch_size=8, **option,
    ))
    tstore, kmers, tk = ttesting.make_unitig_store(**MESH_GRAPH)
    tg = t_build(tstore, tk)
    host = compute_greedytigs(tg.copy(), GreedytigConfig(k=tk, engine="host"))
    stats = SearchStats()
    g = tg.copy()
    got = compute_greedytigs(g, GreedytigConfig(
        k=tk, use_mesh=True, engine="device", device=CPU8, **option,
    ), stats)
    assert stats.stage_times, "the mesh stage must have run"
    for other in (want, host):
        assert np.array_equal(got.flat, other.flat)
        assert np.array_equal(got.offsets, other.offsets)
    ttesting.assert_tigs_spell_kmer_set(g, got, tstore, tk, kmers, allow_duplicates=True)


def test_mesh_greedytigs_at_k131_identical_to_host():
    """k >= 128 on the mesh: unpacked rows and their numpy extraction."""
    case = dict(genome_length=4000, k=131, seed=131, n_sequences=3)
    store, kmers, k = ttesting.make_unitig_store_strings(**case)
    tg = t_build(store, k)
    host = compute_greedytigs(tg.copy(), GreedytigConfig(k=k, engine="host"))
    g = tg.copy()
    got = compute_greedytigs(g, GreedytigConfig(
        k=k, use_mesh=True, engine="device", device=["cpu"] * 3,
    ))
    assert np.array_equal(got.flat, host.flat)
    assert np.array_equal(got.offsets, host.offsets)
    ttesting.assert_tigs_spell_kmer_strings(g, got, store, k, kmers)


def test_use_mesh_choices():
    """"auto" takes the mesh with more than one shard; True even with one;
    False refuses several devices."""
    store, _, k = ttesting.make_unitig_store(genome_length=3000, k=9, seed=0)
    g = t_build(store, k)
    host = compute_greedytigs(g.copy(), GreedytigConfig(k=k, engine="host"))
    for use_mesh, devices in (("auto", ["cpu"] * 2), (True, ["cpu"]), ("auto", "cpu")):
        got = compute_greedytigs(g.copy(), GreedytigConfig(
            k=k, engine="device", use_mesh=use_mesh, device=devices,
        ))
        assert np.array_equal(got.flat, host.flat)
    with pytest.raises(ValueError, match="use_mesh"):
        compute_greedytigs(g.copy(), GreedytigConfig(
            k=k, engine="device", use_mesh=False, device=["cpu"] * 2,
        ))
    with pytest.raises(ValueError, match="use_mesh"):
        compute_greedytigs(g.copy(), GreedytigConfig(k=k, use_mesh="x", device="cpu"))
