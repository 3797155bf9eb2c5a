"""Greedy acceptance owns its candidate chunks and frees them.

``ops/matching.py:greedy_accept`` takes a list of candidate chunks, packs
them into one acceptance key array largest chunk first, releasing each
chunk as soon as its keys are written, sorts and scans the keys, and
leaves the list empty; nothing candidate-sized outlives the call.  Here:
the accepted triples and the mutated multiplicities against the JAX
package's python scan, its acceptance and the port's own acceptance of
the concatenated columns; that every column, and every native triple
buffer, is freed by the time acceptance returns inside
``compute_greedytigs``; and the ``released_bytes`` counter of the
``join.accept`` span."""

import ctypes
import weakref

import numpy as np
import pytest
import torch

import matchtigs_tpu.ops.matching as JM
from matchtigs_tpu.graph.bigraph import Bigraph as JBigraph
from matchtigs_tpu.ops.candidates import Candidates as JCandidates
from matchtigs_tpu_torch import native, testing
from matchtigs_tpu_torch.algos import greedytigs as G
from matchtigs_tpu_torch.graph.bigraph import Bigraph
from matchtigs_tpu_torch.graph.build import build_bigraph_from_unitigs
from matchtigs_tpu_torch.ops import sssp
from matchtigs_tpu_torch.ops.candidates import Candidates
from matchtigs_tpu_torch.ops.device_graph import build_device_graph
from matchtigs_tpu_torch.ops.matching import greedy_accept, unbalanced_nodes
from matchtigs_tpu_torch.utils import tracing


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _multiplicities(rng, n, n_self):
    """Signed imbalances under the production invariant: m[mirror[x]] ==
    -m[x], self-mirror multiplicities in [0, 1]."""
    m = np.empty(n, dtype=np.int64)
    half = rng.integers(-2, 3, n // 2)
    m[0::2] = half
    m[1::2] = -half
    m[n - n_self:] = rng.integers(0, 2, n_self)
    return m


def _random_case(seed, sizes, d_hi=31, n=20_000, n_self=400):
    """A graph of ``n`` nodes (mirror pairs, then ``n_self`` self-mirrors),
    its multiplicities and random candidate chunks of ``sizes`` rows."""
    rng = np.random.default_rng(seed)
    mirror = np.arange(n, dtype=np.int32).reshape(-1, 2)[:, ::-1].reshape(-1)
    mirror[n - n_self:] = np.arange(n - n_self, n)
    m0 = _multiplicities(rng, n, n_self)
    cols = [
        (rng.integers(0, n, s), rng.integers(0, n, s), rng.integers(1, d_hi, s))
        for s in sizes
    ]
    return Bigraph(n, mirror.copy()), mirror, m0, cols


def _sorted_triples(chunks):
    t = Candidates.concat(chunks).to_triples()
    return t[np.lexsort((t[:, 1], t[:, 0], t[:, 2]))]


def _accept_traced(g, chunks, m):
    with tracing.span("join.accept", timed=True) as sp:
        accepted = greedy_accept(g, chunks, m, sp)
    return accepted, sp.counters["released_bytes"]


def _triple_buffer(col):
    """A chunk laid out as a native triple buffer is (ops/sssp.py:
    _wrap_native_triples): u, v and d consecutive in one array of 3m + 1."""
    m = len(col[0])
    flat = np.empty(3 * m + 1, dtype=np.int64)
    for i, x in enumerate(col):
        flat[i * m : (i + 1) * m] = x
    return Candidates(flat[0:m], flat[m : 2 * m], flat[2 * m : 3 * m])


# name: (chunk sizes, distances below, chunk layout); the keys go into the
# largest chunk's triple buffer where it holds them all, else a new array
RANDOM_CASES = {
    "none": ([], 31, "columns"),
    "empty-chunks": ([0, 300, 0, 50, 0], 31, "columns"),
    "one-chunk": ([2000], 31, "columns"),
    "one-row-chunks": ([1, 1, 1], 31, "columns"),
    "several": ([1500, 1, 700, 2500], 31, "columns"),
    "distance-127": ([1200, 800], 128, "columns"),
    "past-2^20": ([700_000, 400_000], 31, "columns"),
    "triple-buffer": ([1000, 3000, 0, 500], 31, "triple"),
    "triple-buffer-one-row": ([1], 31, "triple"),
    "triple-buffer-too-small": ([1000, 1000, 1000, 2], 31, "triple"),
    "triple-buffer-past-2^20": ([300_000, 900_000], 31, "triple"),
}


def _released(sizes, layout):
    """Columns (24 B a candidate), a key array of its own (8 B) unless the
    largest triple buffer holds the keys, the radix scratch (8 B) from
    2^20 keys."""
    n = sum(sizes)
    own_key = layout == "columns" or n > 3 * max(sizes, default=0) + 1
    return 24 * n + 8 * n * own_key + 8 * n * (n >= 1 << 20)


@pytest.mark.parametrize("name", list(RANDOM_CASES))
def test_releasing_acceptance_matches_the_oracles(name):
    sizes, d_hi, layout = RANDOM_CASES[name]
    g, mirror, m0, cols = _random_case(len(name), sizes, d_hi)
    make = _triple_buffer if layout == "triple" else (lambda col: Candidates(*(c.copy() for c in col)))
    chunks = [make(col) for col in cols]
    want_py = JM.greedy_accept_scan_py(g, _sorted_triples(chunks), m_py := m0.copy())
    cat = Candidates.concat([Candidates(*(c.copy() for c in col)) for col in cols])
    want_cat = greedy_accept(g, cat, m_cat := m0.copy())
    got, released = _accept_traced(g, chunks, m := m0.copy())
    assert chunks == []
    assert np.array_equal(got, want_py) and np.array_equal(m, m_py)
    assert np.array_equal(got, want_cat) and np.array_equal(m, m_cat)
    assert released == (0 if not sizes else _released(sizes, layout))


def test_releasing_acceptance_past_2_22_matches_the_jax_package():
    """Past 2^22 candidates, where the JAX package runs its fused native
    pack, sort and scan over process-lifetime scratch: the same triples
    and multiplicities, and the python oracle's."""
    sizes = [2_500_000, 0, 1_800_000, 3]
    g, mirror, m0, cols = _random_case(22, sizes, n=100_000, n_self=2000)
    chunks = [Candidates(*(c.copy() for c in col)) for col in cols]
    want_py = JM.greedy_accept_scan_py(g, _sorted_triples(chunks), m_py := m0.copy())
    jchunks = [JCandidates(*(c.copy() for c in col)) for col in cols]
    want_jax = JM.greedy_accept(JBigraph(len(mirror), mirror.copy()), jchunks, m_jax := m0.copy())
    got, released = _accept_traced(g, chunks, m := m0.copy())
    assert chunks == [] and len(got) > 0
    assert np.array_equal(got, want_jax) and np.array_equal(m, m_jax)
    assert np.array_equal(got, want_py) and np.array_equal(m, m_py)
    assert released == 40 * sum(sizes)


@pytest.mark.parametrize("sizes", [[3000], [900, 0, 2100]], ids=["one", "chunks"])
def test_distances_past_the_packed_key_take_the_unpacked_route(sizes):
    """A distance >= 128 does not fit the key's 7 bits: the lexsort route,
    the same triples as the oracle, nothing counted as released."""
    g, mirror, m0, cols = _random_case(7, sizes, d_hi=200)
    assert max(int(c[2].max(initial=0)) for c in cols) >= 128
    chunks = [Candidates(*(c.copy() for c in col)) for col in cols]
    want = JM.greedy_accept_scan_py(g, _sorted_triples(chunks), m_py := m0.copy())
    got, released = _accept_traced(g, chunks, m := m0.copy())
    assert chunks == [] and len(got) > 0
    assert np.array_equal(got, want) and np.array_equal(m, m_py)
    assert released == 0


def test_multiplicities_off_the_invariant_still_match_the_oracle():
    """Accepts are bounded by the total out-deficit only under the mirror
    invariant; off it the scan reruns with room for every candidate."""
    g, mirror, _, cols = _random_case(5, [4000, 3000])
    m0 = np.random.default_rng(5).integers(-3, 4, len(mirror)).astype(np.int64)
    chunks = [Candidates(*(c.copy() for c in col)) for col in cols]
    want = JM.greedy_accept_scan_py(g, _sorted_triples(chunks), m_py := m0.copy())
    got = greedy_accept(g, chunks, m := m0.copy())
    assert np.array_equal(got, want) and np.array_equal(m, m_py)


@pytest.fixture(scope="module")
def pangenome():
    store, _, k = testing.make_pangenome_store(
        genome_length=40_000, k=31, n_strains=4, seed=3, with_repeats=True)
    return build_bigraph_from_unitigs(store, k), k


@pytest.fixture
def native_buffers(monkeypatch):
    """The native triple buffers wrapped so far (a count) and the
    addresses of those not yet freed by the finalizer of
    ``ops/sssp.py:_wrap_native_triples``."""
    lib = native.load()
    wrapped, live = [0], set()
    free = lib.free_i64_buffer
    wrap = sssp._wrap_native_triples

    def counted_free(ptr):
        live.discard(ctypes.cast(ptr, ctypes.c_void_p).value)
        free(ptr)

    def counted_wrap(lib_, buf_ptr, n):
        if n > 0:
            wrapped[0] += 1
            live.add(ctypes.cast(buf_ptr, ctypes.c_void_p).value)
        return wrap(lib_, buf_ptr, n)

    monkeypatch.setattr(lib, "free_i64_buffer", counted_free)
    monkeypatch.setattr(sssp, "_wrap_native_triples", counted_wrap)
    return wrapped, live


def test_native_chunks_from_the_host_dijkstra_match_the_oracle(pangenome, native_buffers):
    """Chunks that are views of native buffers (the host Dijkstra's): the
    oracle's triples, and every buffer freed by the time acceptance
    returns."""
    g, k = pangenome
    out_nodes, in_mask, m0 = unbalanced_nodes(g)
    dg = build_device_graph(g, k - 1)
    half = len(out_nodes) // 2

    def make():
        return [sssp.host_dijkstra_candidates(dg, s, k - 1, in_mask, n_threads=2)
                for s in (out_nodes[:half], out_nodes[half:])]

    triples = _sorted_triples(make())
    want = JM.greedy_accept_scan_py(g, triples, m_py := m0.copy())
    wrapped, live = native_buffers
    chunks = make()
    assert len(live) == 2
    got, released = _accept_traced(g, chunks, m := m0.copy())
    assert chunks == [] and not live
    assert len(got) > 0 and np.array_equal(got, want) and np.array_equal(m, m_py)
    assert released == _released([len(c) for c in make()], "triple")


OWNERSHIP_CASES = {
    "device": dict(engine="device"),
    "host": dict(engine="host"),
    "device-unpacked-rows": dict(engine="device"),
    "performance-counters": dict(engine="device", performance_counters=True),
}


@pytest.mark.parametrize("name", list(OWNERSHIP_CASES))
def test_compute_greedytigs_frees_the_candidates_in_acceptance(pangenome, native_buffers,
                                                               monkeypatch, name):
    """Inside compute_greedytigs: when acceptance returns, the chunk list
    is empty, every chunk and column is gone and every native triple
    buffer has been freed; the tigs are those of an untouched call."""
    g, k = pangenome
    config = G.GreedytigConfig(k=k, device="cpu", **OWNERSHIP_CASES[name])
    want = G.compute_greedytigs(g.copy(), config)
    if name == "device-unpacked-rows":  # the numpy extraction's chunks
        monkeypatch.setattr(sssp, "_can_pack_out", lambda *a: False)
    seen = {}
    accept = G.greedy_accept

    def watched_accept(g_, chunks, m, sp):
        refs = [weakref.ref(x) for c in chunks for x in (c, c.u, c.v, c.d)]
        accepted = accept(g_, chunks, m, sp)
        seen.update(refs=len(refs), left=len(chunks), unfreed=len(live),
                    alive=sum(r() is not None for r in refs))
        return accepted

    wrapped, live = native_buffers
    monkeypatch.setattr(G, "greedy_accept", watched_accept)
    got = G.compute_greedytigs(g.copy(), config)
    assert seen["refs"] and (wrapped[0] > 0 or name == "device-unpacked-rows")
    assert (seen["left"], seen["alive"], seen["unfreed"]) == (0, 0, 0)
    assert np.array_equal(got.flat, want.flat) and np.array_equal(got.offsets, want.offsets)


@pytest.mark.parametrize("engine", ["device", "host"])
def test_a_traced_greedy_call_counts_the_released_bytes(pangenome, monkeypatch, engine):
    """``join.accept``'s ``released_bytes`` in a traced call, whose chunks
    are all native triple buffers: 24 bytes of columns a candidate, and 8
    of key unless the largest buffer holds every key."""
    g, k = pangenome
    spans, sizes = [], []
    accept = G.greedy_accept

    def sized_accept(g_, chunks, m, sp):
        sizes.extend(len(c) for c in chunks)
        return accept(g_, chunks, m, sp)

    monkeypatch.setattr(G, "greedy_accept", sized_accept)
    monkeypatch.setattr(tracing, "sink", spans.append)
    stats = G.SearchStats()
    G.compute_greedytigs(g.copy(), G.GreedytigConfig(k=k, engine=engine, device="cpu"), stats)
    done = [s for s in spans if s.name == "join.accept"]
    assert len(done) == 1 and sum(sizes) == stats.candidates > 0
    assert done[0].counters["released_bytes"] == _released(sizes, "triple")
