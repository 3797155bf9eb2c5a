"""Optimal matchtigs where the instance passes the widths of its small
layouts, at small sizes.

Past 2^23 matching ids the candidate collapse packs its rows with wider
ids (24 to 26 bits), and past 2^26 ids it leaves the packed value sort
for the argsort route; past 2^24 nodes the search stage leaves the packed
rows and adjacency for the wide kernel over the unpacked ``(nbr, nw)``
pair.  Here all are forced on small graphs: the collapse's routes by
raising the id count it is given (which leaves the pair keys' order
unchanged), to 2^23 + 1 (24-bit ids) or 2^26 + 1 (the argsort route), the
layouts by the predicates of ``tests/test_torch_large_graph.py``.  Both
routes keep, per id pair, the row of the packed route at 23-bit ids
whatever the candidates' order, so the device and host engines spell the
same matchtigs there, and they are the JAX package's (its packed route at
the true id count).  All
comparisons are exact; the device engine runs the kernels' plain versions
(``device="cpu"``)."""

import functools
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_large_graph import _count_calls, _force_node_count_layout

from matchtigs_tpu import testing as jtesting
from matchtigs_tpu.algos import matchtigs as j_matchtigs
from matchtigs_tpu.algos.matchtigs import MatchtigConfig as JConfig
from matchtigs_tpu.graph.build import build_bigraph_from_unitigs as j_build
from matchtigs_tpu_torch import testing as ttesting
from matchtigs_tpu_torch.algos import matchtigs as t_matchtigs
from matchtigs_tpu_torch.algos.greedytigs import GreedytigConfig, collect_candidates
from matchtigs_tpu_torch.algos.matchtigs import MatchtigConfig as TConfig
from matchtigs_tpu_torch.graph.build import build_bigraph_from_unitigs as t_build
from matchtigs_tpu_torch.ops import sssp as tsssp
from matchtigs_tpu_torch.ops.candidates import Candidates
from matchtigs_tpu_torch.ops.matching import unbalanced_nodes

# the first id count whose collapse takes the argsort route: its ids need
# 27 bits, and a packed row of 2 * 27 + 10 bits does not fit an int64
ARGSORT_IDS = (1 << 26) + 1
# the first id count whose packed rows need 24-bit ids (ids 0 .. 2^23 - 1
# fit 23 bits)
PACKED24_IDS = (1 << 23) + 1
GRAPHS = {
    "k7": ("unitig", dict(genome_length=2500, k=7, seed=2)),
    "k11": ("unitig", dict(genome_length=8000, k=11, seed=1)),
    "golden-pangenome": ("pangenome", dict(
        genome_length=20000, k=13, n_strains=4, mutation_rate=0.02,
        seed=11, with_repeats=True,
    )),
    # the flagship's pangenome (7 strains, 1% mutations, repeats, k=31,
    # seed 0) cut to 30 kbp
    "pangenome-k31": ("pangenome", dict(
        genome_length=30_000, k=31, n_strains=7, mutation_rate=0.01, seed=0,
        with_repeats=True,
    )),
}
ORDERS = ("host", "device", "permuted-0", "permuted-1")
SUFFIXES = (".matching", ".matching.solution")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Under several xdist workers torch's thread pool makes each small op
    wait on busy cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _stores(name):
    """(JAX store, port store, k-mers, k) of one named graph."""
    kind, case = GRAPHS[name]
    jmake = jtesting.make_unitig_store if kind == "unitig" else jtesting.make_pangenome_store
    tmake = ttesting.make_unitig_store if kind == "unitig" else ttesting.make_pangenome_store
    jstore, _, k = jmake(**case)
    tstore, kmers, tk = tmake(**case)
    assert tk == k
    return jstore, tstore, kmers, k


def _graphs(name):
    """Fresh (JAX graph, port graph) of one named graph, and its port
    store, k-mers and k."""
    jstore, tstore, kmers, k = _stores(name)
    return j_build(jstore, k), t_build(tstore, k), tstore, kmers, k


@functools.lru_cache(maxsize=None)
def _candidates(name, engine):
    """The candidates of the optimal front on one graph, in the order the
    engine lists them: source order on the host, by producer on the device
    (device rows, host-routed sources, overflow tail)."""
    _, tg, _, _, k = _graphs(name)
    out_nodes, in_mask, _ = unbalanced_nodes(tg)
    return collect_candidates(tg, out_nodes, in_mask, k,
                              GreedytigConfig(k=k, engine=engine, device="cpu"))


def _in_order(name, order):
    """The graph's candidates in the named order: an engine's, or a
    seeded permutation of the host engine's."""
    if order in ("host", "device"):
        return _candidates(name, order)
    cands = _candidates(name, "host")
    perm = np.random.default_rng(int(order[-1])).permutation(len(cands))
    return Candidates(cands.u[perm], cands.v[perm], cands.d[perm])


@pytest.mark.parametrize("weight_shift", [0, 128])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_argsort_collapse_equals_jax_packed(name, order, weight_shift):
    """The port's argsort route on candidates in any order: the five
    columns of the JAX package's packed route at the true id count.  With
    every weight raised by 128 (as past k = 128) the argsort route is
    taken at any id count, and only the weights move."""
    _collapse_equals_jax_packed(name, order, weight_shift, ARGSORT_IDS)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_packed24_collapse_equals_jax_packed(name, order):
    """The port's packed route at 24-bit ids on candidates in any order:
    the five columns of the JAX package's packed route at the true id
    count."""
    _collapse_equals_jax_packed(name, order, 0, PACKED24_IDS)


def _collapse_equals_jax_packed(name, order, weight_shift, n_ids_given):
    jg, tg, _, _, _ = _graphs(name)
    ids_start, ids_count, n_ids, _, _ = t_matchtigs._matching_node_ids(tg, tg.imbalances())
    assert 0 < n_ids < PACKED24_IDS
    host = _candidates(name, "host")
    cands = _in_order(name, order)
    # the same candidate set, in another order unless listed by the host
    assert sorted(zip(cands.u, cands.v, cands.d)) == sorted(zip(host.u, host.v, host.d))
    want = list(j_matchtigs._collapse_candidates(jg, host, ids_start, ids_count, n_ids))
    want[2] = want[2] + weight_shift
    # the port's collapse empties the candidates it is given: it gets a copy
    cands = Candidates(cands.u.copy(), cands.v.copy(), cands.d + weight_shift)
    got = t_matchtigs._collapse_candidates(tg, cands, ids_start, ids_count, n_ids_given)
    assert len(got[0]) > 0
    for column, g_col, w_col in zip(("lo", "hi", "w", "u", "v"), got, want):
        assert np.array_equal(g_col, w_col), column


def _force_collapse_ids(monkeypatch, at_least):
    """The port's collapse as an instance of ``at_least`` ids takes it:
    the argsort route at ``ARGSORT_IDS``, the packed route at 24-bit ids
    at ``PACKED24_IDS``; keys in the order of the true id count."""
    collapse = t_matchtigs._collapse_candidates

    def wider(g, candidates, ids_start, ids_count, n_ids):
        return collapse(g, candidates, ids_start, ids_count, max(n_ids, at_least))
    monkeypatch.setattr(t_matchtigs, "_collapse_candidates", wider)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """The JAX package's default optimal run (packed collapse): its walks
    and the bytes of its matching files."""
    jg, _, _, _, k = _graphs(name)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = Path(tmp) / "instance"
        walks = j_matchtigs.compute_matchtigs(
            jg, JConfig(k=k, engine="host", matching_file_prefix=str(prefix)))
        return walks, tuple(Path(f"{prefix}{suffix}").read_bytes() for suffix in SUFFIXES)


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("name", ["golden-pangenome", "pangenome-k31"])
def test_forced_argsort_engines_identical_to_jax(monkeypatch, tmp_path, name, engine):
    """Optimal matchtigs with the port's collapse on the argsort route:
    the walks and matching files of either engine are the JAX package's
    from its packed route, byte for byte."""
    _engines_identical_to_jax(monkeypatch, tmp_path, name, engine, ARGSORT_IDS)


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("name", ["golden-pangenome", "pangenome-k31"])
def test_forced_packed24_engines_identical_to_jax(monkeypatch, tmp_path, name, engine):
    """The same with the port's collapse on the packed route at 24-bit
    ids."""
    _engines_identical_to_jax(monkeypatch, tmp_path, name, engine, PACKED24_IDS)


def _engines_identical_to_jax(monkeypatch, tmp_path, name, engine, at_least):
    want, want_files = _jax_run(name)
    _force_collapse_ids(monkeypatch, at_least)
    _, tg, tstore, kmers, k = _graphs(name)
    prefix = tmp_path / "instance"
    got = t_matchtigs.compute_matchtigs(tg, TConfig(
        k=k, engine=engine, device="cpu", matching_file_prefix=str(prefix)))
    assert np.array_equal(got.flat, want.flat)
    assert np.array_equal(got.offsets, want.offsets)
    for suffix, w_bytes in zip(SUFFIXES, want_files):
        assert Path(f"{prefix}{suffix}").read_bytes() == w_bytes and w_bytes
    ttesting.assert_tigs_spell_kmer_set(tg, got, tstore, k, kmers, allow_duplicates=True)


@pytest.mark.parametrize("collapse", ["own-route", "argsort", "packed24"])
@pytest.mark.parametrize("layout", ["unpacked", "mixed"])
def test_matchtigs_past_2_24_identical_to_jax(monkeypatch, layout, collapse):
    """Optimal matchtigs on the device engine with the layout of a graph
    past 2^24 nodes (and, as there, the argsort collapse): the wide
    kernel's path and the unpacked extraction, walks equal to the JAX
    package's under the same layout and to the port's own packed run; also
    with the collapse's packed route at 24-bit ids."""
    jg, tg, tstore, kmers, k = _graphs("pangenome-k31")
    packed = t_matchtigs.compute_matchtigs(tg.copy(), TConfig(k=k, engine="device",
                                                              device="cpu"))
    _force_node_count_layout(monkeypatch, layout)
    if collapse != "own-route":
        _force_collapse_ids(monkeypatch, dict(argsort=ARGSORT_IDS, packed24=PACKED24_IDS)[collapse])
    calls = _count_calls(monkeypatch, tsssp, ("pool_sssp", "wide_sssp",
                                              "extract_packed_candidates",
                                              "extract_unpacked_candidates"))
    want = j_matchtigs.compute_matchtigs(jg, JConfig(k=k, engine="device"))
    got = t_matchtigs.compute_matchtigs(tg, TConfig(k=k, engine="device", device="cpu"))
    assert calls == dict(pool_sssp=0, wide_sssp=1, extract_packed_candidates=0,
                         extract_unpacked_candidates=1)
    for walks in (want, packed):
        assert np.array_equal(got.flat, walks.flat)
        assert np.array_equal(got.offsets, walks.offsets)
    ttesting.assert_tigs_spell_kmer_set(tg, got, tstore, k, kmers, allow_duplicates=True)
