"""The optimal front owns its intermediates and frees them.

``algos/matchtigs.py:_collapse_candidates`` empties the candidates'
columns and drops them, with any native triple buffer behind them, once
the expansion has read them; each collapse route drops its expanded rows
as its dedup reads them.  ``_allocate_and_match`` drops its bucketing
scratch and the bucketed edge rows at their last read, and solves the
batch over the dedup's own columns.  Here, on the golden pangenome graph
and on both collapse routes (packed, at 23-bit ids and at 24-bit ids as
past 2^23 ids, and argsort as past 2^26 ids): that nothing of the
candidate set is alive when ``matchtigs.collapse`` closes, the
``released_bytes`` counters of ``collapse.dedup`` and
``match.batch.dedup``, and that the walks and the matching files stay the
JAX package's, with and without components that solve deletion variants
beside the batch."""

import ctypes
import functools
import tempfile
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_matchtigs_large import ARGSORT_IDS, PACKED24_IDS, _force_collapse_ids

from matchtigs_tpu import testing as jtesting
from matchtigs_tpu.algos import matchtigs as j_matchtigs
from matchtigs_tpu.algos.matchtigs import MatchtigConfig as JConfig
from matchtigs_tpu.graph.build import build_bigraph_from_unitigs as j_build
from matchtigs_tpu_torch import native, testing
from matchtigs_tpu_torch.algos import matchtigs as t_matchtigs
from matchtigs_tpu_torch.algos.greedytigs import GreedytigConfig, collect_candidates
from matchtigs_tpu_torch.algos.matchtigs import MatchtigConfig as TConfig
from matchtigs_tpu_torch.graph.build import build_bigraph_from_unitigs as t_build
from matchtigs_tpu_torch.ops import sssp
from matchtigs_tpu_torch.ops.candidates import Candidates
from matchtigs_tpu_torch.ops.matching import unbalanced_nodes
from matchtigs_tpu_torch.utils import tracing

GRAPHS = {
    # tests/test_torch_matchtigs.py's golden pangenome: every candidate
    # component solves in the batch
    "golden-pangenome": ("pangenome", dict(
        genome_length=20000, k=13, n_strains=4, mutation_rate=0.02,
        seed=11, with_repeats=True,
    )),
    # one input component short of two zero-cost absorbers: its candidate
    # component solves deletion variants on the solo path
    "deletion-variants": ("unitig", dict(genome_length=1764, k=7, seed=12)),
}
ROUTES = ("packed", "argsort", "packed24")
# the id count each route is forced with (the packed route: none)
ROUTE_IDS = dict(packed=0, argsort=ARGSORT_IDS, packed24=PACKED24_IDS)
SUFFIXES = (".matching", ".matching.solution")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _stores(name):
    kind, case = GRAPHS[name]
    jmake = jtesting.make_unitig_store if kind == "unitig" else jtesting.make_pangenome_store
    tmake = testing.make_unitig_store if kind == "unitig" else testing.make_pangenome_store
    jstore, _, k = jmake(**case)
    tstore, kmers, tk = tmake(**case)
    assert tk == k
    return jstore, tstore, kmers, k


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """The JAX package's optimal run: its walks and matching files."""
    jstore, _, _, k = _stores(name)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = Path(tmp) / "instance"
        walks = j_matchtigs.compute_matchtigs(j_build(jstore, k), JConfig(
            k=k, engine="host", matching_file_prefix=str(prefix)))
        return walks, tuple(Path(f"{prefix}{s}").read_bytes() for s in SUFFIXES)


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


def _route(monkeypatch, route):
    if route != "packed":
        _force_collapse_ids(monkeypatch, ROUTE_IDS[route])


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("route", ROUTES)
def test_the_candidate_set_is_freed_before_the_components(monkeypatch, native_buffers,
                                                          route, engine):
    """When ``matchtigs.collapse`` closes, before ``matchtigs.components``
    opens: every candidate column and the candidates' object hold nothing,
    and every native triple buffer wrapped so far has been freed; the walks
    are those of the JAX package."""
    want, _ = _jax_run("golden-pangenome")
    _, tstore, _, k = _stores("golden-pangenome")
    _route(monkeypatch, route)
    refs = []
    collect = t_matchtigs.collect_candidates

    def watched_collect(*args, **kwargs):
        cands = collect(*args, **kwargs)
        refs.append(cands)
        refs.extend(weakref.ref(c) for c in (cands.u, cands.v, cands.d))
        return cands

    seen = {}

    def at_close(sp):
        if sp.name == "matchtigs.collapse":
            seen.update(alive=sum(r() is not None for r in refs[1:]),
                        left=len(refs[0]), unfreed=len(live))

    wrapped, live = native_buffers
    monkeypatch.setattr(t_matchtigs, "collect_candidates", watched_collect)
    monkeypatch.setattr(tracing, "sink", at_close)
    got = t_matchtigs.compute_matchtigs(t_build(tstore, k), TConfig(k=k, engine=engine,
                                                                    device="cpu"))
    assert len(refs) == 4 and (wrapped[0] > 0 or engine == "device")
    assert seen == dict(alive=0, left=0, unfreed=0)
    assert np.array_equal(got.flat, want.flat) and np.array_equal(got.offsets, want.offsets)


@pytest.mark.parametrize("route", ROUTES)
def test_a_traced_call_counts_the_released_bytes(monkeypatch, route):
    """``collapse.dedup`` counts at least the candidate columns (24 bytes a
    candidate) and one 8-byte column an expanded row; ``match.batch.dedup``
    the component label (4 bytes) and order (8) of each matching edge, the
    bucketed edge rows (24) and their labels (8)."""
    _, tstore, _, k = _stores("golden-pangenome")
    _route(monkeypatch, route)
    spans = []
    monkeypatch.setattr(tracing, "sink", spans.append)
    t_matchtigs.compute_matchtigs(t_build(tstore, k), TConfig(k=k, engine="host", device="cpu"))
    done = {s.name: s.counters for s in spans}
    n_cand = done["search.host"]["candidates"]
    rows, pairs = done["collapse.expand"]["rows"], done["collapse.dedup"]["pairs"]
    assert n_cand > 0 and rows >= n_cand and pairs > 0
    assert done["collapse.dedup"]["released_bytes"] >= 24 * n_cand + 8 * rows
    assert done["match.batch.dedup"]["released_bytes"] == 44 * pairs


@pytest.mark.parametrize("route", ROUTES)
def test_collapse_empties_the_candidates_it_is_given(route):
    """A direct call: the columns of the candidates passed in are emptied,
    and the five columns equal those of a call on a copy through the JAX
    package's collapse, which keeps its input."""
    jstore, tstore, _, k = _stores("golden-pangenome")
    tg, jg = t_build(tstore, k), j_build(jstore, k)
    out_nodes, in_mask, _ = unbalanced_nodes(tg)
    cands = collect_candidates(tg, out_nodes, in_mask, k, GreedytigConfig(k=k, engine="host"))
    copy = Candidates(cands.u.copy(), cands.v.copy(), cands.d.copy())
    ids_start, ids_count, n_ids, _, _ = t_matchtigs._matching_node_ids(tg, tg.imbalances())
    want = j_matchtigs._collapse_candidates(jg, copy, ids_start, ids_count, n_ids)
    n_ids_route = max(n_ids, ROUTE_IDS[route])
    got = t_matchtigs._collapse_candidates(tg, cands, ids_start, ids_count, n_ids_route)
    assert len(cands) == 0 and len(cands.v) == 0 and len(cands.d) == 0 and len(copy) > 0
    for g_col, w_col in zip(got, want):
        assert np.array_equal(g_col, w_col)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_walks_and_matching_files_identical_to_jax(monkeypatch, tmp_path, name, route):
    """The walks and both matching files, byte for byte, on a graph whose
    components all solve in the batch and on one with deletion variants."""
    want, want_files = _jax_run(name)
    _, tstore, kmers, k = _stores(name)
    _route(monkeypatch, route)
    spans = []
    monkeypatch.setattr(tracing, "sink", spans.append)
    prefix = tmp_path / "instance"
    tg = t_build(tstore, k)
    got = t_matchtigs.compute_matchtigs(tg, TConfig(
        k=k, device="cpu", matching_file_prefix=str(prefix)))
    solo = sum(s.counters.get("components", 0) for s in spans if s.name == "match.solo")
    assert solo == (name == "deletion-variants")
    assert np.array_equal(got.flat, want.flat) and np.array_equal(got.offsets, want.offsets)
    for suffix, w_bytes in zip(SUFFIXES, want_files):
        assert Path(f"{prefix}{suffix}").read_bytes() == w_bytes and w_bytes
    testing.assert_tigs_spell_kmer_set(tg, got, tstore, k, kmers, allow_duplicates=True)


def _instance(seed, n_wcc=12, k=15):
    """A collapsed matching instance over ``n_wcc`` input components:
    unique id pairs ascending by pair key, weights below k.  Every third
    component is one even candidate component with no id left out, so it
    lacks the two zero-cost absorbers and solves deletion variants; the
    others leave ids without an edge, and solve in the batch."""
    rng = np.random.default_rng(seed)
    pairs, id_comp, start = [], [], 0
    for w in range(n_wcc):
        n = 2 * int(rng.integers(2, 9))
        ids = np.arange(start, start + n)
        if w % 3 == 0:  # a path through every id, plus chords
            edges = list(zip(ids[:-1], ids[1:]))
            edges += [tuple(rng.choice(ids, 2, replace=False)) for _ in range(n // 2)]
        else:  # the first two ids stay single
            edges = [tuple(rng.choice(ids[2:], 2, replace=False)) for _ in range(n)]
        pairs += [(min(a, b), max(a, b)) for a, b in edges]
        id_comp += [w] * n
        start += n
    keys = np.unique(np.array([a * start + b for a, b in pairs], dtype=np.int64))
    ka, kb = keys // start, keys % start
    kw = rng.integers(1, k, len(ka)).astype(np.int64)
    return ka, kb, kw, start, np.array(id_comp, dtype=np.int64), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solo_components_beside_the_batch_match_jax(monkeypatch, seed):
    """Deletion variants solving on the solo path while the batch frees the
    bucketed edge rows: the matched pairs are the JAX package's, and both
    paths ran."""
    ka, kb, kw, n_ids, id_comp, k = _instance(seed)
    want = j_matchtigs._allocate_and_match(ka, kb, kw, n_ids, id_comp, k)
    spans = []
    monkeypatch.setattr(tracing, "sink", spans.append)
    got = t_matchtigs._allocate_and_match(ka, kb, kw, n_ids, id_comp, k)
    done = {s.name: s.counters for s in spans}
    assert done["match.solo"]["components"] > 0 and done["match.batch"]["components"] > 0
    assert done["match.batch.dedup"]["released_bytes"] == 44 * len(ka)
    assert np.array_equal(got, want) and len(got) > 0
