"""The port's optimal matchtigs against the JAX package's: identical tig
walks (``Walks.flat`` / ``offsets``) from the port's device engine (here
the kernels' plain torch versions) and its host engine, identical matching
files, and identical candidate collapses.  All comparisons are exact."""

import numpy as np
import pytest
import torch

from matchtigs_tpu import testing as jtesting
from matchtigs_tpu.algos import matchtigs as j_matchtigs
from matchtigs_tpu.algos.matchtigs import MatchtigConfig as JConfig
from matchtigs_tpu.graph.build import build_bigraph_from_unitigs as j_build
from matchtigs_tpu_torch import testing as ttesting
from matchtigs_tpu_torch.algos import matchtigs as t_matchtigs
from matchtigs_tpu_torch.algos.greedytigs import GreedytigConfig, collect_candidates
from matchtigs_tpu_torch.algos.matchtigs import MatchtigConfig as TConfig
from matchtigs_tpu_torch.graph.build import build_bigraph_from_unitigs as t_build
from matchtigs_tpu_torch.ops.candidates import Candidates
from matchtigs_tpu_torch.ops.matching import unbalanced_nodes

# tests/test_matchtigs.py's CASES, then the golden pangenome graph of
# tests/test_torch_greedytigs.py.
GRAPHS = {
    "k9": ("unitig", dict(genome_length=3000, k=9, seed=0)),
    "k11": ("unitig", dict(genome_length=8000, k=11, seed=1)),
    "k7": ("unitig", dict(genome_length=2500, k=7, seed=2)),
    "k13-two-seqs": ("unitig", dict(genome_length=5000, k=13, seed=3, n_sequences=2)),
    "golden-pangenome": ("pangenome", dict(
        genome_length=20000, k=13, n_strains=4, mutation_rate=0.02,
        seed=11, with_repeats=True,
    )),
}


def _graphs(name):
    """(JAX graph, port graph, port store, k-mers, k) of one named graph."""
    kind, case = GRAPHS[name]
    jmake = jtesting.make_unitig_store if kind == "unitig" else jtesting.make_pangenome_store
    tmake = ttesting.make_unitig_store if kind == "unitig" else ttesting.make_pangenome_store
    jstore, _, k = jmake(**case)
    tstore, kmers, tk = tmake(**case)
    assert tk == k
    return j_build(jstore, k), t_build(tstore, k), tstore, kmers, k


@pytest.mark.parametrize("name", list(GRAPHS))
def test_matchtigs_identical_to_jax(name):
    jg, tg, tstore, kmers, k = _graphs(name)
    want = j_matchtigs.compute_matchtigs(jg, JConfig(k=k, engine="host"))
    for engine in ("device", "host"):
        g = tg.copy()
        got = t_matchtigs.compute_matchtigs(g, TConfig(k=k, engine=engine, device="cpu"))
        assert np.array_equal(got.flat, want.flat), engine
        assert np.array_equal(got.offsets, want.offsets), engine
        ttesting.assert_tigs_spell_kmer_set(g, got, tstore, k, kmers, allow_duplicates=True)


@pytest.mark.parametrize("name", ["k9", "golden-pangenome"])
def test_matching_files_byte_identical_to_jax(name, tmp_path):
    jg, tg, _, _, k = _graphs(name)
    j_matchtigs.compute_matchtigs(
        jg, JConfig(k=k, engine="host", matching_file_prefix=str(tmp_path / "jax")))
    t_matchtigs.compute_matchtigs(tg, TConfig(
        k=k, device="cpu", matching_file_prefix=str(tmp_path / "torch")))
    for suffix in (".matching", ".matching.solution"):
        want = (tmp_path / f"jax{suffix}").read_bytes()
        assert (tmp_path / f"torch{suffix}").read_bytes() == want and want


@pytest.mark.parametrize("dense_limit", [8, 2000])
def test_dense_limit_identical_to_jax(dense_limit):
    """Components up to dense_limit ids go through the dense blossom."""
    jg, tg, _, _, k = _graphs("golden-pangenome")
    want = j_matchtigs.compute_matchtigs(
        jg, JConfig(k=k, engine="host", dense_limit=dense_limit))
    got = t_matchtigs.compute_matchtigs(
        tg, TConfig(k=k, device="cpu", dense_limit=dense_limit))
    assert np.array_equal(got.flat, want.flat)
    assert np.array_equal(got.offsets, want.offsets)


@pytest.mark.parametrize(
    "path", ["packed", "packed-numpy", "argsort", "packed24", "packed24-numpy"])
@pytest.mark.parametrize("name", ["k7", "golden-pangenome"])
def test_collapse_candidates_identical_to_jax(monkeypatch, name, path):
    """_collapse_candidates on the same candidates: the packed value-sort
    path (native, and its numpy packing), also at 24-bit ids (the id count
    given as 2^23 + 1), and the argsort path (taken past 2^26 ids), all
    against the JAX package's packed path at the true id count: its own
    argsort path keeps the first minimum-weight row in candidate order
    (F7), which the port repairs."""
    jg, tg, _, _, k = _graphs(name)
    out_nodes, in_mask, _ = unbalanced_nodes(tg)
    cands = collect_candidates(tg, out_nodes, in_mask, k, GreedytigConfig(k=k, engine="host"))
    ids_start, ids_count, n_ids, _, _ = t_matchtigs._matching_node_ids(tg, tg.imbalances())
    assert n_ids and len(cands)
    if path.endswith("-numpy"):
        for mod in (j_matchtigs, t_matchtigs):
            monkeypatch.setattr(mod, "_expand_pack_native", lambda *a: None)
            monkeypatch.setattr(mod, "_dedup_resolve_native", lambda *a: None)
            monkeypatch.setattr(mod, "_dedup_unpack_native", lambda *a: None)
    want = j_matchtigs._collapse_candidates(jg, cands, ids_start, ids_count, n_ids)
    if path == "argsort":
        n_ids = (1 << 26) + 1
    elif path.startswith("packed24"):
        n_ids = (1 << 23) + 1
    # the port's collapse empties the candidates it is given: it gets a copy
    copy = Candidates(cands.u.copy(), cands.v.copy(), cands.d.copy())
    got = t_matchtigs._collapse_candidates(tg, copy, ids_start, ids_count, n_ids)
    assert len(got[0]) > 0
    for g_col, w_col in zip(got, want):
        assert np.array_equal(g_col, w_col)


def test_auto_engine_without_cuda_raises(monkeypatch):
    """MatchtigConfig's defaults (engine "auto", device "cuda") run the
    device stage, never the host search for want of a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tg, _, _, k = _graphs("k9")
    assert (TConfig(k=k).engine, TConfig(k=k).device) == ("auto", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_matchtigs.compute_matchtigs(tg.copy(), TConfig(k=k))
    want = t_matchtigs.compute_matchtigs(tg.copy(), TConfig(k=k, engine="host"))
    got = t_matchtigs.compute_matchtigs(tg.copy(), TConfig(k=k, device="cpu"))
    assert np.array_equal(got.flat, want.flat)
