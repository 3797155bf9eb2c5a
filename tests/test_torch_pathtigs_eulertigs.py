"""The port's pathtigs and eulertigs against the JAX package's: identical
tig walks (``Walks.flat`` / ``offsets``) on tests/test_pathtigs_eulertigs.py's
CASES and the golden pangenome graph.  Both are host-only in both packages."""

import numpy as np
import pytest

from matchtigs_tpu import testing as jtesting
from matchtigs_tpu.algos.eulertigs import EulertigConfig as JEConfig
from matchtigs_tpu.algos.eulertigs import compute_eulertigs as j_euler
from matchtigs_tpu.algos.pathtigs import compute_pathtigs as j_path
from matchtigs_tpu.algos.pathtigs import compute_pathtigs_py as j_path_py
from matchtigs_tpu.graph.build import build_bigraph_from_unitigs as j_build
from matchtigs_tpu_torch import testing as ttesting
from matchtigs_tpu_torch.algos.eulertigs import EulertigConfig as TEConfig
from matchtigs_tpu_torch.algos.eulertigs import compute_eulertigs as t_euler
from matchtigs_tpu_torch.algos.pathtigs import compute_pathtigs as t_path
from matchtigs_tpu_torch.graph.build import build_bigraph_from_unitigs as t_build

GRAPHS = {
    "k11": ("unitig", dict(genome_length=2000, k=11, seed=0)),
    "k15": ("unitig", dict(genome_length=8000, k=15, seed=1)),
    "k9": ("unitig", dict(genome_length=5000, k=9, seed=2)),
    "k7": ("unitig", dict(genome_length=3000, k=7, seed=3)),
    "k13-three-seqs": ("unitig", dict(genome_length=4000, k=13, seed=4, n_sequences=3)),
    "golden-pangenome": ("pangenome", dict(
        genome_length=20000, k=13, n_strains=4, mutation_rate=0.02,
        seed=11, with_repeats=True,
    )),
}


def _graphs(name):
    kind, case = GRAPHS[name]
    jmake = jtesting.make_unitig_store if kind == "unitig" else jtesting.make_pangenome_store
    tmake = ttesting.make_unitig_store if kind == "unitig" else ttesting.make_pangenome_store
    jstore, _, k = jmake(**case)
    tstore, kmers, _ = tmake(**case)
    return j_build(jstore, k), t_build(tstore, k), tstore, kmers, k


@pytest.mark.parametrize("name", list(GRAPHS))
def test_pathtigs_identical_to_jax(name):
    jg, tg, tstore, kmers, k = _graphs(name)
    want = j_path(jg)
    got = t_path(tg)
    assert np.array_equal(got.flat, want.flat)
    assert np.array_equal(got.offsets, want.offsets)
    ttesting.assert_tigs_spell_kmer_set(tg, got, tstore, k, kmers, allow_duplicates=False)
    # the JAX package's python cover, walk for walk
    want_py = j_path_py(jg)
    assert len(got) == len(want_py)
    assert all(np.array_equal(got[i], w) for i, w in enumerate(want_py))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_eulertigs_identical_to_jax(name):
    jg, tg, tstore, kmers, k = _graphs(name)
    want = j_euler(jg, JEConfig(k=k))
    got = t_euler(tg, TEConfig(k=k))
    assert np.array_equal(got.flat, want.flat)
    assert np.array_equal(got.offsets, want.offsets)
    ttesting.assert_tigs_spell_kmer_set(tg, got, tstore, k, kmers, allow_duplicates=False)
