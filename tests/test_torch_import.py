"""The port stands alone: it never imports jax or the JAX package, and
it requires its native library, decided by ``native.load`` alone."""

import ast
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from matchtigs_tpu_torch import native, testing
from matchtigs_tpu_torch.algos.pathtigs import compute_pathtigs
from matchtigs_tpu_torch.graph.build import (
    _connected_component_labels,
    build_bigraph_from_unitigs,
)
from matchtigs_tpu_torch.io.writers import spell_walks_flat
from matchtigs_tpu_torch.ops import euler
from matchtigs_tpu_torch.ops.candidates import Candidates
from matchtigs_tpu_torch.ops.device_graph import _fill_padded_adj
from matchtigs_tpu_torch.ops.matching import greedy_accept, unbalanced_nodes
from matchtigs_tpu_torch.ops.perfect_matching import max_weight_matching_sparse

PKG = Path(__file__).resolve().parent.parent / "matchtigs_tpu_torch"

_HOST_RUN = """
import sys
import numpy as np
import matchtigs_tpu_torch as mt
from matchtigs_tpu_torch import testing
store, kmers, k = testing.make_unitig_store(genome_length=3000, k=9, seed=0)
g = mt.build_bigraph_from_unitigs(store, k)
tigs = mt.compute_greedytigs(g, mt.GreedytigConfig(k=k, engine="host"))
testing.assert_tigs_spell_kmer_set(g, tigs, store, k, kmers, allow_duplicates=True)
g = mt.build_bigraph_from_unitigs(store, k)
tigs = mt.compute_matchtigs(g, mt.MatchtigConfig(k=k, engine="host"))
testing.assert_tigs_spell_kmer_set(g, tigs, store, k, kmers, allow_duplicates=True)
g = mt.build_bigraph_from_unitigs(store, k)
testing.assert_tigs_spell_kmer_set(g, mt.compute_pathtigs(g), store, k, kmers, allow_duplicates=False)
tigs = mt.compute_eulertigs(g, mt.EulertigConfig(k=k))
testing.assert_tigs_spell_kmer_set(g, tigs, store, k, kmers, allow_duplicates=False)
b = mt.TigGraphBuilder(len(store))
for row in zip(*(c.tolist() for c in testing.capi_merges(g))):
    b.merge_nodes(*row)
b.build_graph(store.lengths + 1 - k)
assert b.compute_tigs(5, k, engine="host")[2][-1] > 0
import tempfile
from pathlib import Path
from matchtigs_tpu_torch.io.readers import read_bcalm2, read_gfa
g = mt.build_bigraph_from_unitigs(store, k)
links = testing.graph_links(g)
with tempfile.TemporaryDirectory() as tmp:
    testing.write_bcalm2(Path(tmp) / "u.bcalm.fa", store, links)
    testing.write_gfa(Path(tmp) / "u.gfa.gz", store, links, k)
    s2, l2 = read_bcalm2(Path(tmp) / "u.bcalm.fa")
    assert len(read_gfa(Path(tmp) / "u.gfa.gz")[1].links) == len(l2) == len(links)
assert testing.same_graph_up_to_node_ids(g, mt.build_bigraph_from_links(s2, l2, k))
import matchtigs_tpu_torch.cli
import matchtigs_tpu_torch.ops.perfect_matching
from matchtigs_tpu_torch.utils import malloc_tuning
assert malloc_tuning.tune_malloc() and malloc_tuning.prewarm_heap(1 << 20) in (True, False)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "matchtigs_tpu"))
print("LEAKED", bad)
assert not bad, bad
"""


def test_host_greedy_run_imports_no_jax():
    """Every front on the host engine, the C ABI's TigGraphBuilder, the
    CLI, and the link inputs written by ``testing`` and read back."""
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    proc = subprocess.run(
        [sys.executable, "-c", _HOST_RUN],
        cwd=PKG.parent, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "LEAKED []" in proc.stdout


_MESH_RUN = """
import sys
import numpy as np
import matchtigs_tpu_torch as mt
from matchtigs_tpu_torch import testing
from matchtigs_tpu_torch.ops import mesh_sort
from matchtigs_tpu_torch.parallel import mesh
store, kmers, k = testing.make_unitig_store(genome_length=3000, k=9, seed=0)
g = mt.build_bigraph_from_unitigs(store, k)
tigs = mt.compute_greedytigs(g, mt.GreedytigConfig(
    k=k, engine="device", device=["cpu"] * 2, use_mesh=True))
testing.assert_tigs_spell_kmer_set(g, tigs, store, k, kmers, allow_duplicates=True)
keys = np.arange(100, dtype=np.int64)[::-1].copy()
assert np.array_equal(mesh.sharded_accept_key_sort(keys, mesh.make_mesh(["cpu"] * 3)), keys[::-1])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "matchtigs_tpu"))
print("LEAKED", bad)
assert not bad, bad
"""


def test_mesh_run_imports_no_jax():
    """The mesh layer (parallel/mesh.py, ops/mesh_sort.py) on CPU shards."""
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    proc = subprocess.run(
        [sys.executable, "-c", _MESH_RUN],
        cwd=PKG.parent, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "LEAKED []" in proc.stdout


def test_no_module_of_the_port_names_jax():
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "matchtigs_tpu"), (path, name)


@functools.cache
def _store():
    store, _, k = testing.make_unitig_store(genome_length=3000, k=9, seed=0)
    return store, k


def _graph():
    store, k = _store()
    return build_bigraph_from_unitigs(store, k), store, k


def _balanced():
    g, store, k = _graph()
    euler.make_eulerian_with_breaking_edges(g, k, 0)
    return g, k


def _balance():
    g, _, k = _graph()
    return lambda: euler.make_eulerian_with_breaking_edges(g, k, 0)


def _decomposition():
    g, _ = _balanced()
    return lambda: euler.eulerian_bicycle_decomposition(g)


def _break():
    g, k = _balanced()
    cycles = euler.eulerian_bicycle_decomposition(g)
    return lambda: euler.break_cycles(g, cycles, k)


def _pathtigs():
    g, _, _ = _graph()
    return lambda: compute_pathtigs(g)


def _greedy_accept():
    g, _, _ = _graph()
    out_nodes, in_mask, m = unbalanced_nodes(g)
    v = np.flatnonzero(in_mask)
    cands = Candidates.from_triples(
        np.stack([out_nodes[:4], v[:4], np.ones(4, dtype=np.int64)], axis=1)
    )
    return lambda: greedy_accept(g, [cands], m)


def _spell_walks_flat():
    g, store, k = _graph()
    walks = compute_pathtigs(g)
    return lambda: spell_walks_flat(g, walks, store, k)


def _component_labels():
    rows, cols = np.array([0, 1]), np.array([1, 2])
    return lambda: _connected_component_labels(4, rows, cols)


def _padded_adj():
    src = np.array([0, 1], dtype=np.int32)
    dst = np.array([1, 2], dtype=np.int32)
    return lambda: _fill_padded_adj(None, 3, src, dst, np.array([1, 1]), 4, 100)


def _matching():
    edges = np.array([[0, 1, 5], [1, 2, 3]], dtype=np.int64)
    return lambda: max_weight_matching_sparse(3, edges)


_PASSES = {
    "balance": _balance,
    "decomposition": _decomposition,
    "break": _break,
    "pathtigs": _pathtigs,
    "greedy_accept": _greedy_accept,
    "spell_walks_flat": _spell_walks_flat,
    "connected_component_labels": _component_labels,
    "fill_padded_adj": _padded_adj,
    "matching": _matching,
}


@pytest.mark.parametrize("name", list(_PASSES))
def test_pass_raises_the_loader_error_without_native_library(monkeypatch, name):
    """Where the library cannot be built, each host pass raises the
    loader's ImportError (the compiler's message) instead of returning a
    result from a second implementation."""
    run = _PASSES[name]()
    err = ImportError("native build failed: no compiler")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", err)
    with pytest.raises(ImportError) as info:
        run()
    assert info.value is err


_NO_NATIVE_IMPORT = """
import importlib
import importlib.util
import pkgutil
import sys
spec = importlib.util.spec_from_file_location(
    "matchtigs_tpu_torch.native", "matchtigs_tpu_torch/native/__init__.py"
)
native = importlib.util.module_from_spec(spec)
sys.modules[spec.name] = native
spec.loader.exec_module(native)
native._load_error = ImportError("native build failed: no compiler")
import matchtigs_tpu_torch
# native/_native.so is the ctypes library, not a Python module
names = [m.name for m in pkgutil.walk_packages(
    matchtigs_tpu_torch.__path__, "matchtigs_tpu_torch.")
    if m.name != "matchtigs_tpu_torch.native._native"]
for name in names:
    importlib.import_module(name)
assert sys.modules["matchtigs_tpu_torch.native"] is native and native._lib is None
print("IMPORTED", len(names))
"""


def test_port_imports_while_native_library_fails():
    """Importing the package and every module of it loads nothing native:
    the first pass that needs the library loads it."""
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_NATIVE_IMPORT],
        cwd=PKG.parent, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "IMPORTED" in proc.stdout
