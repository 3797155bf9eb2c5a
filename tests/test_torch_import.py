"""The port stands alone: it never imports jax or the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

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
