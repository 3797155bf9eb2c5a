"""The search stage's layouts past 2^24 nodes, at small sizes.

A graph whose node ids (the sentinel included) do not fit 24 bits leaves
the packed rows (``_can_pack_out``: n_nodes + 1 < 2^24) and then the
packed adjacency (``_can_pack_adj``: n_nodes < 2^24): the stage uploads
the unpacked ``(nbr, nw)`` pair, runs the wide kernel's pool schedule
instead of the register kernel, and extracts its candidates from unpacked
rows and distances.  Here the predicates are held to the JAX package's
around 2^24 on stubs that carry only a node count, both packages' greedy
matchtigs and CLIs run with the predicates forced off on a k=31 pangenome
(the port's kernels by their plain versions), and the numpy extraction of
unpacked rows is held to the native extraction of the same balls
packed."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from matchtigs_tpu import testing as jtesting
from matchtigs_tpu.algos import greedytigs as jgreedytigs
from matchtigs_tpu.cli import main as j_main
from matchtigs_tpu.graph.build import build_bigraph_from_unitigs as j_build
from matchtigs_tpu.ops import sssp as jsssp
from matchtigs_tpu.ops.device_graph import DeviceGraph as JDeviceGraph
from matchtigs_tpu_torch import testing as ttesting
from matchtigs_tpu_torch.algos import greedytigs as tgreedytigs
from matchtigs_tpu_torch.cli import main as t_main
from matchtigs_tpu_torch.graph.build import build_bigraph_from_unitigs as t_build
from matchtigs_tpu_torch.ops import sssp as tsssp
from matchtigs_tpu_torch.ops.device_graph import DeviceGraph as TDeviceGraph
from matchtigs_tpu_torch.ops.device_graph import build_device_graph
from matchtigs_tpu_torch.ops.matching import unbalanced_nodes

LIMIT = 1 << 24
# (rows packed, adjacency packed) at the k=31 bound on each side of 2^24:
# at 2^24 - 1 the sentinel no longer fits the rows but every id fits the
# adjacency (the mixed layout)
LAYOUT_AT = {
    LIMIT - 2: (True, True),
    LIMIT - 1: (False, True),
    LIMIT: (False, False),
    LIMIT + 1: (False, False),
}
# the flagship's pangenome (7 strains, 1% mutations, repeats, k=31, seed 0)
# cut to 30 kbp
PANGENOME = dict(genome_length=30_000, k=31, n_strains=7, mutation_rate=0.01, seed=0,
                 with_repeats=True)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Under several xdist workers torch's thread pool makes each small op
    wait on busy cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n_nodes", list(LAYOUT_AT))
def test_pack_predicates_match_jax_around_2_24(n_nodes):
    """Both packages' predicates on stubs that carry only a node count (no
    2^24-node arrays): equal, and the layout the module docstring gives."""
    layouts = []
    for sssp, graph in ((jsssp, JDeviceGraph), (tsssp, TDeviceGraph)):
        stub = SimpleNamespace(n_nodes=n_nodes)
        stub.can_pack_adj = graph.can_pack_adj.fget(stub)
        layouts.append((sssp._can_pack_out(stub, 30), sssp._can_pack_adj(stub, 30)))
    assert layouts[0] == layouts[1] == LAYOUT_AT[n_nodes]


def _force_node_count_layout(monkeypatch, layout):
    """Both packages' predicates as a graph past 2^24 nodes gives them
    ("unpacked") or as one of exactly 2^24 - 1 nodes does ("mixed": packed
    adjacency, unpacked rows)."""
    for sssp, graph in ((jsssp, JDeviceGraph), (tsssp, TDeviceGraph)):
        monkeypatch.setattr(sssp, "_can_pack_out", lambda *a: False)
        if layout == "unpacked":
            monkeypatch.setattr(sssp, "_can_pack_adj", lambda *a: False)
            monkeypatch.setattr(graph, "can_pack_adj", property(lambda self: False))


def _count_calls(monkeypatch, module, names):
    """Calls of each of ``module``'s functions ``names``, counted through
    wrappers (on the CPU the kernels' wrappers count no launch)."""
    calls = dict.fromkeys(names, 0)

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in names:
        monkeypatch.setattr(module, name, counted(name, getattr(module, name)))
    return calls


@pytest.fixture(scope="module")
def pangenome():
    store, kmers, k = ttesting.make_pangenome_store(**PANGENOME)
    return store, kmers, k


@pytest.mark.parametrize("overflow_mode", ["host", "ladder"])
@pytest.mark.parametrize("layout", ["unpacked", "mixed"])
def test_greedytigs_past_2_24_identical_to_jax(monkeypatch, pangenome, layout,
                                               overflow_mode):
    """The port's device engine (plain versions on the CPU) with the layout
    of a graph past 2^24 nodes: the wide kernel's path and the unpacked
    extraction, walks equal to the JAX package's under the same layout and
    to the port's own packed run."""
    store, kmers, k = pangenome
    config = dict(k=k, engine="device", overflow_mode=overflow_mode)
    packed = tgreedytigs.compute_greedytigs(
        t_build(store, k), tgreedytigs.GreedytigConfig(**config, device="cpu"))

    _force_node_count_layout(monkeypatch, layout)
    calls = _count_calls(monkeypatch, tsssp, ("pool_sssp", "wide_sssp",
                                              "extract_packed_candidates",
                                              "extract_unpacked_candidates"))
    jstore, _, jk = jtesting.make_pangenome_store(**PANGENOME)
    want = jgreedytigs.compute_greedytigs(
        j_build(jstore, jk), jgreedytigs.GreedytigConfig(**config, use_mesh=False))
    tg = t_build(store, k)
    stats = tgreedytigs.SearchStats()
    got = tgreedytigs.compute_greedytigs(
        tg, tgreedytigs.GreedytigConfig(**config, device="cpu"), stats=stats)

    stages = len(stats.stage_times)
    assert stages >= (2 if overflow_mode == "ladder" else 1)
    assert calls == dict(pool_sssp=0, wide_sssp=stages, extract_packed_candidates=0,
                         extract_unpacked_candidates=stages)
    for walks in (want, packed):
        assert np.array_equal(got.flat, walks.flat)
        assert np.array_equal(got.offsets, walks.offsets)
    ttesting.assert_tigs_spell_kmer_set(tg, got, store, k, kmers, allow_duplicates=True)


@pytest.mark.parametrize("layout", ["unpacked", "mixed"])
def test_cli_past_2_24_byte_identical_to_jax(monkeypatch, tmp_path, pangenome, layout):
    """Both greedytigs CLIs on their device engines with the layout of a
    graph past 2^24 nodes: the same fasta bytes, and the port's equal to
    its own packed run."""
    store, _, k = pangenome
    fa_in = tmp_path / "unitigs.fa.gz"
    ttesting.write_fasta(fa_in, store)
    for mod in (jgreedytigs, tgreedytigs):
        monkeypatch.setattr(mod, "_use_host_engine", lambda config: False)

    def run(main, name, *options):
        out = tmp_path / name
        rc = main(["--fa-in", str(fa_in), "-k", str(k), "--greedytigs-fa-out", str(out),
                   "--use-mesh", "false", "--log-level", "Warning", *options])
        assert rc == 0
        return out.read_bytes()

    packed = run(t_main, "packed.fa", "--device", "cpu")
    _force_node_count_layout(monkeypatch, layout)
    calls = _count_calls(monkeypatch, tsssp, ("pool_sssp", "wide_sssp"))
    got = run(t_main, "torch.fa", "--device", "cpu")
    assert calls == dict(pool_sssp=0, wide_sssp=1)
    assert got == run(j_main, "jax.fa") == packed and len(got) > 0


EXTRACT_GRAPHS = {
    "pangenome-k31": ("pangenome", PANGENOME),
    "unitig-k11": ("unitig", dict(genome_length=8000, k=11, seed=1)),
}


@pytest.mark.parametrize("renumber", [False, True])
@pytest.mark.parametrize("capacity", [4, 16])
@pytest.mark.parametrize("name", list(EXTRACT_GRAPHS))
def test_unpacked_extraction_equals_packed(name, capacity, renumber):
    """The same balls as packed rows and as unpacked rows and distances:
    the numpy extraction of the latter gives the native extraction's
    candidates, in the same order, ids translated back alike."""
    kind, case = EXTRACT_GRAPHS[name]
    make = ttesting.make_pangenome_store if kind == "pangenome" else ttesting.make_unitig_store
    store, _, k = make(**case)
    g = t_build(store, k)
    dg = build_device_graph(g, renumber=renumber)
    out_nodes, in_mask, _ = unbalanced_nodes(g)
    if dg.to_orig is not None:
        in_mask = np.asarray(in_mask)[dg.to_orig]
    sources = dg.map_sources(np.asarray(out_nodes, dtype=np.int32))
    src = torch.from_numpy(sources)
    key, _, over = tsssp.pool_sssp_plain(dg.device_buffers("cpu"), src, k - 1, capacity)
    nbr, nw = dg.device_buffers("cpu", adj_packed=False)
    nodes, dist, unpacked_over = tsssp.pool_sssp_plain(nbr, src, k - 1, capacity, nw=nw,
                                                       pack_out=False)
    assert torch.equal(over, unpacked_over)
    done = ~over.numpy().astype(bool)
    assert done.any()
    want = tsssp.extract_packed_candidates(dg, key.numpy(), sources, done, in_mask)
    got = tsssp.extract_unpacked_candidates(dg, nodes.numpy(), dist.numpy(), sources, done,
                                            in_mask)
    assert len(want) > 0
    for column in ("u", "v", "d"):
        a, b = getattr(got, column), getattr(want, column)
        assert a.dtype == b.dtype == np.int64 and np.array_equal(a, b), column
