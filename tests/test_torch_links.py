"""The port's link inputs (BCALM2 headers, GFA L-lines) against the JAX
package's on the same files: the twins of tests/test_links_builder.py,
the port's BCALM2 / GFA writers against that file's loop writers, the
link-built graph against the overlap graph, and both CLIs from a BCALM2
and a GFA file (the port on ``--device cpu``)."""

import gzip

import numpy as np
import pytest
import torch

from matchtigs_tpu import testing as j_testing
from matchtigs_tpu.cli import main as j_main
from matchtigs_tpu.graph import build as j_build
from matchtigs_tpu.io import readers as j_readers
from matchtigs_tpu_torch import testing
from matchtigs_tpu_torch.cli import main as t_main
from matchtigs_tpu_torch.graph import build as t_build
from matchtigs_tpu_torch.io import readers as t_readers

GRAPH_ARRAYS = ("srcs", "dsts", "weights", "handles", "forwards")
# even k - 1: palindromic (k-1)-mers, so self-mirror nodes occur
LINK_CASES = [dict(genome_length=3000, k=9, seed=0), dict(genome_length=6000, k=11, seed=1)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's thread pool costs more than it saves, and
    under several test workers it waits on busy cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _loop_links(g):
    """tests/test_links_builder.py:_links_from_overlap_graph."""
    links = []
    for v in range(g.n_nodes):
        for ei in g.in_edges_of(v):
            for eo in g.out_edges_of(v):
                links.append((int(g.handles()[ei]), bool(g.forwards()[ei]),
                              int(g.handles()[eo]), bool(g.forwards()[eo])))
    return links


def _sign(s):
    return b"+" if s else b"-"


def _loop_bcalm2(store, links):
    """tests/test_links_builder.py's BCALM2 loop writer, with the KC and km
    tags the port's writer adds."""
    per_uni = {i: [] for i in range(len(store))}
    for a, sa, b, sb in links:
        per_uni[a].append((sa, b, sb))
    return b"".join(
        b">%d LN:i:%d KC:i:1 km:f:1.0%s\n%s\n" % (
            i, store.length(i),
            b"".join(b" L:%s:%d:%s" % (_sign(sa), b, _sign(sb)) for sa, b, sb in per_uni[i]),
            store.get_ascii(i))
        for i in range(len(store)))


def _loop_gfa(store, links, k, header=b"H\tVN:Z:1.0\tKL:Z:%d\n", name=b"%d",
              links_first=False):
    """tests/test_links_builder.py's GFA loop writers: segments then links
    (or links first), names formatted by ``name``."""
    segs = b"".join(b"S\t%s\t%s\n" % (name % i, store.get_ascii(i)) for i in range(len(store)))
    lines = b"".join(b"L\t%s\t%s\t%s\t%s\t%dM\n" % (name % a, _sign(sa), name % b, _sign(sb), k - 1)
                     for a, sa, b, sb in links)
    return header % k + (lines + segs if links_first else segs + lines)


def _assert_links_equal(t_links, j_links):
    for col in ("a", "sa", "b", "sb"):
        got, want = getattr(t_links, col), getattr(j_links, col)
        assert got.dtype == want.dtype and np.array_equal(got, want), col


def _assert_graphs_equal(tg, jg):
    assert (tg.n_nodes, tg.n_edges) == (jg.n_nodes, jg.n_edges)
    for name in GRAPH_ARRAYS:
        assert np.array_equal(getattr(tg, name)(), getattr(jg, name)()), name
    assert np.array_equal(tg.mirror_node, jg.mirror_node)


def _assert_stores_equal(t_store, j_store):
    assert np.array_equal(t_store.offsets, j_store.offsets)
    assert np.array_equal(t_store.codes, j_store.codes)


def _case_graphs(case):
    """The JAX and the port's overlap graphs of one of LINK_CASES."""
    j_store, _, k = j_testing.make_unitig_store(**case)
    t_store, _, _ = testing.make_unitig_store(**case)
    return (j_store, j_build.build_bigraph_from_unitigs(j_store, k),
            t_store, t_build.build_bigraph_from_unitigs(t_store, k), k)


@pytest.mark.parametrize("case", LINK_CASES, ids=["k9", "k11"])
def test_link_graph_matches_jax_and_overlap_graph(case):
    """Twin of test_links_builder_matches_overlap_builder: graph_links
    equals the JAX loop's links, both packages build the same arrays from
    them, and the link-built graph is the overlap graph renumbered."""
    j_store, jg, t_store, tg, k = _case_graphs(case)
    _assert_graphs_equal(tg, jg)
    links = testing.graph_links(tg)
    _assert_links_equal(links, j_readers.Links.from_rows(_loop_links(jg)))
    t_links_g = t_build.build_bigraph_from_links(t_store, links, k)
    j_links_g = j_build.build_bigraph_from_links(j_store, _loop_links(jg), k)
    _assert_graphs_equal(t_links_g, j_links_g)
    assert testing.same_graph_up_to_node_ids(tg, t_links_g)
    assert (tg.mirror_node == np.arange(tg.n_nodes)).any()
    for stat in ("imbalances", "out_degrees"):
        assert sorted(getattr(t_links_g, stat)().tolist()) == sorted(getattr(tg, stat)().tolist())


@pytest.mark.parametrize("case", LINK_CASES, ids=["k9", "k11"])
@pytest.mark.parametrize("fmt", ["bcalm2", "bcalm2.gz", "gfa", "gfa.gz", "fa", "fa.gz"])
def test_writers_match_loop_writers(tmp_path, case, fmt):
    """write_bcalm2, write_gfa and write_fasta write the loop writers'
    bytes."""
    _, jg, t_store, tg, k = _case_graphs(case)
    links = _loop_links(jg)
    path = tmp_path / f"in.{fmt}"
    if fmt.startswith("fa"):
        testing.write_fasta(path, t_store)
        want = b"".join(b">%d\n%s\n" % (i, t_store.get_ascii(i)) for i in range(len(t_store)))
    elif fmt.startswith("bcalm2"):
        testing.write_bcalm2(path, t_store, testing.graph_links(tg))
        want = _loop_bcalm2(t_store, links)
    else:
        testing.write_gfa(path, t_store, testing.graph_links(tg), k)
        want = _loop_gfa(t_store, links, k)
    data = path.read_bytes()
    assert (gzip.decompress(data) if fmt.endswith(".gz") else data) == want


def _synthetic_file(tmp_path, kind):
    """(path, reader name, k) of the JAX link tests' files, written by their
    loops (the roundtrip files by the port's writers, equal to those)."""
    seed = {"gfa_roundtrip": 2, "bcalm2_roundtrip": 3, "gfa_links_first": 4,
            "gfa_string_names": 5}[kind]
    store, _, k = testing.make_unitig_store(genome_length=3000, k=9, seed=seed)
    g = t_build.build_bigraph_from_unitigs(store, k)
    links = testing.graph_links(g)
    if kind == "gfa_roundtrip":
        path = tmp_path / "in.gfa.gz"
        testing.write_gfa(path, store, links, k)
        return path, "read_gfa", k
    if kind == "bcalm2_roundtrip":
        path = tmp_path / "in.bcalm.fa"
        testing.write_bcalm2(path, store, links)
        return path, "read_bcalm2", k
    path = tmp_path / f"{kind}.gfa"
    rows = list(links)
    if kind == "gfa_links_first":
        path.write_bytes(_loop_gfa(store, rows, k, header=b"H\tKL:Z:%d\n", links_first=True))
    else:
        path.write_bytes(_loop_gfa(store, rows, k, header=b"H\tKL:Z:%d\n", name=b"utg%d"))
    return path, "read_gfa", k


def _tiny_file(tmp_path, kind):
    """(path, reader name) of the JAX link tests' hand-written files."""
    if kind == "gfa_leading_zeros":
        path = tmp_path / "zeros.gfa"
        path.write_bytes(b"H\tKL:Z:5\nS\t01\tACGTACGT\nS\t1\tCGTACGTA\nL\t01\t+\t1\t+\t4M\n")
        return path, "read_gfa"
    if kind.startswith("gfa_unresolved"):
        names = (b"7", b"99") if kind.endswith("numeric") else (b"x", b"y")
        path = tmp_path / "drop.gfa"
        path.write_bytes(b"H\tKL:Z:5\nS\t%s\tACGTACGT\n" % names[0]
                         + b"L\t%s\t+\t%s\t-\t4M\n" % names
                         + b"L\t%s\t+\t%s\t-\t4M\n" % (names[0], names[0]))
        return path, "read_gfa"
    path = tmp_path / "mal.bcalm.fa"
    path.write_bytes(b">0 LN:i:8 L:+:1:- L:+:x:- XL:+:1:+ L:-:1 KL:+:2:+\nACGTACGT\n"
                     b">1 L:-:0:+\nCGTACGTA\n")
    return path, "read_bcalm2"


def _read_both(path, reader):
    """(store, links, k, header) of each package's reader on ``path``."""
    out = []
    for mod in (t_readers, j_readers):
        store, meta = getattr(mod, reader)(path)
        if reader == "read_gfa":
            out.append((store, meta.links, meta.k, meta.header))
        else:
            out.append((store, meta, None, None))
    return out


@pytest.mark.parametrize(
    "kind", ["gfa_roundtrip", "bcalm2_roundtrip", "gfa_links_first", "gfa_string_names"])
def test_link_reader_and_build_match_jax(tmp_path, kind):
    """Twins of test_gfa_links_roundtrip, test_bcalm2_links_roundtrip,
    test_gfa_links_before_segments and test_gfa_string_names_fallback: the
    same store, Links columns, k and header from both readers, the same
    graph arrays from both builders, and the overlap graph renumbered."""
    path, reader, k = _synthetic_file(tmp_path, kind)
    (t_store, t_links, t_k, t_hdr), (j_store, j_links, j_k, j_hdr) = _read_both(path, reader)
    _assert_stores_equal(t_store, j_store)
    _assert_links_equal(t_links, j_links)
    assert (t_k, t_hdr) == (j_k, j_hdr) and t_k in (None, k)
    tg = t_build.build_bigraph_from_links(t_store, t_links, k)
    _assert_graphs_equal(tg, j_build.build_bigraph_from_links(j_store, j_links, k))
    assert testing.same_graph_up_to_node_ids(t_build.build_bigraph_from_unitigs(t_store, k), tg)


@pytest.mark.parametrize(
    "kind,want",
    [("gfa_leading_zeros", [(0, True, 1, True)]),
     ("gfa_unresolved_numeric", [(0, True, 0, False)]),
     ("gfa_unresolved_strings", [(0, True, 0, False)]),
     ("bcalm2_malformed", [(0, True, 1, False), (1, False, 0, True)])],
)
def test_link_reader_edge_cases_match_jax(tmp_path, kind, want):
    """Twins of test_gfa_leading_zero_names_fallback,
    test_gfa_unresolved_link_names_dropped (both name styles) and
    test_bcalm2_malformed_tags_skipped."""
    path, reader = _tiny_file(tmp_path, kind)
    (t_store, t_links, t_k, t_hdr), (j_store, j_links, j_k, j_hdr) = _read_both(path, reader)
    _assert_stores_equal(t_store, j_store)
    _assert_links_equal(t_links, j_links)
    assert (t_k, t_hdr) == (j_k, j_hdr)
    assert sorted(t_links) == want


@pytest.mark.parametrize("name,reader", [("e.fa", "read_fasta"), ("e.gfa", "read_gfa"),
                                         ("e.bcalm.fa", "read_bcalm2")])
def test_empty_inputs_match_jax(tmp_path, name, reader):
    """Twin of test_empty_inputs."""
    path = tmp_path / name
    path.write_bytes(b"")
    (t_store, t_meta), (j_store, j_meta) = (getattr(m, reader)(path)
                                            for m in (t_readers, j_readers))
    assert len(t_store) == len(j_store) == 0
    if reader == "read_bcalm2":
        _assert_links_equal(t_meta, j_meta)
    elif reader == "read_gfa":
        _assert_links_equal(t_meta.links, j_meta.links)
        assert (t_meta.k, t_meta.header) == (j_meta.k, j_meta.header)


def test_links_column_container_matches_jax():
    """Twin of test_links_column_container_roundtrip."""
    rows = [(0, True, 1, False), (1, False, 0, True)]
    t_links, j_links = t_readers.Links.from_rows(rows), j_readers.Links.from_rows(rows)
    _assert_links_equal(t_links, j_links)
    assert list(iter(t_links)) == rows and len(t_links) == 2
    assert t_readers.Links.from_rows(t_links) is t_links
    assert len(t_readers.Links.from_rows([])) == 0 and not t_readers.Links.from_rows([])


@pytest.mark.parametrize(
    "k,genome_length,n_strains,split",
    [(31, 20000, 3, 0), (63, 8000, 3, 0), (31, 50000, 7, 2)],
    ids=["k31", "k63", "k31-linkless"],
)
def test_pangenome_link_graph_is_the_overlap_graph(tmp_path, k, genome_length, n_strains,
                                                   split):
    """A pangenome draw written as BCALM2 and read back: the link-built
    graph equals the overlap graph up to node numbering once the nodes no
    link names are split (the third draw has one such node and its mirror:
    two unitigs that end in the same (k-1)-mer), and the JAX package reads
    and builds the same."""
    store, _, k = testing.make_pangenome_store(
        genome_length=genome_length, k=k, n_strains=n_strains, mutation_rate=0.01,
        seed=k if split == 0 else 0, with_repeats=split > 0, device="cpu")
    g = t_build.build_bigraph_from_unitigs(store, k)
    path = tmp_path / "in.bcalm.fa"
    testing.write_bcalm2(path, store, testing.graph_links(g))
    (t_store, t_links, _, _), (j_store, j_links, _, _) = _read_both(path, "read_bcalm2")
    _assert_stores_equal(t_store, store)
    _assert_links_equal(t_links, j_links)
    tg = t_build.build_bigraph_from_links(t_store, t_links, k)
    _assert_graphs_equal(tg, j_build.build_bigraph_from_links(j_store, j_links, k))
    linkless = testing.split_linkless_nodes(g)
    assert linkless.n_nodes - g.n_nodes == split
    assert testing.same_graph_up_to_node_ids(linkless, tg)
    _assert_graphs_equal(linkless, tg)
    assert testing.same_graph_up_to_node_ids(g, tg) == (split == 0)


def test_same_graph_check_refuses_other_graphs():
    """same_graph_up_to_node_ids fails a graph with one edge moved, one with
    a mirror map that does not commute, and one with a different weight."""
    _, _, store, g, k = _case_graphs(LINK_CASES[0])
    other = t_build.build_bigraph_from_links(store, testing.graph_links(g), k)
    assert testing.same_graph_up_to_node_ids(g, other)
    moved = other.copy()
    e = int(np.flatnonzero(moved.dsts() != moved.dsts()[0])[0])
    moved.edge_dst[0] = moved.dsts()[e]
    assert not testing.same_graph_up_to_node_ids(g, moved)
    swapped = other.copy()
    pair = np.flatnonzero(swapped.mirror_node != np.arange(swapped.n_nodes))[:1]
    v, w = int(pair[0]), int(swapped.mirror_node[pair[0]])
    swapped.mirror_node = swapped.mirror_node.copy()
    swapped.mirror_node[[v, w]] = (v, w)
    assert not testing.same_graph_up_to_node_ids(g, swapped)
    heavier = other.copy()
    heavier.edge_weight[0] += 1
    assert not testing.same_graph_up_to_node_ids(g, heavier)


@pytest.fixture(scope="module")
def link_inputs(tmp_path_factory):
    """A 3-strain pangenome at k=21 as plain fasta, BCALM2 and gzipped GFA."""
    tmp = tmp_path_factory.mktemp("torch_links")
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    store, _, k = testing.make_pangenome_store(genome_length=6000, k=21, n_strains=3,
                                               mutation_rate=0.01, seed=3, device="cpu")
    torch.set_num_threads(saved)
    links = testing.graph_links(t_build.build_bigraph_from_unitigs(store, k))
    paths = {"fa": tmp / "unitigs.fa", "bcalm": tmp / "unitigs.bcalm.fa",
             "gfa": tmp / "unitigs.gfa.gz"}
    testing.write_fasta(paths["fa"], store)
    testing.write_bcalm2(paths["bcalm"], store, links)
    testing.write_gfa(paths["gfa"], store, links, k)
    return paths, k


OUTPUTS = [("--greedytigs-fa-out", "greedy.fa"), ("--greedytigs-gfa-out", "greedy.gfa"),
           ("--matchtigs-fa-out", "match.fa"),
           ("--matchtigs-duplication-bitvector-out", "match.bv"),
           ("--eulertigs-fa-out", "euler.fa"), ("--pathtigs-gfa-out", "path.gfa")]


@pytest.mark.parametrize("source", ["bcalm", "gfa"])
def test_cli_from_link_input_byte_identical_to_jax(link_inputs, tmp_path, source):
    """Both CLIs from a BCALM2 or a GFA file write the same bytes for every
    algorithm's outputs."""
    paths, k = link_inputs
    source_args = (["--bcalm-in", str(paths["bcalm"]), "-k", str(k)] if source == "bcalm"
                   else ["--gfa-in", str(paths["gfa"])])
    outs = {}
    for side, main in (("jax", j_main), ("torch", t_main)):
        device = ["--device", "cpu"] if side == "torch" else []
        options = [a for flag, name in OUTPUTS for a in (flag, str(tmp_path / f"{side}.{name}"))]
        assert main([*source_args, *options, "--log-level", "Warning", *device]) == 0
        outs[side] = [(tmp_path / f"{side}.{name}").read_bytes() for _, name in OUTPUTS]
    for (flag, _), jax_out, torch_out in zip(OUTPUTS, outs["jax"], outs["torch"]):
        assert jax_out == torch_out and len(jax_out) > 0, flag


def test_cli_ladder_from_bcalm2_byte_identical_to_jax(link_inputs, tmp_path, monkeypatch):
    """Both CLIs on their device engines from BCALM2 at first capacity 16
    with the ladder (the JAX stage on the XLA CPU backend, the port's plain
    version on the CPU)."""
    from matchtigs_tpu.algos import greedytigs as j_greedytigs
    from matchtigs_tpu_torch.algos import greedytigs as t_greedytigs

    for mod in (j_greedytigs, t_greedytigs):
        monkeypatch.setattr(mod, "_use_host_engine", lambda config: False)
    paths, k = link_inputs
    outs = []
    for side, main in (("jax", j_main), ("torch", t_main)):
        out = tmp_path / f"{side}.fa"
        device = ["--device", "cpu"] if side == "torch" else []
        assert main(["--bcalm-in", str(paths["bcalm"]), "-k", str(k), "--greedytigs-fa-out",
                     str(out), "--sssp-initial-capacity", "16", "--sssp-overflow-mode",
                     "ladder", "--use-mesh", "false", "--log-level", "Warning", *device]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 0


@pytest.mark.parametrize("source", ["bcalm", "gfa"])
def test_load_unitigs_from_link_input_equals_fasta(link_inputs, source):
    """load_unitigs from a link input gives the store of --fa-in on the same
    unitigs, k, and the links (none from plain fasta)."""
    paths, k = link_inputs
    fa_store, fa_k, _, fa_links = t_readers.load_unitigs(fa_in=str(paths["fa"]), k=k)
    if source == "bcalm":
        store, got_k, header, links = t_readers.load_unitigs(bcalm_in=str(paths["bcalm"]), k=k)
        assert header is None
    else:
        store, got_k, header, links = t_readers.load_unitigs(gfa_in=str(paths["gfa"]))
        assert header == f"H\tVN:Z:1.0\tKL:Z:{k}"
    _assert_stores_equal(store, fa_store)
    assert got_k == fa_k == k and fa_links is None and len(links) > len(store)
