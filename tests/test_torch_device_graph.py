"""The port's device graph (K5: packed adjacency + upload) and bigraph
build against the JAX package's, on the same unitig graphs."""

import numpy as np
import pytest
import torch

from matchtigs_tpu import testing as jtesting
from matchtigs_tpu.graph.build import build_bigraph_from_unitigs as j_build
from matchtigs_tpu.io.sequence_store import SequenceStore as JStore
from matchtigs_tpu.ops.device_graph import build_device_graph as j_dg
from matchtigs_tpu_torch import testing as ttesting
from matchtigs_tpu_torch.graph.build import build_bigraph_from_unitigs as t_build
from matchtigs_tpu_torch.interop import device_graph_from_numpy
from matchtigs_tpu_torch.ops.device_graph import build_device_graph as t_dg

CASES = [
    dict(genome_length=3000, k=9, seed=0),
    dict(genome_length=6000, k=11, seed=1),
    dict(genome_length=40000, k=13, seed=7),
]


@pytest.mark.parametrize("renumber", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_packed_adjacency_matches_jax(case, renumber):
    store, _, k = jtesting.make_unitig_store(**case)
    jdg = j_dg(j_build(store, k), renumber=renumber)
    tstore, _, tk = ttesting.make_unitig_store(**case)
    tdg = t_dg(t_build(tstore, tk), renumber=renumber)
    assert np.array_equal(tdg.nbr, jdg.nbr)
    assert np.array_equal(tdg.nw, jdg.nw)
    for a, b in ((tdg.to_orig, jdg.to_orig), (tdg.to_dev, jdg.to_dev)):
        assert (a is None and b is None) or np.array_equal(a, b)
    want = np.asarray(jdg.device_buffers(adj_packed=True)[0])
    got = tdg.device_buffers("cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)


def test_interop_carries_the_jax_graph():
    store, _, k = jtesting.make_unitig_store(genome_length=6000, k=11, seed=4)
    jdg = j_dg(j_build(store, k), renumber=True)
    tdg = device_graph_from_numpy(
        jdg.n_nodes, jdg.nbr, jdg.nw, jdg.deg_pad, jdg.to_dev, jdg.to_orig
    )
    assert np.array_equal(
        tdg.device_buffers("cpu").numpy(),
        np.asarray(jdg.device_buffers(adj_packed=True)[0]),
    )
    assert np.array_equal(tdg.unmap_nodes(np.arange(5)), jdg.unmap_nodes(np.arange(5)))
    with pytest.raises(ValueError):
        device_graph_from_numpy(jdg.n_nodes + 1, jdg.nbr, jdg.nw, jdg.deg_pad)


def test_device_buffers_cached_per_device():
    store, _, k = ttesting.make_unitig_store(genome_length=3000, k=9, seed=0)
    dg = t_dg(t_build(store, k))
    assert dg.device_buffers("cpu") is dg.device_buffers(torch.device("cpu"))


@pytest.mark.parametrize("k", [32, 33, 48, 63, 64])
def test_bigraph_matches_jax_around_two_word_nodes(k):
    """Node keys of 31 (one word), 32-62 (two words) and 63 bases (byte
    rows): node ids, mirrors and edges equal the JAX package's."""
    if k <= 63:
        store, _, _ = ttesting.make_pangenome_store(
            genome_length=20000, k=k, n_strains=4, mutation_rate=0.02, seed=k, with_repeats=True)
    else:
        store, _, _ = ttesting.make_unitig_store_strings(genome_length=400, k=k, seed=3,
                                                         n_sequences=12)
    got, want = t_build(store, k), j_build(JStore.from_flat(store.codes, store.offsets), k)
    assert got.n_nodes == want.n_nodes > 0
    assert np.array_equal(got.mirror_node, want.mirror_node)
    for view in ("srcs", "dsts", "weights", "handles", "forwards"):
        assert np.array_equal(getattr(got, view)(), getattr(want, view)()), view
