"""The port's greedy matchtigs against the JAX package's: identical tig
walks (``Walks.flat`` / ``offsets``) from the device engine (here the
kernel's plain torch version) and the host engine."""

import hashlib

import numpy as np
import pytest
import torch

from matchtigs_tpu import testing as jtesting
from matchtigs_tpu.algos.greedytigs import GreedytigConfig as JConfig
from matchtigs_tpu.algos.greedytigs import compute_greedytigs as j_greedy
from matchtigs_tpu.graph.build import build_bigraph_from_unitigs as j_build
from matchtigs_tpu_torch import testing as ttesting
from matchtigs_tpu_torch.algos.greedytigs import GreedytigConfig as TConfig
from matchtigs_tpu_torch.algos.greedytigs import SearchStats
from matchtigs_tpu_torch.algos.greedytigs import compute_greedytigs as t_greedy
from matchtigs_tpu_torch.graph.build import build_bigraph_from_unitigs as t_build
from matchtigs_tpu_torch.io.writers import spell_walks_flat

# tests/test_greedytigs.py's CASES, then the golden graphs of
# tests/test_golden_outputs.py with their pinned greedytigs outputs.
GRAPHS = {
    "k9": ("unitig", dict(genome_length=3000, k=9, seed=0)),
    "k11": ("unitig", dict(genome_length=8000, k=11, seed=1)),
    "k7": ("unitig", dict(genome_length=2500, k=7, seed=2)),
    "k13-two-seqs": ("unitig", dict(genome_length=5000, k=13, seed=3, n_sequences=2)),
    "golden": ("unitig", dict(genome_length=2000, k=9, seed=5)),
    "golden-pangenome": ("pangenome", dict(
        genome_length=20000, k=13, n_strains=4, mutation_rate=0.02,
        seed=11, with_repeats=True,
    )),
}
PINNED = {
    "golden": (1, 2000, "4bbf8a86860dd707"),
    "golden-pangenome": (152, 14989, "e19d21f5af99516c"),
}


def _store(mod, kind, case):
    make = mod.make_unitig_store if kind == "unitig" else mod.make_pangenome_store
    return make(**case)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_greedytigs_identical_to_jax(name):
    kind, case = GRAPHS[name]
    store, _, k = _store(jtesting, kind, case)
    jg = j_build(store, k)
    want_dev = j_greedy(jg.copy(), JConfig(k=k, engine="device", use_mesh=False))
    want_host = j_greedy(jg.copy(), JConfig(k=k, engine="host"))
    assert np.array_equal(want_dev.flat, want_host.flat)

    tstore, kmers, tk = _store(ttesting, kind, case)
    tg = t_build(tstore, tk)
    for engine in ("device", "host"):
        g = tg.copy()
        stats = SearchStats()
        got = t_greedy(g, TConfig(k=tk, engine=engine, device="cpu"), stats=stats)
        assert np.array_equal(got.flat, want_dev.flat), engine
        assert np.array_equal(got.offsets, want_dev.offsets), engine
        ran_stage = engine == "device" and stats.sources > 0
        assert bool(stats.stage_times) == ran_stage, engine
        ttesting.assert_tigs_spell_kmer_set(
            g, got, tstore, tk, kmers, allow_duplicates=True
        )
    if name in PINNED:
        n_tigs, total, digest = PINNED[name]
        flat, off = spell_walks_flat(g, got, tstore, tk)
        assert len(got) == n_tigs and int(off[-1]) == total
        h = hashlib.sha256(flat.tobytes() + off.tobytes()).hexdigest()[:16]
        assert h == digest


def test_one_launch_stage_identical_to_jax_chunked_stage():
    """A graph with >= 8 x the JAX batch_size device sources: the JAX
    package splits it into two overlapped chunks, the port runs one
    launch.  The tigs must not differ."""
    kind, case = GRAPHS["golden-pangenome"]
    batch = 64
    store, _, k = _store(jtesting, kind, case)
    jg = j_build(store, k)
    want = j_greedy(jg.copy(), JConfig(
        k=k, engine="device", use_mesh=False, batch_size=batch,
        initial_capacity=8, overflow_mode="host",
    ))
    tstore, _, tk = _store(ttesting, kind, case)
    tg = t_build(tstore, tk)
    stats = SearchStats()
    got = t_greedy(tg.copy(), TConfig(
        k=tk, engine="device", device="cpu", initial_capacity=8,
    ), stats=stats)
    assert stats.stage_sources[0] >= 8 * batch, "graph too small for chunking"
    assert len(stats.stage_times) == 1
    assert np.array_equal(got.flat, want.flat)
    assert np.array_equal(got.offsets, want.offsets)


@pytest.mark.parametrize("overflow_mode", ["host", "ladder"])
def test_renumber_identical_to_jax(caplog, overflow_mode):
    """``renumber=True`` searches a reverse-Cuthill-McKee-numbered device
    graph (host-routed and tail sources translated both ways); the walks
    equal the JAX package's with the same knob."""
    kind, case = GRAPHS["golden-pangenome"]
    store, _, k = _store(jtesting, kind, case)
    want = j_greedy(j_build(store, k), JConfig(
        k=k, engine="device", use_mesh=False, renumber=True,
    ))
    tstore, kmers, tk = _store(ttesting, kind, case)
    tg = t_build(tstore, tk)
    stats = SearchStats()
    with caplog.at_level("INFO", logger="matchtigs_tpu_torch"):
        got = t_greedy(tg, TConfig(k=tk, engine="device", device="cpu", renumber=True,
                                   overflow_mode=overflow_mode), stats=stats)
    assert "Device graph build (renumber=True)" in caplog.text
    assert stats.host_routed > 0 and stats.retries > 0  # both translations ran
    assert np.array_equal(got.flat, want.flat)
    assert np.array_equal(got.offsets, want.offsets)
    ttesting.assert_tigs_spell_kmer_set(tg, got, tstore, tk, kmers, allow_duplicates=True)


@pytest.mark.parametrize(
    "option",
    [dict(use_mesh=True), dict(overflow_mode="ladder")],
    ids=["mesh", "ladder"],
)
def test_unported_options_raise(option):
    """The mesh and the ladder, once refused here, now run and give the
    default run's walks (the mesh here on one CPU shard; the mesh tests are
    in test_torch_mesh.py)."""
    store, _, k = ttesting.make_unitig_store(genome_length=3000, k=9, seed=0)
    g = t_build(store, k)
    want = t_greedy(g.copy(), TConfig(k=k, engine="device", device="cpu"))
    got = t_greedy(g.copy(), TConfig(k=k, engine="device", device="cpu", **option))
    assert np.array_equal(got.flat, want.flat)
    assert np.array_equal(got.offsets, want.offsets)


@pytest.mark.parametrize("name", ["ladder-k9", "golden-pangenome"])
def test_ladder_identical_to_jax(name):
    """overflow_mode="ladder": several device stages at 4x capacity each;
    the walks equal the JAX ladder's and the port's host-tail run's."""
    kind, case = (
        ("unitig", dict(genome_length=4000, k=9, seed=11))
        if name == "ladder-k9" else GRAPHS[name]
    )
    store, _, k = _store(jtesting, kind, case)
    want = j_greedy(j_build(store, k), JConfig(
        k=k, engine="device", use_mesh=False, overflow_mode="ladder",
    ))
    tstore, kmers, tk = _store(ttesting, kind, case)
    tg = t_build(tstore, tk)
    stats = SearchStats()
    g = tg.copy()
    got = t_greedy(g, TConfig(k=tk, engine="device", device="cpu", overflow_mode="ladder"), stats)
    assert len(stats.stage_sources) >= 2
    assert stats.stage_sources == sorted(stats.stage_sources, reverse=True)
    assert stats.capacity_final == 4 ** len(stats.stage_sources)
    assert len(stats.stage_times) == len(stats.stage_sources)
    assert stats.retries == len(stats.stage_sources) - 1
    assert np.array_equal(got.flat, want.flat)
    assert np.array_equal(got.offsets, want.offsets)
    host_tail = t_greedy(tg.copy(), TConfig(k=tk, engine="device", device="cpu"))
    assert np.array_equal(got.flat, host_tail.flat)
    ttesting.assert_tigs_spell_kmer_set(g, got, tstore, tk, kmers, allow_duplicates=True)


def test_ladder_exhausts_max_capacity():
    store, _, k = ttesting.make_unitig_store(genome_length=4000, k=9, seed=11)
    with pytest.raises(RuntimeError, match="capacity 4 exhausted"):
        t_greedy(t_build(store, k), TConfig(
            k=k, engine="device", device="cpu", overflow_mode="ladder", max_capacity=4,
        ))


@pytest.mark.parametrize(
    "option",
    [dict(initial_capacity=5), dict(initial_capacity=128),
     dict(initial_capacity=1024), dict(device_schedule="batch"),
     dict(device_schedule="batch", initial_capacity=5, overflow_mode="ladder")],
    ids=["C5", "C128", "C1024", "batch", "batch-C5-ladder"],
)
def test_capacity_and_schedule_identical_to_jax(option):
    kind, case = GRAPHS["golden-pangenome"]
    store, _, k = _store(jtesting, kind, case)
    want = j_greedy(j_build(store, k), JConfig(
        k=k, engine="device", use_mesh=False, **option,
    ))
    tstore, _, tk = _store(ttesting, kind, case)
    stats = SearchStats()
    got = t_greedy(t_build(tstore, tk), TConfig(k=tk, engine="device", device="cpu", **option), stats)
    assert stats.stage_sources[0] > 0
    assert np.array_equal(got.flat, want.flat)
    assert np.array_equal(got.offsets, want.offsets)


@pytest.mark.parametrize("k", [131, 255])
def test_large_k_identical_to_jax(k):
    """k >= 128: the unpacked adjacency and rows, and their numpy
    extraction."""
    case = dict(genome_length=4000, k=k, seed=k, n_sequences=3)
    store, _, jk = jtesting.make_unitig_store_strings(**case)
    want = j_greedy(j_build(store, jk), JConfig(k=jk, engine="device", use_mesh=False))
    tstore, kmers, tk = ttesting.make_unitig_store_strings(**case)
    tg = t_build(tstore, tk)
    for engine in ("device", "host"):
        g = tg.copy()
        stats = SearchStats()
        got = t_greedy(g, TConfig(k=tk, engine=engine, device="cpu"), stats)
        assert np.array_equal(got.flat, want.flat), engine
        assert np.array_equal(got.offsets, want.offsets), engine
        assert bool(stats.stage_times) == (engine == "device")
        ttesting.assert_tigs_spell_kmer_strings(g, got, tstore, tk, kmers)


@pytest.mark.parametrize("option", [dict(), dict(use_mesh=True)], ids=["one", "mesh"])
def test_device_engine_without_cuda_raises(monkeypatch, option):
    """engine="device" names the device stage; without CUDA it raises
    unless the config names the CPU, and the CPU is never chosen for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store, _, k = ttesting.make_unitig_store(genome_length=3000, k=9, seed=0)
    g = t_build(store, k)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_greedy(g.copy(), TConfig(k=k, engine="device", **option))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_greedy(g.copy(), TConfig(k=k, engine="device", device="cuda:0", **option))
    host = t_greedy(g.copy(), TConfig(k=k, engine="host", **option))
    got = t_greedy(g.copy(), TConfig(k=k, engine="device", device="cpu", **option))
    assert np.array_equal(got.flat, host.flat)


@pytest.mark.parametrize("option", [dict(), dict(use_mesh=True)], ids=["one", "mesh"])
def test_auto_engine_without_cuda_raises(monkeypatch, option):
    """engine="auto", the default, is the device stage on config.device: it
    never runs the host search for want of a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store, _, k = ttesting.make_unitig_store(genome_length=3000, k=9, seed=0)
    g = t_build(store, k)
    assert TConfig(k=k).engine == "auto"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_greedy(g.copy(), TConfig(k=k, **option))
    stats = SearchStats()
    got = t_greedy(g.copy(), TConfig(k=k, device="cpu", **option), stats)
    want = t_greedy(g.copy(), TConfig(k=k, engine="host"))
    assert stats.stage_times and np.array_equal(got.flat, want.flat)


def test_config_rejects_unknown_modes():
    store, _, k = ttesting.make_unitig_store(genome_length=3000, k=9, seed=0)
    g = t_build(store, k)
    for option in (dict(overflow_mode="x"), dict(device_schedule="x"),
                   dict(initial_capacity=0)):
        with pytest.raises(ValueError):
            t_greedy(g.copy(), TConfig(k=k, engine="device", device="cpu", **option))
