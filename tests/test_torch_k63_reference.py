"""Greedy matchtigs at k=63 against the benchmark's plain references, on the
CPU, and the spans and counters of the two-word node-key route.

On seeded tiny pangenomes from the benchmark's generator at k=63 (7
strains, 1%, repeats), the greedy CLI (``--device cpu``) writes exactly the
input's k-mer set (``port_bench/reference.py``) and no fewer characters
than the least any matchtig set has (``port_bench/optimal_reference.py``),
which the optimal CLI writes.  The genomes are of 500-700 bp: the
reference's exact tables end at 20 ids a candidate component, and at 1 kbp
a component has 32-59.

The graph build counts one 64-bit word a node key at k=31 and two at k=63,
where its byte gather and two-word unique have spans of their own; the
cell ``pangenome60m_k63.greedy_fasta`` runs traced on the CPU at a tiny
size and reads every metric it lists.  Nothing of JAX or of the JAX
package is imported.
"""

import json
from pathlib import Path

import pytest
import torch

from port_bench import generator, harness, optimal_reference, reference

ROOT = Path(__file__).resolve().parents[1]
CELL = "pangenome60m_k63.greedy_fasta"
# (genome length, genome seed)
SEEDED = [(500, 1), (600, 4), (700, 5)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fasta(tmp_path: Path, length: int, k: int, seed: int) -> Path:
    codes, offsets, _ = generator.make_pangenome(
        genome_length=length, k=k, n_strains=7, mutation_rate=0.01, seed=seed,
        with_repeats=True, device="cpu")
    codes, offsets = generator.shuffle_unitigs(codes, offsets, 2**31 + seed, "cpu")
    fa = tmp_path / "unitigs.fa"
    generator.write_fasta(fa, codes, offsets)
    return fa


def _traced_cli(fa: Path, k: int, out: Path, monkeypatch) -> list:
    from matchtigs_tpu_torch import cli
    from matchtigs_tpu_torch.utils import tracing

    spans = []
    monkeypatch.setattr(tracing, "sink", spans.append)
    rc = cli.main(["--fa-in", str(fa), "-k", str(k), "--greedytigs-fa-out", str(out),
                   "--device", "cpu"])
    monkeypatch.setattr(tracing, "sink", tracing.discard)
    assert rc == 0
    return spans


def _cli(fa: Path, flag: str, out: Path) -> dict:
    from matchtigs_tpu_torch import cli

    assert cli.main(["--fa-in", str(fa), "-k", "63", flag, str(out), "--device", "cpu"]) == 0
    got = reference.check_output(reference.input_kmers(fa, 63, "cpu"), out, 63, "cpu")
    assert got["missing_kmers"] == got["foreign_kmers"] == got["malformed_records"] == 0
    return got


@pytest.mark.parametrize("length,seed", SEEDED)
def test_greedy_cli_spells_the_input_set_at_k63(tmp_path, length, seed):
    fa = _fasta(tmp_path, length, 63, seed)
    want = optimal_reference.min_characters(fa, 63)
    assert want["candidate_pairs"] > 0
    greedy = _cli(fa, "--greedytigs-fa-out", tmp_path / "greedy.fa")
    assert greedy["tig_ratio"] < 1
    assert greedy["characters"] >= want["characters"]
    assert _cli(fa, "--matchtigs-fa-out", tmp_path / "opt.fa")["characters"] == \
        want["characters"]


@pytest.mark.parametrize("k,words", [(31, 1), (63, 2)])
def test_the_build_counts_its_key_words_and_traces_the_two_word_route(
        tmp_path, monkeypatch, k, words):
    fa = _fasta(tmp_path, 3000, k, 1)
    spans = _traced_cli(fa, k, tmp_path / "out.fa", monkeypatch)
    by_id = {s.id: s for s in spans}
    keys = next(s for s in spans if s.name == "load.build.keys")
    nodes = next(s for s in spans if s.name == "load.build.nodes")
    assert keys.counters["key_words"] == words
    children = {s.name: s for s in spans
                if s.name in ("load.build.keys.gather", "load.build.nodes.two_word")}
    if words == 1:
        assert not children
        return
    gather, two_word = children["load.build.keys.gather"], children["load.build.nodes.two_word"]
    assert by_id[gather.parent] is keys and by_id[two_word.parent] is nodes
    # four [U, k-1] byte matrices, one row per endpoint (k-1)-mer
    assert gather.counters["bytes"] == keys.counters["keys"] * (k - 1)
    assert two_word.counters["rows"] == keys.counters["keys"]


def test_every_stage_counts_its_overflowed_sources(tmp_path, monkeypatch):
    fa = _fasta(tmp_path, 3000, 63, 1)
    spans = _traced_cli(fa, 63, tmp_path / "out.fa", monkeypatch)
    stages = [s for s in spans if s.name == "search.stage"]
    tail = [s for s in spans if s.name == "search.overflow_tail"]
    dispatch = sum(s.counters["sources"] for s in spans if s.name == "search.dispatch")
    overflowed = sum(s.counters["overflowed"] for s in stages)
    assert stages and 0 < overflowed <= dispatch
    # the host overflow mode finishes every overflowed source on the host
    assert overflowed == sum(s.counters["sources"] for s in tail)


@pytest.fixture(scope="module")
def traced_cell():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(harness.load_cell(CELL), 2**33 + 7, 0.0, True, device="cpu",
                                genome_length=20_000)
    finally:
        torch.set_num_threads(n)


def test_the_cell_runs_traced_and_correct_on_the_cpu(traced_cell):
    assert traced_cell["correct"]
    assert traced_cell["failed"] == 0
    assert all(v["value"] <= v["limit"] for v in traced_cell["checks"].values())


def _program_span_metrics() -> list:
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [m["name"] for m in bm["per_layer"] if CELL in m.get("workloads", [])
            and json.loads((ROOT / "port_bench" / "metrics" / f"{m['name']}.json")
                           .read_text())["kind"] == "program_span"]


@pytest.mark.parametrize("name", _program_span_metrics())
def test_every_program_span_metric_of_the_cell_reads(traced_cell, name):
    value = traced_cell["metrics"][name]["value"]
    assert value >= 0
    if name == "two_word_keys_s":
        assert value > 0


def test_the_cell_reads_every_metric_it_lists(traced_cell):
    listed = {name for name, _, _ in harness.load_cell(CELL).per_layer}
    assert "two_word_keys_s" in listed and "device_overflow_share" in listed
    # the kernel's roofline reads the card's profiler, which a CPU run lacks
    assert set(traced_cell["metrics"]) == listed - {"sssp_pool_roofline", "device_idle_share"}
