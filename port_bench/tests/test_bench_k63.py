"""The k=63 cell, ``pangenome60m_k63.greedy_fasta``: its configuration is
``pangenome60m_k31``'s but for k, and on the card the frozen generator makes
the dataset it pins."""

import json
from pathlib import Path

import pytest

from port_bench import generator, harness

ROOT = Path(__file__).resolve().parents[2]
CELL = "pangenome60m_k63.greedy_fasta"


def test_the_configuration_is_the_k31_one_at_k63():
    config = harness.load_cell(CELL).config
    k31 = harness.load_cell("pangenome60m_k31.greedy_fasta").config
    entry = next(c for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]
                 if c["name"] == config["name"])
    assert config["name"] == "pangenome60m_k63" and config["k"] == 63
    assert entry["source"] == config["source"]
    assert sorted(entry["reduced"]) == sorted(config["reduced"])
    for key in (*harness.GENERATOR_KEYS, "genome_seed", "limits"):
        if key != "k":
            assert config[key] == k31[key], key


@pytest.mark.cuda
def test_the_k63_configuration_makes_its_pinned_dataset(card):
    """At its genome seed the frozen generator makes, on the card, the
    dataset whose counts and sha256 the configuration pins."""
    import torch

    config = harness.load_cell(CELL).config
    codes, offsets, kmers = generator.make_pangenome(
        seed=config["genome_seed"], device=card,
        **{k: config[k] for k in harness.GENERATOR_KEYS})
    torch.cuda.empty_cache()
    pinned = config["pinned"]
    assert len(offsets) - 1 == pinned["unitigs"]
    assert len(kmers) == pinned["kmers"]
    digest = generator.dataset_digest(codes, offsets, generator.kmers_numpy(kmers))
    assert digest == pinned["sha256"]
