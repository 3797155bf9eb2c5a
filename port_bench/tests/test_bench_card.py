"""The benchmark's checks that need the card."""

import json
from pathlib import Path

import pytest

from port_bench import generator, harness

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pangenome60m_k31", "pangenome100m_k31"])
def test_generator_makes_the_pinned_dataset(card, name):
    """At the configuration's genome seed the frozen generator makes, on
    the card, the dataset whose counts and sha256 the port's generator gave
    (pinned in the config)."""
    import torch

    config = json.loads((CONFIGS / f"{name}.json").read_text())
    codes, offsets, kmers = generator.make_pangenome(
        seed=config["genome_seed"], device=card, **{k: config[k] for k in harness.GENERATOR_KEYS})
    torch.cuda.empty_cache()
    pinned = config["pinned"]
    assert len(offsets) - 1 == pinned["unitigs"]
    assert len(kmers) == pinned["kmers"]
    digest = generator.dataset_digest(codes, offsets, generator.kmers_numpy(kmers))
    assert digest == pinned["sha256"]
