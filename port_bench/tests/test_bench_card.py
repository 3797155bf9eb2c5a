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


@pytest.mark.cuda
def test_generator_makes_the_smokes_k63_set(card):
    """At two words a k-mer the frozen generator makes, on the card, the
    set whose counts and sha256 the JAX package's numpy generator gave at
    the smoke's k=63 parameters (10 Mbp, 7 strains, 1%, repeats, seed 0)."""
    import torch

    codes, offsets, kmers = generator.make_pangenome(
        10_000_000, 63, 7, 0.01, 0, True, card)
    torch.cuda.empty_cache()
    assert len(offsets) - 1 == 973_464
    assert len(kmers) == 37_673_157
    digest = generator.dataset_digest(codes, offsets, generator.kmers_numpy(kmers))
    assert digest == "35e3cf5cfb4cac668a2b5e2a3932c72431a05b4977b4c10022d578d8c3adb141"
