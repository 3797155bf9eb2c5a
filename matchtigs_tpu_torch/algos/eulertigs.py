# Copied from matchtigs_tpu/algos/eulertigs.py.
"""Eulertigs: minimum plain-text representation without k-mer repetition.

Capability-equivalent of ``EulertigAlgorithm``
(upstream src/implementation/eulertigs/mod.rs:19-198):
balance the bidirected graph with breaking dummy edges (weight k), decompose
into the minimum set of Eulerian bicycles, rotate each so its longest dummy
is first, and break at breaking dummies.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from ..graph.bigraph import Bigraph
from ..ops import euler

logger = logging.getLogger(__name__)


@dataclass
class EulertigConfig:
    k: int


def compute_eulertigs(g: Bigraph, config: EulertigConfig) -> "Walks":
    """Mutates `g` (adds breaking dummy biedges) and returns edge walks."""
    k = config.k
    diff = g.imbalances()
    logger.info(
        "Found %d nodes with missing outgoing edges", int((diff < 0).sum())
    )
    logger.info(
        "Found %d nodes with missing incoming edges", int((diff > 0).sum())
    )

    logger.info("Making graph Eulerian by adding breaking dummy edges")
    euler.make_eulerian_with_breaking_edges(g, k, dummy_edge_id=0)

    if not euler.decomposes_into_eulerian_bicycles(g):
        raise AssertionError("Failed to make the graph Eulerian")
    from ..utils.debug import debug_checks

    if debug_checks():  # debug_assert! analogs, off in production
        euler.assert_no_consecutive_dummy_edges(g, k)
        assert g.verify_node_pairing()
        assert g.verify_edge_mirror_property()

    logger.info("Finding Eulerian bicycles")
    cycles = euler.eulerian_bicycle_decomposition(g)
    logger.info("Found %d Eulerian bicycles", len(cycles))

    tigs = euler.break_cycles(g, cycles, k)
    logger.info("Found %d eulertigs", len(tigs))
    return tigs
