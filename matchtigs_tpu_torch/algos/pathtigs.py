# Copied from matchtigs_tpu/algos/pathtigs.py; without its python fallbacks: the port requires the native library.
"""Pathtigs: heuristically small edge-disjoint biwalk cover.

Capability-equivalent of ``PathtigAlgorithm`` /
``bigraph::algo::walk_cover::arbitrary_biwalk_cover``
(upstream src/implementation/pathtigs/mod.rs:9-41).  The graph is
not modified.  Each biedge is covered exactly once: traversing an edge
consumes its mirror (e ^ 1).  Walks are maximal: each is extended forward
from its end and backward from its start until no unconsumed edge remains,
which yields the same heuristically-small cover class as the reference
(simplitigs/UST-style).
"""

from __future__ import annotations

import logging

import numpy as np

from ..graph.bigraph import Bigraph
from ..ops.walks import Walks

logger = logging.getLogger(__name__)


def compute_pathtigs(g: Bigraph) -> Walks:
    """The native biwalk cover (native/graphwalk.cpp:biwalk_cover); the
    tests hold it against the JAX package's python cover."""
    from .. import native

    lib = native.load()
    E = g.n_edges
    if E == 0:
        return Walks(np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
    out_off, out_edges, in_off, in_edges = g.csr()
    p = native.as_ll_ptr
    src = np.ascontiguousarray(g.srcs(), dtype=np.int64)
    dst = np.ascontiguousarray(g.dsts(), dtype=np.int64)
    out_off = np.ascontiguousarray(out_off, dtype=np.int64)
    out_edges = np.ascontiguousarray(out_edges, dtype=np.int64)
    in_off = np.ascontiguousarray(in_off, dtype=np.int64)
    in_edges = np.ascontiguousarray(in_edges, dtype=np.int64)
    walks_out = np.empty(E, dtype=np.int64)
    offsets_out = np.empty(E, dtype=np.int64)
    n_walks = lib.biwalk_cover(
        g.n_nodes,
        E,
        p(src),
        p(dst),
        p(out_off),
        p(out_edges),
        p(in_off),
        p(in_edges),
        p(walks_out),
        p(offsets_out),
    )
    offsets = offsets_out[:n_walks].copy()
    used = int(offsets[-1]) if n_walks else 0
    walks = Walks(walks_out[:used], offsets)
    logger.info("Found %d pathtigs", len(walks))
    return walks
