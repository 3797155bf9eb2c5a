# Copied from matchtigs_tpu/algos/pathtigs.py.
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
    """Dispatches to the native C++ pass when available; the python
    implementation below is the fallback and test oracle."""
    try:
        return _compute_pathtigs_native(g)
    except ImportError:
        logger.warning("native graphwalk unavailable; using python fallback")
        return Walks.from_list(compute_pathtigs_py(g))


def _compute_pathtigs_native(g: Bigraph) -> Walks:
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


def compute_pathtigs_py(g: Bigraph) -> list[np.ndarray]:
    E = g.n_edges
    if E == 0:
        return []
    out_off, out_edges, in_off, in_edges = g.csr()
    src = g.srcs()
    dst = g.dsts()

    used = np.zeros(E, dtype=bool)
    out_cursor = out_off[:-1].copy()
    in_cursor = in_off[:-1].copy()

    def next_unused_out(v: int) -> int:
        c = out_cursor[v]
        end = out_off[v + 1]
        while c < end and used[out_edges[c]]:
            c += 1
        out_cursor[v] = c
        return int(out_edges[c]) if c < end else -1

    def next_unused_in(v: int) -> int:
        c = in_cursor[v]
        end = in_off[v + 1]
        while c < end and used[in_edges[c]]:
            c += 1
        in_cursor[v] = c
        return int(in_edges[c]) if c < end else -1

    walks: list[np.ndarray] = []
    for e0 in range(E):
        if used[e0]:
            continue
        used[e0] = True
        used[e0 ^ 1] = True
        fwd = [e0]
        cur = int(dst[e0])
        while True:
            e = next_unused_out(cur)
            if e < 0:
                break
            used[e] = True
            used[e ^ 1] = True
            fwd.append(e)
            cur = int(dst[e])
        bwd: list[int] = []
        cur = int(src[e0])
        while True:
            e = next_unused_in(cur)
            if e < 0:
                break
            used[e] = True
            used[e ^ 1] = True
            bwd.append(e)
            cur = int(src[e])
        walks.append(np.asarray(bwd[::-1] + fwd, dtype=np.int64))

    logger.info("Found %d pathtigs", len(walks))
    return walks
