# Copied from matchtigs_tpu/ops/perfect_matching.py; comments keep their reasons and drop the JAX package's host timings; without its networkx fallback: the port requires the native library.
"""Maximum-weight matching front-end for optimal matchtigs.

The reference reduces optimal tig joining to min-cost *perfect* matching on
a doubled graph with 4 extra nodes per weakly connected component and ships
it to the external blossom5 binary
(upstream src/implementation/matchtigs/mod.rs:600-746).  Here the
same optimum is computed as a maximum-weight matching directly:

- matching a candidate pair (join) saves ``s(e) = (k-1) - w(e)`` characters
  versus breaking both ends (the copy-pair edges of weight k-1 in the
  reference encoding);
- every component must keep at least one break (its Eulerian tour is a
  cycle that has to be cut), which the reference encodes as 4 zero-cost
  extra nodes per WCC; here each component instance gets 2 gadget nodes
  connected to all members with a dominating profit, absorbing exactly the
  two free tig ends;
- profits are scaled by (m+2) and offset by +1 per edge so the solver is
  lexicographically optimal: minimum cumulative length first, then minimum
  string count.

Solved per component with the native sparse blossom (adjacency-list
Galil primal-dual, native/blossom_sparse.cpp -- exact at any component
size, O(V+E) memory); tiny components use closed forms, and components
up to ``dense_limit`` can be routed through the independent dense O(n^3)
blossom (a second implementation used as a cross-check oracle in tests).
Both are native; the port requires the library.
"""

from __future__ import annotations

import ctypes
import logging

import numpy as np

logger = logging.getLogger(__name__)

# Max component size routed to the dense O(n^3)/O(n^2)-memory solver when
# a caller explicitly prefers it; beyond it the sparse exact blossom runs
# (the sparse solver is the faster one and the default everywhere, so
# this is a perf/testing knob, not a correctness limit).
DENSE_LIMIT = 2000
COUNT_SCALE = 1 << 20  # global (length, count) lexicographic profit scale


def max_weight_matching_dense(weights: np.ndarray) -> tuple[np.ndarray, int]:
    """Exact maximum-weight matching on a dense int64 weight matrix.

    weights[u, v] > 0 are edges; 0 means absent.  Returns (mate, total):
    mate[u] = partner or -1.
    """
    n = weights.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.int32), 0
    assert weights.shape == (n, n)
    w = np.ascontiguousarray(weights, dtype=np.int64)
    assert (w == w.T).all(), "weight matrix must be symmetric"
    from .. import native

    lib = native.load()
    mate = np.empty(n, dtype=np.int32)
    total = lib.mwm_dense(
        n,
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        mate.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return mate, int(total)


def max_weight_matching_sparse(
    n: int, edges: np.ndarray
) -> tuple[np.ndarray, int]:
    """Exact maximum-weight matching on a sparse edge list.

    edges: int64 [M, 3] rows (u, v, w), w >= 0 (parallel edges allowed).
    Returns (mate, total): mate[u] = partner or -1.  Native adjacency-list
    blossom (native/blossom_sparse.cpp); exact at any size.
    """
    if n == 0:
        return np.empty(0, dtype=np.int32), 0
    from .. import native

    lib = native.load()
    eu = np.ascontiguousarray(edges[:, 0], dtype=np.int64)
    ev = np.ascontiguousarray(edges[:, 1], dtype=np.int64)
    ew = np.ascontiguousarray(edges[:, 2], dtype=np.int64)
    mate = np.empty(n, dtype=np.int32)
    p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))
    total = lib.mwm_sparse(
        n, len(edges), p(eu), p(ev), p(ew),
        mate.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return mate, int(total)


def max_weight_matching_sparse_batch(
    node_off: np.ndarray,  # int64 [C+1]
    edge_off: np.ndarray,  # int64 [C+1]
    eu: np.ndarray,  # int64 [M] component-local endpoints
    ev: np.ndarray,
    ew: np.ndarray,  # int64 [M] weights >= 0
    n_threads: int | None = None,
) -> tuple[np.ndarray, int]:
    """Exact maximum-weight matchings for many independent components in
    one native call (big-first internal thread pool; see mwm_sparse_batch
    in native/blossom_sparse.cpp).  Returns (mate int32 [node_off[-1]]
    with component-LOCAL partners or -1, summed total weight)."""
    import os

    n_comps = len(node_off) - 1
    n_total = int(node_off[-1])
    if n_comps == 0 or n_total == 0:
        return np.empty(0, dtype=np.int32), 0
    from .. import native

    lib = native.load()
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    node_off = np.ascontiguousarray(node_off, dtype=np.int64)
    edge_off = np.ascontiguousarray(edge_off, dtype=np.int64)
    eu = np.ascontiguousarray(eu, dtype=np.int64)
    ev = np.ascontiguousarray(ev, dtype=np.int64)
    ew = np.ascontiguousarray(ew, dtype=np.int64)
    mate = np.empty(n_total, dtype=np.int32)
    total = lib.mwm_sparse_batch(
        n_comps,
        native.as_ll_ptr(node_off),
        native.as_ll_ptr(edge_off),
        native.as_ll_ptr(eu),
        native.as_ll_ptr(ev),
        native.as_ll_ptr(ew),
        mate.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads,
        # periodic %-progress to stderr while the batch runs (minutes on
        # giant components); follows the logger's effective level
        1 if logger.isEnabledFor(logging.INFO) else 0,
    )
    return mate, int(total)


def component_matching_variants(
    members: np.ndarray,
    edges: np.ndarray,  # int64 [M, 3]: (id_a, id_b, weight) within component
    k: int,
    deletions: tuple[int, ...] = (0,),
    dense_limit: int | None = None,
) -> dict[int, tuple[int, list[tuple[int, int]]]]:
    """Solve one candidate component's matching for each forced-deletion
    count j in `deletions`.

    A forced deletion models one of the input component's two free tig
    ends landing here (the reference's zero-cost extra-node marriages):
    j gadget nodes each absorb one member at a dominating profit.
    Returns {j: (total_profit_excluding_gadgets, matched_id_pairs)}.
    """
    m = len(members)
    out: dict[int, tuple[int, list[tuple[int, int]]]] = {}
    if m == 0:
        return {j: (0, []) for j in deletions}

    # Fast paths for the overwhelmingly common tiny components.
    if m == 2:
        # single possible (deduplicated) pair; a forced deletion kills it
        a, b, wt = int(edges[0, 0]), int(edges[0, 1]), int(edges[0, 2])
        p = (k - 1 - wt) * COUNT_SCALE + 1
        for j in deletions:
            out[j] = (p, [(a, b)]) if j == 0 else (0, [])
        return out
    if m == 3 and len(edges) <= 3:
        # odd: one member is unmatched regardless; best single edge.
        # with dedup the best pair survives any single deletion only if
        # the deleted member is the unmatched one -- j<=1 keeps the best
        # edge, j=2 keeps nothing... except deleting both endpoints of
        # no edge: with 3 members and j=2, at most one member remains.
        profits = (k - 1 - edges[:, 2]) * COUNT_SCALE + 1
        bi = int(np.argmax(profits))
        best = (int(profits[bi]), [(int(edges[bi, 0]), int(edges[bi, 1]))])
        for j in deletions:
            if j == 0 or j == 1:
                out[j] = best
            else:
                out[j] = (0, [])
        return out

    # Global profit scale so deltas are comparable ACROSS components in
    # the free-end allocation: length savings dominate the +1-per-join
    # count bonus (joins per component << COUNT_SCALE).
    big = np.int64(COUNT_SCALE)
    p_big = (np.int64(k) * big) * np.int64(m + 1) + np.int64(1)
    # local indices + max-profit dedup per id pair (members ascending --
    # required by the searchsorted lookups)
    members = np.ascontiguousarray(members, dtype=np.int64)
    assert len(members) < 2 or bool(np.all(np.diff(members) > 0)), (
        "members must be strictly ascending"
    )
    ia = np.searchsorted(members, edges[:, 0])
    ib = np.searchsorted(members, edges[:, 1])
    profit = (np.int64(k - 1) - edges[:, 2]) * big + 1
    assert np.all(profit >= 1)
    lo = np.minimum(ia, ib)
    hi = np.maximum(ia, ib)
    pair_key = lo * m + hi
    order = np.lexsort((-profit, pair_key))
    keep = np.ones(len(order), dtype=bool)
    keep[1:] = pair_key[order][1:] != pair_key[order][:-1]
    sel = order[keep]
    prof_edges = np.stack([lo[sel], hi[sel], profit[sel]], axis=1)
    # deduped edges are sorted by pair_key: profit lookups below are
    # searchsorted probes, not a python dict (1.4M-entry dicts per giant
    # tangle were a measurable share of the solve wall time)
    dedup_keys = pair_key[sel]
    dedup_profit = profit[sel]

    # A forced deletion j adds j gadget nodes adjacent to every member at
    # a dominating profit (they absorb exactly one member each).
    limit = DENSE_LIMIT if dense_limit is None else dense_limit
    use_dense = dense_limit is not None and m + max(deletions, default=0) <= limit
    for j in deletions:
        j_eff = min(j, m)
        n = m + j_eff
        if j_eff:
            mem_idx = np.arange(m, dtype=np.int64)
            gadget_parts = [
                np.stack(
                    [
                        mem_idx,
                        np.full(m, m + g, dtype=np.int64),
                        np.full(m, p_big, dtype=np.int64),
                    ],
                    axis=1,
                )
                for g in range(j_eff)
            ]
            all_edges = np.concatenate([prof_edges] + gadget_parts)
        else:
            all_edges = prof_edges
        if use_dense:
            w = np.zeros((n, n), dtype=np.int64)
            w[all_edges[:, 0], all_edges[:, 1]] = all_edges[:, 2]
            w[all_edges[:, 1], all_edges[:, 0]] = all_edges[:, 2]
            mate, _ = max_weight_matching_dense(w)
        else:
            mate, _ = max_weight_matching_sparse(n, all_edges)
        mm = mate[:m].astype(np.int64)
        i_idx = np.nonzero((mm >= 0) & (mm < m) & (np.arange(m) < mm))[0]
        p_idx = mm[i_idx]
        key = i_idx * m + p_idx
        slot = np.searchsorted(dedup_keys, key)
        total = int(dedup_profit[slot].sum())
        pairs = list(
            zip(members[i_idx].tolist(), members[p_idx].tolist())
        )
        out[j] = (total, pairs)
    return out


class ComponentTooLarge(Exception):
    """Retained for API compatibility: no longer raised now that the
    sparse blossom solves components of any size exactly."""

    def __init__(self, size: int) -> None:
        super().__init__(f"matching component with {size} nodes exceeds the dense solver limit")
        self.size = size
