# Copied from matchtigs_tpu/ops/euler.py; without its python fallbacks: the port requires the native library, and the decomposition has no method knob (parsplice, or the int64 route past 2^31 edges).
"""Eulerian machinery for bidirected graphs.

Host-side implementation of the capabilities the reference pulls from
``bigraph::algo::eulerian`` and first-party balancing code, each pass
native (native/graphwalk.cpp) with the tests holding it against the JAX
package:

- :func:`make_eulerian_with_breaking_edges` mirrors
  ``make_graph_eulerian_with_breaking_edges``
  (upstream src/implementation/mod.rs:392-649) including its
  deterministic pairing orders (self-mirrors chunked in scan order, then
  out-nodes in DESCENDING node order x in-nodes ASCENDING, with
  mirror-collision avoidance as in ``choose_in_node_from_iterator``,
  mod.rs:252-285).
- :func:`eulerian_bicycle_decomposition` mirrors
  ``compute_minimum_bidirected_eulerian_cycle_decomposition``
  (upstream src/implementation/eulertigs/mod.rs:119): one bicycle per
  mirror-connected component, where traversing an edge consumes its
  mirror.
- :func:`break_cycles` mirrors the rotate-to-longest-dummy + break rules
  (upstream src/implementation/eulertigs/mod.rs:126-186).

Imbalance scans are vectorized numpy.
"""

from __future__ import annotations

import logging

import numpy as np

from ..graph.bigraph import Bigraph
from .walks import Walks

logger = logging.getLogger(__name__)


def decomposes_into_eulerian_bicycles(g: Bigraph) -> bool:
    """True iff every binode is balanced (upstream usage at
    eulertigs/mod.rs:105)."""
    return bool(np.all(g.imbalances() == 0))


def assert_no_consecutive_dummy_edges(g: Bigraph, k: int) -> None:
    """No node may have both an incoming and an outgoing dummy edge,
    except a single mirror pair of nonzero weight.

    Vectorized analog of ``debug_assert_graph_has_no_consecutive_dummy_edges``
    (upstream src/implementation/mod.rs:319-390).
    """
    d = g.is_dummy()
    src = g.srcs()
    dst = g.dsts()
    dummy_out = np.bincount(src[d], minlength=g.n_nodes)
    dummy_in = np.bincount(dst[d], minlength=g.n_nodes)
    both = np.flatnonzero((dummy_out > 0) & (dummy_in > 0))
    for v in both.tolist():
        ins = [e for e in g.in_edges_of(v) if d[e]]
        outs = [e for e in g.out_edges_of(v) if d[e]]
        if len(ins) == 1 and len(outs) == 1 and (ins[0] ^ 1) == outs[0]:
            assert g.weights()[ins[0]] != 0
            continue
        raise AssertionError(
            f"node {v} has both incoming and outgoing dummy edges "
            f"(self-mirror={g.is_self_mirror_node(v)}, in={ins}, out={outs})"
        )


def make_eulerian_with_breaking_edges(
    g: Bigraph, k: int, dummy_edge_id: int
) -> int:
    """Add breaking dummy biedges (weight k) until every binode balances.

    Returns the updated dummy edge id counter.  Deterministic order matches
    the reference balancer exactly (see module docstring).  The pass is
    native (graphwalk.cpp:balance_breaking_edges); the tests hold it
    against the JAX package's balancer.
    """
    from .. import native

    lib = native.load()
    n = g.n_nodes
    diff = np.ascontiguousarray(g.imbalances(), dtype=np.int64)
    mirror = np.ascontiguousarray(g.mirror_node, dtype=np.int64)
    # Exact pair-count bound: phase 2 emits at most one pair per unit of
    # positive imbalance (bounded by edge count, NOT node count — parallel
    # biedges between one binode pair each contribute a unit); phase 1 emits
    # ceil(#odd-self-mirrors / 2) and its odd leftover consumes one in-unit
    # already counted in the positive sum.
    sm = g.self_mirror_mask()
    if logger.isEnabledFor(logging.INFO):
        # Imbalance-distribution statistics, matching the reference's
        # pre-balance log lines (mod.rs:428-479): unmatched node counts,
        # total dummies to add, and the histogram of differences 1/2/3/4
        # over non-self-mirror binodes.
        pos = diff[(diff > 0) & ~sm]
        n_sm = int(np.count_nonzero(sm & (diff != 0)))
        hist = np.bincount(np.minimum(pos, 5).astype(np.int64), minlength=6)
        logger.info(
            "Adding edges for %d unmatched in_nodes, %d unmatched "
            "out_nodes and %d unmatched self_mirror_nodes",
            len(pos),
            int(np.count_nonzero((diff < 0) & ~sm)),
            n_sm,
        )
        logger.info(
            "%d edges need to be added in total",
            (int(pos.sum()) + n_sm) // 2,
        )
        logger.info(
            "%d/%d/%d/%d binodes that are not self-mirrors have "
            "difference 1/2/3/4 (%d larger)",
            int(hist[1]), int(hist[2]), int(hist[3]), int(hist[4]),
            int(hist[5]),
        )
    bound = int(np.sum(diff[(diff > 0) & ~sm]))
    bound += (int(np.count_nonzero(sm & (diff != 0))) + 1) // 2
    capacity = max(1, bound)
    pairs = np.empty(2 * capacity, dtype=np.int64)
    p = native.as_ll_ptr
    n_pairs = lib.balance_breaking_edges(n, p(diff), p(mirror), p(pairs), capacity)
    while n_pairs == -2:  # defensive grow-and-retry; unreachable if bound holds
        capacity *= 2
        pairs = np.empty(2 * capacity, dtype=np.int64)
        n_pairs = lib.balance_breaking_edges(n, p(diff), p(mirror), p(pairs), capacity)
    if n_pairs < 0:
        raise AssertionError("balancer inconsistency (unbalanced totals)")
    if n_pairs:
        out_nodes = pairs[0 : 2 * n_pairs : 2]
        in_nodes = pairs[1 : 2 * n_pairs : 2]
        dummy_ids = np.arange(
            dummy_edge_id + 1, dummy_edge_id + n_pairs + 1, dtype=np.int64
        )
        g.add_biedge_pairs(
            src=out_nodes.astype(np.int32),
            dst=in_nodes.astype(np.int32),
            weight=np.full(n_pairs, k, dtype=np.int64),
            handle=np.full(n_pairs, -1, dtype=np.int64),
            forward=np.ones(n_pairs, dtype=bool),
            dummy_id=dummy_ids,
        )
    return dummy_edge_id + int(n_pairs)


def eulerian_bicycle_decomposition(g: Bigraph) -> list[np.ndarray]:
    """Decompose a balanced bidirected graph into Eulerian bicycles.

    Traversing an edge consumes its mirror (e ^ 1).  Below 2^31 edges and
    nodes the native parallel splice (graphwalk.cpp
    parsplice_decompose_impl) computes the splice set structurally (a
    deterministic spanning forest over pi-cycle pairs sharing a binode)
    and emits the final bicycles via concurrent piece chases, every heavy
    pass thread-parallel; past that the int64 Hierholzer walk
    (graphwalk.cpp:euler_decompose) runs.  Both yield the one bicycle per
    component minimum decomposition the reference computes
    (eulertigs/mod.rs:119 via the bigraph crate); the traversal order
    (hence the exact tig set) differs.  The tests hold it against the
    JAX package.
    """
    if g.n_edges < 2**31 - 2 and g.n_nodes < 2**31 - 2:
        return _decompose_parsplice_i32(g)
    return _eulerian_bicycle_decomposition_native(g)


def _decompose_parsplice_i32(g: Bigraph) -> list[np.ndarray]:
    import os

    from .. import native

    lib = native.load()
    E = g.n_edges
    if E == 0:
        return []
    out_off, out_edges = g.out_csr()
    dst = np.ascontiguousarray(g.dsts(), dtype=np.int32)
    mirror = np.ascontiguousarray(g.mirror_node, dtype=np.int32)
    out_off = np.ascontiguousarray(out_off, dtype=np.int64)
    oe32 = np.ascontiguousarray(out_edges, dtype=np.int32)
    cycles_out = np.empty(E, dtype=np.int64)
    offsets_out = np.empty(E, dtype=np.int64)
    n_cycles = lib.euler_decompose_parsplice(
        g.n_nodes,
        E,
        native.as_i32_ptr(dst),
        native.as_i32_ptr(mirror),
        native.as_ll_ptr(out_off),
        native.as_i32_ptr(oe32),
        min(os.cpu_count() or 1, 8),
        native.as_ll_ptr(cycles_out),
        native.as_ll_ptr(offsets_out),
    )
    if n_cycles == -1:
        raise AssertionError("open walk in balanced bidirected graph")
    if n_cycles < 0:
        raise AssertionError(f"euler_decompose_parsplice internal error {n_cycles}")
    end = int(offsets_out[n_cycles - 1]) if n_cycles else 0
    return Walks(cycles_out[:end], offsets_out[:n_cycles])


def _eulerian_bicycle_decomposition_native(g: Bigraph) -> list[np.ndarray]:
    from .. import native

    lib = native.load()
    E = g.n_edges
    if E == 0:
        return []
    out_off, out_edges = g.out_csr()
    src = np.ascontiguousarray(g.srcs(), dtype=np.int64)
    dst = np.ascontiguousarray(g.dsts(), dtype=np.int64)
    mirror = np.ascontiguousarray(g.mirror_node, dtype=np.int64)
    out_off = np.ascontiguousarray(out_off, dtype=np.int64)
    out_edges = np.ascontiguousarray(out_edges, dtype=np.int64)
    cycles_out = np.empty(E, dtype=np.int64)
    offsets_out = np.empty(E, dtype=np.int64)
    p = native.as_ll_ptr
    n_cycles = lib.euler_decompose(
        g.n_nodes,
        E,
        p(src),
        p(dst),
        p(mirror),
        p(out_off),
        p(out_edges),
        p(cycles_out),
        p(offsets_out),
    )
    if n_cycles == -1:
        raise AssertionError("open walk in balanced bidirected graph")
    if n_cycles < 0:
        raise AssertionError(f"euler_decompose internal error {n_cycles}")
    res = []
    prev = 0
    for i in range(n_cycles):
        end = int(offsets_out[i])
        res.append(cycles_out[prev:end].copy())
        prev = end
    return res


def binode_wcc_labels(g: Bigraph) -> tuple[np.ndarray, int]:
    """Mirror-connected (binode) component labels: per-node int32 labels
    of the graph whose edges are the biedge endpoints plus the (v,
    mirror v) contractions — exactly the components the Eulerian
    decomposition emits one bicycle for.  Native union-find
    (graphwalk.cpp:wcc_labels); one endpoint row per biedge PAIR (the
    mirror arc connects the mirrored endpoints, already contracted).
    Reference analog of the WCC split at
    upstream src/implementation/matchtigs/mod.rs:555-576."""
    from .. import native

    lib = native.load()
    n = g.n_nodes
    src_pairs = np.ascontiguousarray(g.srcs()[0::2], dtype=np.int32)
    dst_pairs = np.ascontiguousarray(g.dsts()[0::2], dtype=np.int32)
    mirr = np.ascontiguousarray(g.mirror_node, dtype=np.int32)
    src_all = np.concatenate([src_pairs, np.arange(n, dtype=np.int32)])
    dst_all = np.concatenate([dst_pairs, mirr])
    labels = np.empty(n, dtype=np.int32)
    n_comps = lib.wcc_labels(
        n,
        len(src_all),
        native.as_i32_ptr(np.ascontiguousarray(src_all)),
        native.as_i32_ptr(np.ascontiguousarray(dst_all)),
        native.as_i32_ptr(labels),
    )
    return labels, int(n_comps)


def wcc_part_assignment(
    g: Bigraph, n_parts: int
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic component->part assignment for the distributed
    euler+break: components ordered by descending biedge count (ties by
    label id) are dealt round-robin over parts, so every part sees a
    similar size profile.  Returns (per-node component labels,
    per-component part ids)."""
    labels, n_comps = binode_wcc_labels(g)
    cl = labels[g.srcs()[0::2]]  # component of each biedge pair
    sizes = np.bincount(cl, minlength=n_comps)
    order = np.lexsort((np.arange(n_comps), -sizes))
    part_of = np.empty(n_comps, dtype=np.int32)
    part_of[order] = np.arange(n_comps, dtype=np.int32) % n_parts
    if logger.isEnabledFor(logging.INFO):
        loads = np.bincount(part_of[cl], minlength=n_parts)
        frac = loads.max() / max(1, loads.sum())
        logger.info(
            "WCC euler distribution: %d components over %d parts, "
            "per-part biedge loads %s%s",
            int((sizes > 0).sum()),
            n_parts,
            loads.tolist(),
            (
                f" (component-capped: largest part holds {100 * frac:.0f}%"
                " of the biedges)"
                if frac > 0.6 and n_parts > 1
                else ""
            ),
        )
    return labels, part_of


def decompose_break_wcc_part(
    g: Bigraph, k: int, n_parts: int, part_id: int
) -> tuple[Walks, np.ndarray]:
    """Distributed per-WCC Eulerian decomposition + cycle break: this
    part's slice of the final tigs, plus one int64 merge key per tig.

    The balanced graph's mirror-connected components are dealt over
    ``n_parts`` (see :func:`wcc_part_assignment`); each part extracts its
    components as a subgraph under an ORDER-PRESERVING arc/node
    renumbering and runs the native parsplice with the global arc ids
    driving the splitter start set
    (graphwalk.cpp:euler_decompose_parsplice_gids).  Because every other
    parsplice phase is per-component and order-isomorphic under the
    renumbering, each slice's cycles are exactly the global run's cycles
    for those components — same content, rotation, and relative order —
    so concatenating all parts and stable-sorting by the per-cycle key
    ``class << 32 | first_arc_gid`` (class 0 = piece-assembled, 1 =
    splitterless leftover) reproduces the single-host tig stream
    byte-for-byte (:func:`merge_tig_parts`; the multiplicity of work the
    reference distributes per-WCC at matchtigs/mod.rs:555-576).

    Cycle break runs on the slice too
    (graphwalk.cpp:break_cycles_flat_cyc tags each tig with its source
    cycle); the returned keys are per-TIG (tigs of one cycle share its
    key and stay in emission order under a stable merge sort).
    """
    import os

    from .. import native

    lib = native.load()
    labels, part_of = wcc_part_assignment(g, n_parts)
    src = g.srcs()
    cl = labels[src[0::2]]
    pair_ids = np.flatnonzero(part_of[cl] == part_id).astype(np.int64)
    empty = (
        Walks(np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)),
        np.empty(0, dtype=np.int64),
    )
    if not len(pair_ids):
        return empty
    arc_ids = np.empty(2 * len(pair_ids), dtype=np.int64)
    arc_ids[0::2] = 2 * pair_ids
    arc_ids[1::2] = 2 * pair_ids + 1

    # order-preserving subgraph renumbering (nodes sorted ascending; the
    # arc set is mirror- and endpoint-closed by construction)
    sub_src = src[arc_ids]
    sub_dst = g.dsts()[arc_ids]
    nodes = np.unique(sub_src)
    lsrc = np.searchsorted(nodes, sub_src)
    ldst = np.ascontiguousarray(
        np.searchsorted(nodes, sub_dst), dtype=np.int32
    )
    lmirror = np.ascontiguousarray(
        np.searchsorted(nodes, np.asarray(g.mirror_node)[nodes]),
        dtype=np.int32,
    )
    n_loc = len(nodes)
    E = len(arc_ids)
    out_off = np.zeros(n_loc + 1, dtype=np.int64)
    np.cumsum(np.bincount(lsrc, minlength=n_loc), out=out_off[1:])
    out_edges = np.ascontiguousarray(
        np.argsort(lsrc, kind="stable"), dtype=np.int32
    )

    cycles_out = np.empty(E, dtype=np.int64)
    offsets_out = np.empty(E, dtype=np.int64)
    n_assembled = np.zeros(1, dtype=np.int64)
    p = native.as_ll_ptr
    n_cycles = lib.euler_decompose_parsplice_gids(
        n_loc,
        E,
        native.as_i32_ptr(ldst),
        native.as_i32_ptr(lmirror),
        p(out_off),
        native.as_i32_ptr(out_edges),
        min(os.cpu_count() or 1, 8),
        p(np.ascontiguousarray(arc_ids)),
        p(cycles_out),
        p(offsets_out),
        p(n_assembled),
    )
    if n_cycles < 0:
        raise AssertionError(
            f"euler_decompose_parsplice_gids error {n_cycles}"
        )
    if n_cycles == 0:
        return empty
    end = int(offsets_out[n_cycles - 1])
    flat_global = arc_ids[cycles_out[:end]]
    offsets = offsets_out[:n_cycles]
    starts = np.concatenate([[0], offsets[:-1]])
    cycle_keys = (
        (np.arange(n_cycles, dtype=np.int64) >= int(n_assembled[0])).astype(
            np.int64
        )
        << 32
    ) | flat_global[starts]

    weights = np.ascontiguousarray(g.weights(), dtype=np.int64)
    dmask = np.ascontiguousarray(g.is_dummy(), dtype=np.int8)
    flat_c = np.ascontiguousarray(flat_global)
    offs_c = np.ascontiguousarray(offsets)
    tigs_out = np.empty(end, dtype=np.int64)
    tig_off = np.empty(max(end, 1), dtype=np.int64)
    tig_cycle = np.empty(max(end, 1), dtype=np.int64)
    n_tigs = lib.break_cycles_flat_cyc(
        n_cycles,
        p(flat_c),
        p(offs_c),
        p(weights),
        native.as_i8_ptr(dmask),
        k,
        p(tigs_out),
        p(tig_off),
        p(tig_cycle),
    )
    t_end = int(tig_off[n_tigs - 1]) if n_tigs else 0
    return (
        Walks(tigs_out[:t_end], tig_off[:n_tigs]),
        cycle_keys[tig_cycle[:n_tigs]],
    )


def merge_tig_parts(parts: list[tuple[Walks, np.ndarray]]) -> Walks:
    """Merge per-part tig slices into the global single-host tig order:
    stable sort by the per-tig merge keys (unique per cycle; stability
    keeps each cycle's tigs in emission order).  Parts must cover
    disjoint component sets (any part order works — keys are global)."""
    flats = [w.flat for w, _ in parts]
    offs = [w.offsets for w, _ in parts]
    keys = np.concatenate([k for _, k in parts]) if parts else np.empty(0)
    if not len(keys):
        return Walks(np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
    lengths = np.concatenate(
        [np.diff(o, prepend=np.int64(0)) for o in offs]
    )
    flat_all = np.concatenate(flats)
    starts_all = np.cumsum(lengths) - lengths
    perm = np.argsort(keys, kind="stable")
    L = lengths[perm]
    new_off = np.cumsum(L)
    new_starts = new_off - L
    idx = (
        np.arange(len(flat_all), dtype=np.int64)
        - np.repeat(new_starts, L)
        + np.repeat(starts_all[perm], L)
    )
    return Walks(flat_all[idx], new_off)


def break_cycles(g: Bigraph, cycles: list[np.ndarray], k: int) -> Walks:
    """Rotate each bicycle so its longest dummy is first, then break at
    breaking dummies (weight >= k) and at a dummy in position 0.

    Faithful to upstream src/implementation/eulertigs/mod.rs:126-186.
    The pass is native (graphwalk.cpp:break_cycles_flat_mt); the tests
    hold it against the JAX package's cycle breaker.
    """
    import os

    from .. import native

    lib = native.load()
    if not len(cycles):
        return Walks(np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
    wk = Walks.from_list(cycles)  # no-op when the decomposition's flat form
    flat = np.ascontiguousarray(wk.flat, dtype=np.int64)
    cycle_off = np.ascontiguousarray(wk.offsets, dtype=np.int64)
    weights = np.ascontiguousarray(g.weights(), dtype=np.int64)
    dmask = np.ascontiguousarray(g.is_dummy(), dtype=np.int8)
    E = len(flat)
    tigs_out = np.empty(E, dtype=np.int64)
    tig_off = np.empty(max(E, 1), dtype=np.int64)
    n_tigs = lib.break_cycles_flat_mt(
        len(cycles),
        native.as_ll_ptr(flat),
        native.as_ll_ptr(cycle_off),
        native.as_ll_ptr(weights),
        native.as_i8_ptr(dmask),
        k,
        min(os.cpu_count() or 1, 8),
        native.as_ll_ptr(tigs_out),
        native.as_ll_ptr(tig_off),
        None,
        0,
    )
    end = int(tig_off[n_tigs - 1]) if n_tigs else 0
    return Walks(tigs_out[:end], tig_off[:n_tigs])
