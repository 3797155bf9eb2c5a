# Copied from matchtigs_tpu/graph/build.py, plus _connected_component_labels from algos/matchtigs.py; (k-1)-mers of 32-62 bases are deduplicated as two uint64 words (_unique_two_words: the same order, so the same node ids); without its python fallbacks: the port requires the native library.
"""Build the bidirected de Bruijn node graph from unitig sequences.

Capability-equivalent of ``genome-graph``'s edge-centric readers
(upstream src/bin.rs:31-43,874-915): unitig endpoints that share a
(k-1)-mer (in either orientation) become the same graph node.  Instead of
hash-map pointer chasing, endpoint (k-1)-mers are packed into fixed-width
integer rows and deduplicated with one vectorized ``np.unique`` — the
node table, mirror map, and the full biedge list fall out of the inverse
permutation.
"""

from __future__ import annotations

import numpy as np

from ..io.sequence_store import SequenceStore
from ..utils.tracing import span
from .bigraph import Bigraph


def _pack_rows(kmers: np.ndarray) -> np.ndarray:
    """Pack uint8 [n, m] code rows into sortable keys for np.unique.

    m <= 31 packs into uint64 (fast integer unique); larger m falls back to
    void-dtype rows (lexicographic, arbitrary length).
    """
    kmers = np.ascontiguousarray(kmers)
    m = kmers.shape[1]
    if m <= 31:
        return _horner(kmers)
    return kmers.view([("", kmers.dtype)] * m).reshape(-1)


def _horner(kmers: np.ndarray) -> np.ndarray:
    """uint64 keys of uint8 [n, m] code rows, m <= 32, first base most
    significant.  Horner over transposed contiguous columns: converting the
    whole [n, m] matrix to uint64 up front costs 8x the memory (7.5 GB at
    31M endpoint kmers) and strided column reads dominated 60M-scale graph
    builds (~190s); this is a few sequential passes."""
    kt = np.ascontiguousarray(kmers.T)
    out = np.zeros(kmers.shape[0], dtype=np.uint64)
    for col in kt:
        np.left_shift(out, np.uint64(2), out=out)
        out |= col
    return out


def _unique_two_words(kmers: np.ndarray) -> tuple[int, np.ndarray]:
    """(distinct rows, inverse) of uint8 [n, m] code rows, 32 <= m <= 62,
    as ``np.unique`` of their structured rows gives them: each row as two
    uint64 words (hi: its first m - 32 bases, lo: its last 32), whose
    numeric order is the rows' lexicographic order, sorted by one lexsort
    instead of a comparison sort over m byte fields."""
    m = kmers.shape[1]
    hi, lo = _horner(kmers[:, : m - 32]), _horner(kmers[:, m - 32:])
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    new = np.ones(len(order), dtype=bool)
    new[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    inverse = np.empty(len(order), dtype=np.int64)
    inverse[order] = np.cumsum(new) - 1
    return int(new.sum()), inverse


def _rc_packed(packed: np.ndarray, m: int) -> np.ndarray:
    """Reverse-complement packed 2-bit keys without touching base arrays.

    ``packed`` holds m two-bit codes in the low 2m bits, first base most
    significant.  Complementing a code is ``c ^ 3``, so rc = reverse the
    2-bit groups of the word (log-shuffle), realign, and XOR the 2m-bit
    mask — ~10 vectorized uint64 ops instead of materializing the [n, m]
    reversed-complement byte matrix and re-running the Horner pack.
    """
    x = packed.copy()
    u = np.uint64
    # reverse the 32 2-bit groups of each word
    x = ((x & u(0x3333333333333333)) << u(2)) | ((x >> u(2)) & u(0x3333333333333333))
    x = ((x & u(0x0F0F0F0F0F0F0F0F)) << u(4)) | ((x >> u(4)) & u(0x0F0F0F0F0F0F0F0F))
    x = ((x & u(0x00FF00FF00FF00FF)) << u(8)) | ((x >> u(8)) & u(0x00FF00FF00FF00FF))
    x = ((x & u(0x0000FFFF0000FFFF)) << u(16)) | ((x >> u(16)) & u(0x0000FFFF0000FFFF))
    x = (x << u(32)) | (x >> u(32))
    x >>= u(2 * (32 - m))
    x ^= u((1 << (2 * m)) - 1)
    return x


def unique_with_inverse(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """np.unique(packed, return_inverse=True), natively multithreaded.

    For large uint64 key arrays this routes to the radix-partitioned
    native pass (native/radix.cpp) — np.unique's comparison sort + inverse
    scatter was 29.5s of a 52s graph build at the 60M-base scale.  Output
    is bit-identical to np.unique (ascending unique keys, int32-safe
    inverse).  Structured (two-word) keys and small inputs use numpy.
    """
    if packed.dtype == np.uint64 and len(packed) >= (1 << 16):
        import ctypes
        import os

        from .. import native

        n = len(packed)
        packed = np.ascontiguousarray(packed)
        uniq = np.empty(n, dtype=np.uint64)
        inverse = np.empty(n, dtype=np.int32)
        n_uniq = int(
            native.load().unique_u64_inverse(
                n,
                native.as_u64_ptr(packed),
                native.as_u64_ptr(uniq),
                inverse.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                min(os.cpu_count() or 1, 16),
            )
        )
        return uniq[:n_uniq], inverse
    uniq, inverse = np.unique(packed, return_inverse=True)
    return uniq, inverse


def build_bigraph_from_unitigs(store: SequenceStore, k: int) -> Bigraph:
    """Construct the node bigraph: one biedge (edge pair) per unitig.

    Node identity is the *oriented* (k-1)-mer; mirror(node) is the node of
    the reverse complement; prefix/suffix endpoints of each unitig and of
    its reverse complement define the four endpoint references per unitig.
    """
    with span("load.build"):
        return _build_from_unitigs(store, k)


def _build_from_unitigs(store: SequenceStore, k: int) -> Bigraph:
    km1 = k - 1
    n_uni = len(store)
    if n_uni == 0:
        return Bigraph(0, np.empty(0, dtype=np.int32))

    with span("load.build.keys") as sp:
        offsets = store.offsets
        lengths = offsets[1:] - offsets[:-1]
        if np.any(lengths < k):
            bad = int(np.argmax(lengths < k))
            raise ValueError(
                f"Unitig {bad} has length {int(lengths[bad])} < k={k}"
            )

        # Endpoint (k-1)-mer node keys: pref, suff, rc(pref), rc(suff).
        if km1 <= 31:
            # keys read straight from the 2-bit arena as bit-sliced words (no
            # [U, k-1] byte matrices at all); rc keys derived arithmetically.
            p_pref = store.packed_windows(offsets[:-1], km1)
            p_suff = store.packed_windows(offsets[1:] - km1, km1)
            packed = np.concatenate(
                [p_pref, p_suff, _rc_packed(p_pref, km1), _rc_packed(p_suff, km1)]
            )
        else:
            with span("load.build.keys.gather") as gather:
                pref = store.gather_windows(offsets[:-1], km1)  # [U, k-1]
                suff = store.gather_windows(offsets[1:] - km1, km1)  # [U, k-1]
                rc_pref = (3 - pref)[:, ::-1]
                rc_suff = (3 - suff)[:, ::-1]
                all_kmers = np.concatenate([pref, suff, rc_pref, rc_suff], axis=0)
                gather.add(bytes=all_kmers.nbytes)
            packed = None if km1 <= 62 else _pack_rows(all_kmers)
        # 64-bit words a node key takes: 1 packed, 2 as two words, 0 as byte rows
        sp.add(keys=4 * n_uni, key_words=1 if km1 <= 31 else 2 if km1 <= 62 else 0)
    with span("load.build.nodes") as sp:
        if packed is None:
            with span("load.build.nodes.two_word") as two_word:
                n_nodes, inverse = _unique_two_words(all_kmers)
                two_word.add(rows=len(all_kmers))
        else:
            uniq, inverse = unique_with_inverse(packed)
            n_nodes = len(uniq)
        inverse = inverse.astype(np.int32, copy=False).reshape(4, n_uni)
        node_pref, node_suff, node_rc_pref, node_rc_suff = inverse
        sp.add(nodes=n_nodes)

    with span("load.build.edges") as sp:
        # mirror(n(x)) = n(rc(x)).  Each oriented kmer x appears in the first
        # half (pref/suff) or second half (rc) of `all_kmers`; its rc appears
        # in the opposite half at the same unitig slot.
        mirror_node = np.full(n_nodes, -1, dtype=np.int32)
        mirror_node[node_pref] = node_rc_pref
        mirror_node[node_suff] = node_rc_suff
        mirror_node[node_rc_pref] = node_pref
        mirror_node[node_rc_suff] = node_suff
        assert np.all(mirror_node >= 0)

        g = Bigraph(n_nodes, mirror_node)
        handles = np.arange(n_uni, dtype=np.int64)
        weights = (lengths + 1 - k).astype(np.int64)
        g.add_biedge_pairs(
            src=node_pref,
            dst=node_suff,
            weight=weights,
            handle=handles,
            forward=np.ones(n_uni, dtype=bool),
            dummy_id=np.zeros(n_uni, dtype=np.int64),
        )
        from ..utils.debug import debug_checks

        if debug_checks():  # debug_assert! analog, off in production
            assert g.verify_node_pairing()
        sp.add(edges=g.n_edges)
    return g


def _connected_component_labels(n: int, rows, cols) -> np.ndarray:
    """Undirected connected-component labels (0..n_comps-1, ascending by
    the component's minimum node id — scipy's labeling).  Native
    union-find (graphwalk.cpp:wcc_labels; ~0.5s vs scipy's ~7s over 19M
    edges at 60M-base scale); the tests hold it against the JAX
    package's graph build."""
    from .. import native

    lib = native.load()
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    labels = np.empty(n, dtype=np.int32)
    lib.wcc_labels(
        n,
        len(rows),
        native.as_i32_ptr(rows),
        native.as_i32_ptr(cols),
        native.as_i32_ptr(labels),
    )
    return labels


def build_bigraph_from_links(store: SequenceStore, links, k: int) -> Bigraph:
    """Construct the node bigraph from explicit topology links.

    The reference's GFA/BCALM2 input path (L-lines / header annotations,
    upstream src/bin.rs:874-915): unitig endpoints are merged by
    union-find over 4 endpoint slots per unitig (the clib.rs:104-122
    numbering), rather than by (k-1)-mer hashing.  For true compacted de
    Bruijn unitig sets both constructions agree; this path skips sequence
    hashing entirely.

    ``links`` is an :class:`matchtigs_tpu_torch.io.readers.Links` column
    container (or any iterable of (a, sa, b, sb) rows).  The slot merge
    runs through the native union-find (graphwalk.cpp:wcc_labels; the
    per-link python find/union loop cost minutes over the ~15M links of
    a 60M-base BCALM2 file).
    """
    with span("load.build"):
        return _build_from_links(store, links, k)


def _build_from_links(store: SequenceStore, links, k: int) -> Bigraph:
    from ..io.readers import Links

    links = Links.from_rows(links) if not isinstance(links, Links) else links
    n_uni = len(store)
    if len(links) and (
        links.a.min(initial=0) < 0
        or links.b.min(initial=0) < 0
        or links.a.max(initial=-1) >= n_uni
        or links.b.max(initial=-1) >= n_uni
    ):
        raise ValueError("link references a unitig id out of range")
    a4 = links.a * 4
    b4 = links.b * 4
    # slot numbering per unitig: 0 = in(+), 1 = out(-), 2 = out(+),
    # 3 = in(-); a link (a, sa) -> (b, sb) merges a's outgoing slot with
    # b's incoming slot, and symmetrically for the mirror orientation.
    out_a = a4 + np.where(links.sa, 2, 1)
    in_b = b4 + np.where(links.sb, 0, 3)
    mirror_in_a = a4 + np.where(links.sa, 3, 0)
    mirror_out_b = b4 + np.where(links.sb, 1, 2)
    src = np.concatenate([out_a, mirror_in_a]).astype(np.int32)
    dst = np.concatenate([in_b, mirror_out_b]).astype(np.int32)
    node_of_slot = _connected_component_labels(n_uni * 4, src, dst).astype(
        np.int64
    )
    n_nodes = int(node_of_slot.max(initial=-1)) + 1

    u = np.arange(n_uni, dtype=np.int64)
    n1 = node_of_slot[u * 4]
    n2 = node_of_slot[u * 4 + 2]
    mirror_n2 = node_of_slot[u * 4 + 3]
    mirror_n1 = node_of_slot[u * 4 + 1]
    mirror_node = np.full(n_nodes, -1, dtype=np.int32)
    mirror_node[n1] = mirror_n1
    mirror_node[mirror_n1] = n1
    mirror_node[n2] = mirror_n2
    mirror_node[mirror_n2] = n2
    assert np.all(mirror_node >= 0)

    g = Bigraph(n_nodes, mirror_node)
    lengths = store.offsets[1:] - store.offsets[:-1]
    g.add_biedge_pairs(
        src=n1.astype(np.int32),
        dst=n2.astype(np.int32),
        weight=(lengths + 1 - k).astype(np.int64),
        handle=u,
        forward=np.ones(n_uni, dtype=bool),
        dummy_id=np.zeros(n_uni, dtype=np.int64),
    )
    from ..utils.debug import debug_checks

    if debug_checks():  # debug_assert! analogs, off in production
        assert g.verify_node_pairing()
        assert g.verify_edge_mirror_property()
    return g


def compute_edge_weights(g: Bigraph, store: SequenceStore, k: int) -> None:
    """Set edge weight = k-mer count = len(seq) + 1 - k.

    Mirrors ``compute_edge_weights`` (upstream src/bin.rs:357-379).
    Weights are already set by the builder; this recomputes them (used when
    a graph was loaded with zero weights).
    """
    n = g.n_edges
    handles = g.handles()[:n]
    lengths = (store.offsets[1:] - store.offsets[:-1])[handles]
    w = lengths + 1 - k
    assert np.all(w > 0), "found sequence shorter than k"
    g.edge_weight[:n] = w
