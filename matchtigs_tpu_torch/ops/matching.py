# Copied from matchtigs_tpu/ops/matching.py; greedy_accept owns its chunk list (packs it into one key array, releasing each chunk, sorts with utils/sorting.py:value_sort, scans the packed keys) in place of the native fused and chunked sorts, whose scratch lives as long as the process; without its python fallbacks: the port requires the native library.
"""Deterministic greedy matching over shortest-path candidates.

Replaces the reference's online greedy matching under fine-grained node
locks (P3/P4 in SURVEY.md §2.3;
upstream src/implementation/greedytigs/mod.rs:350-502): instead of
accepting paths in nondeterministic per-thread discovery order, all
candidate (out_node, in_node, distance) triples are gathered (from the
batched device SSSP) and accepted greedily in globally sorted
(distance, out_node, in_node) order — deterministic, lock-free, and at
least as good as an arbitrary discovery order.

The per-candidate acceptance rules mirror the reference's multiplicity
protocol exactly:
- ordinary out-node u: multiplicity -m[u] (m[u] <= 0), mirrored as
  +m[mirror(u)];
- unbalanced self-mirror nodes have multiplicity 1 on both sides;
- a mirror biedge (v == mirror(u)) consumes 2 units of u's deficit and is
  only allowed when the deficit is >= 2 (greedytigs/mod.rs:352-358);
- accepting u->v decrements u's out-deficit and v's in-surplus (and their
  mirrors symmetrically).
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.bigraph import Bigraph
from ..ops.candidates import Candidates
from ..utils.sorting import value_sort
from ..utils.tracing import NOOP


def unbalanced_nodes(g: Bigraph):
    """(out_nodes, in_node_mask, multiplicities) per the greedytig scan
    (upstream src/implementation/greedytigs/mod.rs:229-245).

    out_nodes: nodes missing outgoing biedges (diff < 0) plus unbalanced
    self-mirrors; in_node_mask: nodes missing incoming biedges (diff > 0)
    plus unbalanced self-mirrors; multiplicities: the signed diff.
    """
    diff = g.imbalances()
    sm = g.self_mirror_mask()
    node_ids = np.arange(g.n_nodes, dtype=np.int64)
    sm_unbal = sm & (diff != 0)
    out_nodes = node_ids[(diff < 0) | sm_unbal]
    in_mask = (diff > 0) | sm_unbal
    return out_nodes, in_mask, diff.copy()


def greedy_accept(
    g: Bigraph,
    candidates,  # list of Candidates chunks, Candidates, or int64 [M, 3]
    multiplicities: np.ndarray,  # signed imbalance per node (mutated)
    sp=NOOP,  # span that gets the ``released_bytes`` counter
) -> np.ndarray:
    """Accept candidate paths greedily; returns accepted [A, 3] triples.

    Candidates are sorted by (dist, out_node, in_node) before the scan, so
    the result is deterministic for a given candidate set.  The scan is
    native (native/tigs.cpp); the tests hold it against the JAX package's
    python scan.

    The candidates are CONSUMED: a list of chunks is left empty, and a
    chunk's columns are released as soon as its keys are written.  Within
    the packed ranges (ids < 2^28, dist < 128) the chunks become one key
    array (``d << 56 | u << 28 | v``) that dies on return, so acceptance
    holds at most the columns it was given plus 8 bytes a candidate, and
    nothing candidate-sized outlives it.  ``sp`` counts the bytes of
    columns and sort scratch released.
    """
    if isinstance(candidates, list):
        chunks = candidates
    elif isinstance(candidates, Candidates):
        chunks = [candidates]
    else:
        chunks = [Candidates.from_triples(np.array(candidates, dtype=np.int64))]
    del candidates
    n = sum(len(c) for c in chunks)
    released = 0
    if n == 0:
        accepted = np.empty((0, 3), dtype=np.int64)
    elif g.n_nodes < (1 << 28) and max(int(c.d.max(initial=0)) for c in chunks) < 128:
        keys, released = _pack_owned_chunks(chunks, n)
        # the radix sort's scratch: one key a candidate
        released += keys.nbytes * value_sort(keys)
        accepted = _scan_sorted_keys(g, keys, multiplicities)
        del keys
    else:
        accepted = _accept_unpacked(g, chunks, multiplicities)
    chunks.clear()
    sp.add(released_bytes=released)
    return accepted


def _accept_unpacked(g: Bigraph, chunks: list, m: np.ndarray) -> np.ndarray:
    """Ids >= 2^28 or distances >= 128: the concatenated columns in
    lexsort order, scanned natively (native/tigs.cpp); the tests hold it
    against the JAX package's python scan."""
    cat = Candidates.concat(chunks)
    chunks.clear()
    cu, cv, cd = (np.ascontiguousarray(c, dtype=np.int64) for c in (cat.u, cat.v, cat.d))
    del cat
    order = np.lexsort((cv, cu, cd))
    return _greedy_accept_native(g, order, cu, cv, cd, m)


def _pack_owned_chunks(chunks: list, n: int) -> tuple[np.ndarray, int]:
    """Pack the chunks' ``n`` triples into one unsorted key array, largest
    chunk first, releasing each chunk once its keys are written (a
    native-wrapped chunk's buffer is freed with its last column); the
    list is left empty.  Returns the keys and the bytes of columns, and
    of a key array of its own, that die with them.  The shifts and ors
    run on torch's CPU threads, in place: ``d`` is shifted, and the key
    may be the chunk's ``u`` itself."""
    chunks.sort(key=len)
    keys = _key_buffer(chunks[-1], n)
    released = 0 if keys.base is not None else keys.nbytes
    off = 0
    while chunks:
        c = chunks.pop()
        m = len(c)
        u, v, d = (
            torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64))
            for x in (c.u, c.v, c.d)
        )
        released += c.u.nbytes + c.v.nbytes + c.d.nbytes
        del c
        key = torch.from_numpy(keys[off : off + m])
        # ((d << 28 | u) << 28) | v
        torch.bitwise_or(d.bitwise_left_shift_(28), u, out=key)
        key.bitwise_left_shift_(28).bitwise_or_(v)
        del u, v, d, key
        off += m
    return keys, released


def _key_buffer(c: Candidates, n: int) -> np.ndarray:
    """Room for ``n`` keys: the chunk's own buffer where its columns are
    consecutive slices of one int64 array with that room (a native triple
    buffer, ops/sssp.py:_wrap_native_triples: the chunk's keys take its
    ``u`` slots, the other chunks' its dead ``v`` and ``d`` slots), else a
    new array.  A new candidate-sized block from the CLI's heap stays
    resident after it dies (utils/malloc_tuning.py) and lifts the RSS
    that balance, Euler and write start from."""
    base, m = c.u.base, len(c)
    if (
        isinstance(base, np.ndarray)
        and base.dtype == np.int64
        and base.ndim == 1
        and base.flags.c_contiguous
        and c.v.base is base
        and c.d.base is base
        and all(x.dtype == np.int64 and x.flags.c_contiguous for x in (c.u, c.v, c.d))
        and c.v.ctypes.data == c.u.ctypes.data + 8 * m
        and c.d.ctypes.data == c.v.ctypes.data + 8 * m
    ):
        start = (c.u.ctypes.data - base.ctypes.data) // 8
        if start + n <= len(base):
            return base[start : start + n]
    return np.empty(n, dtype=np.int64)


def pack_accept_keys(chunks) -> np.ndarray | None:
    """Pack candidate chunks into the acceptance sort key
    (``d << 56 | u << 28 | v``, int64, unsorted) — the exchange format of
    the mesh-sharded acceptance sort (parallel/mesh.py).  None when the
    ids/dists exceed the packed ranges."""
    live = [c for c in chunks if len(c)]
    if not live:
        return np.empty(0, dtype=np.int64)
    if any(int(c.d.max(initial=0)) >= 128 for c in live):
        return None
    if any(
        int(c.u.max(initial=0)) >= (1 << 28)
        or int(c.v.max(initial=0)) >= (1 << 28)
        for c in live
    ):
        return None
    return np.concatenate(
        [
            (c.d.astype(np.int64) << 56)
            | (c.u.astype(np.int64) << 28)
            | c.v.astype(np.int64)
            for c in live
        ]
    )


def greedy_accept_sorted_keys(
    g: Bigraph, keys: np.ndarray, m: np.ndarray
) -> np.ndarray:
    """Acceptance scan over PRE-SORTED packed keys (``d << 56 | u << 28 |
    v``) after a range check of their node ids.  The consumer of the
    mesh-sharded acceptance sort; identical accepted set as greedy_accept
    on the unpacked triples (parity-tested).  Mutates ``m``; returns
    accepted [A, 3] triples."""
    if len(keys) == 0:
        return np.empty((0, 3), dtype=np.int64)
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    mask28 = np.uint64((1 << 28) - 1)
    u_max = int(((keys >> np.uint64(28)) & mask28).max())
    v_max = int((keys & mask28).max())
    if max(u_max, v_max) >= g.n_nodes:
        raise ValueError(
            f"packed key node id {max(u_max, v_max)} out of range "
            f"(n_nodes={g.n_nodes})"
        )
    return _scan_sorted_keys(g, keys, m)


def _scan_sorted_keys(g: Bigraph, keys: np.ndarray, m: np.ndarray) -> np.ndarray:
    """The packed MT scan (native/tigs.cpp:greedy_accept_scan_packed_mt)
    over sorted in-range keys, int64 or uint64: only the accepted triples
    are unpacked.  It runs on a private copy of ``m``, copied back on
    success.  Under the mirror invariant (m[mirror[x]] == -m[x];
    self-mirror m in [0, 1]) every accept consumes >= 1 unit of total
    out-deficit, which bounds the output; an input that breaks the
    invariant reruns with room for every candidate."""
    import ctypes
    import os

    from .. import native

    lib = native.load()
    m64 = np.array(m, dtype=np.int64)
    sm = np.ascontiguousarray(g.self_mirror_mask(), dtype=np.int8)
    deficit = np.where(sm != 0, np.maximum(m64, 0), np.maximum(-m64, 0))
    mirror = np.ascontiguousarray(g.mirror_node, dtype=np.int64)
    p = native.as_ll_ptr
    for cap in (min(int(deficit.sum()) + 1, len(keys)), len(keys)):
        m64[:] = m
        u_out = np.empty(cap, dtype=np.int64)
        v_out = np.empty(cap, dtype=np.int64)
        d_out = np.empty(cap, dtype=np.int64)
        n_acc = lib.greedy_accept_scan_packed_mt(
            len(keys),
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_ulonglong)),
            p(m64), p(mirror), native.as_i8_ptr(sm),
            p(u_out), p(v_out), p(d_out), cap,
            min(os.cpu_count() or 1, 16), 1 << 19,
        )
        if n_acc != -2:
            break
    if n_acc < 0:
        raise RuntimeError(f"packed acceptance scan failed ({n_acc})")
    m[:] = m64
    return np.stack(
        [u_out[:n_acc], v_out[:n_acc], d_out[:n_acc]], axis=1
    )


def _greedy_accept_native(
    g: Bigraph,
    order: np.ndarray,
    cu: np.ndarray,
    cv: np.ndarray,
    cd: np.ndarray,
    m: np.ndarray,
) -> np.ndarray:
    """Scan candidates in ``order`` (native/tigs.cpp:greedy_accept_scan_perm);
    returns accepted [A, 3] rows in original coordinates."""
    from .. import native

    lib = native.load()
    order = np.ascontiguousarray(order, dtype=np.int64)
    m64 = np.ascontiguousarray(m, dtype=np.int64)
    mirror = np.ascontiguousarray(g.mirror_node, dtype=np.int64)
    sm = np.ascontiguousarray(g.self_mirror_mask(), dtype=np.int8)
    accepted = np.empty(len(cu), dtype=np.int64)
    p = native.as_ll_ptr
    n_acc = lib.greedy_accept_scan_perm(
        len(cu), p(order), p(cu), p(cv), p(cd),
        p(m64), p(mirror), native.as_i8_ptr(sm), p(accepted),
    )
    m[:] = m64  # propagate multiplicity updates to the caller's array
    sel = accepted[:n_acc]
    return np.stack([cu[sel], cv[sel], cd[sel]], axis=1)
