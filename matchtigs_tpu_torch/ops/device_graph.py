# Copied from matchtigs_tpu/ops/device_graph.py; device_buffers returns torch tensors; without its python fallbacks: the port requires the native library.
"""Device-resident graph arrays for the shortest-path phase.

The bidirected de Bruijn *node* graph has out-degree <= 4 (each out-edge
is a unitig whose first k-mer extends the node's (k-1)-mer by one of four
bases, and first k-mers are unique across unitigs).  That makes a dense
padded adjacency ``[N, 4]`` the natural device layout — every frontier
expansion is one 16-byte row load, no CSR offset indirection.

This replaces the reference's pointer graph + per-thread Dijkstra state
(upstream src/implementation/greedytigs/mod.rs:276-526) with arrays
that live in device memory once and are shared by every batched search.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..graph.bigraph import Bigraph
from ..utils.tracing import span

MAX_DEGREE = 4

# Packed-adjacency layout: one int32 per slot, neighbor id in the high
# bits and the edge weight (clamped to ADJ_W_MASK = "unusable") in the low
# ADJ_W_BITS.  Halves both the host->device adjacency upload and the
# kernel's device-memory gather traffic (one [S, C, deg] gather instead
# of two).  Usable whenever node ids fit 31 - ADJ_W_BITS bits and the
# search bound is below the weight clamp (max_weight < ADJ_W_MASK: any
# clamped weight then exceeds the bound exactly like the original).
ADJ_W_BITS = 7
ADJ_W_MASK = (1 << ADJ_W_BITS) - 1


@dataclass
class DeviceGraph:
    """Padded adjacency: nbr[v, j] = j-th successor node (or N = sentinel),
    nw[v, j] = edge weight (or a large sentinel weight).

    When built with ``renumber=True`` the rows are in reverse-Cuthill-McKee
    order (gather locality: neighboring nodes sit in neighboring rows);
    `to_dev` / `to_orig` translate node ids in and out of that order.
    """

    n_nodes: int
    nbr: np.ndarray  # int32 [N + 1, deg_pad]; row N is the sentinel row
    nw: np.ndarray  # int32 [N + 1, deg_pad]
    deg_pad: int
    to_dev: np.ndarray | None = None  # int32 [N]: original -> device id
    to_orig: np.ndarray | None = None  # int32 [N]: device -> original id
    # adjacency per (torch device, layout), uploaded on first use
    _adj_on: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def sentinel(self) -> int:
        return self.n_nodes

    @property
    def can_pack_adj(self) -> bool:
        """Node ids (incl. the sentinel row) fit the packed-slot layout."""
        return self.n_nodes < (1 << (31 - ADJ_W_BITS))

    def packed_adjacency(self) -> np.ndarray:
        """One ``(nbr << ADJ_W_BITS) | min(nw, ADJ_W_MASK)`` int32 per
        slot, ``[N + 1, deg_pad]``: the kernel's only graph operand.
        Searches bounded below ADJ_W_MASK see clamped weights exceed the
        bound exactly like their originals (ops/sssp.py enforces this)."""
        if not self.can_pack_adj:
            raise ValueError("node ids exceed the packed-slot layout")
        return (self.nbr.astype(np.int32) << ADJ_W_BITS) | np.minimum(
            self.nw, ADJ_W_MASK
        ).astype(np.int32)

    def device_buffers(self, device: torch.device | str, adj_packed: bool = True):
        """The adjacency on ``device``, uploaded once per graph, device and
        layout: repeated stages reuse it instead of re-shipping it.

        ``adj_packed`` returns the packed int32 ``[N + 1, deg_pad]`` tensor;
        ``adj_packed=False`` returns the unpacked int32 ``(nbr, nw)`` pair,
        which serves searches bounded at or above ADJ_W_MASK (k >= 128) and
        graphs whose node ids exceed the packed layout."""
        key = (str(torch.device(device)), adj_packed)
        buf = self._adj_on.get(key)
        if buf is None:
            with span("search.upload") as sp:
                if adj_packed:
                    buf = torch.from_numpy(self.packed_adjacency()).to(device)
                else:
                    buf = tuple(
                        torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
                        for a in (self.nbr, self.nw)
                    )
                sp.add(bytes=sum(t.nbytes for t in (buf if isinstance(buf, tuple) else (buf,))))
            self._adj_on[key] = buf
        return buf

    def map_sources(self, sources: np.ndarray) -> np.ndarray:
        return sources if self.to_dev is None else self.to_dev[sources]

    def unmap_nodes(self, nodes: np.ndarray) -> np.ndarray:
        """Map device node ids (incl. the sentinel) back to original ids.

        Returns int64 (the candidate-column dtype) so callers can use the
        result directly in packed-key arithmetic."""
        if self.to_orig is None:
            return nodes
        ext = np.append(self.to_orig.astype(np.int64), np.int64(self.n_nodes))
        return ext[nodes]


def build_device_graph(
    g: Bigraph, weight_cap: int = 1 << 20, renumber: bool = False
) -> DeviceGraph:
    """Pack the (original-edge) adjacency into padded [N+1, deg] arrays.

    Memoized per graph while the edge set is unchanged: benchmark and
    algorithm code paths otherwise rebuild (and RCM-renumber, seconds at
    10M nodes) the same packing twice per run."""
    cache = getattr(g, "_device_graph_cache", None)
    cache_key = (g.n_nodes, g.n_edges, weight_cap, renumber)
    if cache is not None and cache[0] == cache_key:
        return cache[1]
    dg = _build_device_graph(g, weight_cap, renumber)
    g._device_graph_cache = (cache_key, dg)
    return dg


def _fill_padded_adj(g, n, src, dst, w, deg_pad, weight_cap):
    """Fill the padded [N+1, deg_pad] adjacency: the native MT node-range
    pass (graphwalk.cpp:fill_padded_adj, deterministic edge-id slot
    order; an empty edge list gives the sentinel rows).  The tests hold
    it against the JAX package's device graph."""
    import os

    from .. import native

    nbr = np.empty((n + 1, deg_pad), dtype=np.int32)
    nw = np.empty((n + 1, deg_pad), dtype=np.int32)
    src32 = np.ascontiguousarray(src, dtype=np.int32)
    dst32 = np.ascontiguousarray(dst, dtype=np.int32)
    w64 = np.ascontiguousarray(w, dtype=np.int64)
    overflow = native.load().fill_padded_adj(
        n,
        len(src32),
        native.as_i32_ptr(src32),
        native.as_i32_ptr(dst32),
        native.as_ll_ptr(w64),
        deg_pad,
        weight_cap,
        min(os.cpu_count() or 1, 16),
        native.as_i32_ptr(nbr),
        native.as_i32_ptr(nw),
    )
    assert overflow == 0, "deg_pad undersized for the degree sequence"
    return nbr, nw


def _build_device_graph(
    g: Bigraph, weight_cap: int, renumber: bool
) -> DeviceGraph:
    n = g.n_nodes
    src = g.srcs()
    dst = g.dsts()
    w = np.minimum(g.weights(), weight_cap).astype(np.int32)

    to_dev = to_orig = None
    if renumber and n > 1 and len(src):
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        adj = coo_matrix(
            (np.ones(len(src), np.int8), (src, dst)), shape=(n, n)
        ).tocsr()
        perm = reverse_cuthill_mckee(adj, symmetric_mode=False)
        to_orig = perm.astype(np.int32)
        to_dev = np.empty(n, dtype=np.int32)
        to_dev[to_orig] = np.arange(n, dtype=np.int32)
        src = to_dev[src]
        dst = to_dev[dst]

    deg = np.bincount(src, minlength=n)
    deg_pad = max(MAX_DEGREE, int(deg.max(initial=0)))
    nbr, nw = _fill_padded_adj(g, n, src, dst, w, deg_pad, weight_cap)
    return DeviceGraph(
        n_nodes=n,
        nbr=nbr,
        nw=nw,
        deg_pad=deg_pad,
        to_dev=to_dev,
        to_orig=to_orig,
    )
