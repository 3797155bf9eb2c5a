# Copied from matchtigs_tpu/capi.py; compute_tigs forwards a device and an engine to the matchtig variants.
"""Embedding API: build the tig graph from an edge list, get tigs as flat
arrays (no string I/O).

Capability-equivalent of the reference's C ABI for GGCAT integration
(upstream src/clib.rs): the caller owns unitig ids and passes graph
topology as merge operations between unitig endpoints; tigs come back as
flat signed-unitig-id arrays.

Node-numbering scheme (clib.rs:104-122): each unitig u owns 4 endpoint
slots — ``4u+0`` forward-in, ``4u+2`` forward-out, ``4u+3`` backward-in,
``4u+1`` backward-out.  ``merge_nodes(a, strand_a, b, strand_b)`` unions
a's out-endpoint with b's in-endpoint (and the mirror pair), exactly like
clib.rs:134-170.  ``build_graph`` compresses the union-find into graph
nodes, adds one biedge pair per unitig, and establishes the mirror map
(clib.rs:179-259).

``compute_tigs`` algorithm ids follow the reference's *code* (not its
stale doc comment; see SURVEY.md §2.1 F8): 1 = unitigs passthrough,
2 = pathtigs, 3 = eulertigs, 4 = matchtigs (optimal), 5 = greedy matchtigs.
Outputs: ``tigs_edges`` (signed unitig ids, negative = reverse complement,
with unitig 0 following clib's sign convention), ``tigs_inserts`` (dummy
k-mer counts, 0 for original edges), ``tigs_limits`` (prefix sums).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .algos.eulertigs import EulertigConfig, compute_eulertigs
from .algos.greedytigs import GreedytigConfig, compute_greedytigs
from .algos.matchtigs import MatchtigConfig, compute_matchtigs
from .algos.pathtigs import compute_pathtigs
from .graph.bigraph import Bigraph


def _uf_find(parent: np.ndarray, x: int) -> int:
    root = x
    while parent[root] != root:
        root = parent[root]
    while parent[x] != root:
        parent[x], x = root, parent[x]
    return root


@dataclass
class TigGraphBuilder:
    """Union-find graph builder over unitig endpoint slots."""

    unitig_amount: int
    parent: np.ndarray = field(init=False)
    graph: Bigraph | None = field(default=None, init=False)

    def __post_init__(self) -> None:
        self.parent = np.arange(self.unitig_amount * 4, dtype=np.int64)

    # endpoint slots (clib.rs:104-122)
    @staticmethod
    def _fwd_in(u: int) -> int:
        return u * 4

    @staticmethod
    def _fwd_out(u: int) -> int:
        return u * 4 + 2

    @staticmethod
    def _bwd_in(u: int) -> int:
        return u * 4 + 3

    @staticmethod
    def _bwd_out(u: int) -> int:
        return u * 4 + 1

    def merge_nodes(
        self, unitig_a: int, strand_a: bool, unitig_b: int, strand_b: bool
    ) -> None:
        """Record an edge a->b (strand True = forward variant incident)."""
        out_a = self._fwd_out(unitig_a) if strand_a else self._bwd_out(unitig_a)
        in_b = self._fwd_in(unitig_b) if strand_b else self._bwd_in(unitig_b)
        mirror_in_a = self._bwd_in(unitig_a) if strand_a else self._fwd_in(unitig_a)
        mirror_out_b = self._fwd_out(unitig_b) if not strand_b else self._bwd_out(unitig_b)
        p = self.parent
        p[_uf_find(p, out_a)] = _uf_find(p, in_b)
        p[_uf_find(p, mirror_in_a)] = _uf_find(p, mirror_out_b)

    def build_graph(self, unitig_weights: np.ndarray) -> Bigraph:
        """Compress endpoint classes into nodes; one biedge per unitig."""
        assert len(unitig_weights) == self.unitig_amount
        p = self.parent
        roots = np.asarray([_uf_find(p, i) for i in range(len(p))], dtype=np.int64)
        reps, node_of_slot = np.unique(roots, return_inverse=True)
        n_nodes = len(reps)

        u = np.arange(self.unitig_amount, dtype=np.int64)
        n1 = node_of_slot[u * 4]  # forward-in
        n2 = node_of_slot[u * 4 + 2]  # forward-out
        mirror_n2 = node_of_slot[u * 4 + 3]  # backward-in
        mirror_n1 = node_of_slot[u * 4 + 1]  # backward-out

        mirror_node = np.full(n_nodes, -1, dtype=np.int32)
        mirror_node[n1] = mirror_n1
        mirror_node[mirror_n1] = n1
        mirror_node[n2] = mirror_n2
        mirror_node[mirror_n2] = n2
        assert np.all(mirror_node >= 0)

        g = Bigraph(n_nodes, mirror_node)
        g.add_biedge_pairs(
            src=n1.astype(np.int32),
            dst=n2.astype(np.int32),
            weight=np.asarray(unitig_weights, dtype=np.int64),
            handle=u,
            forward=np.ones(self.unitig_amount, dtype=bool),
            dummy_id=np.zeros(self.unitig_amount, dtype=np.int64),
        )
        from .utils.debug import debug_checks

        if debug_checks():  # debug_assert! analogs, off in production
            assert g.verify_node_pairing()
            assert g.verify_edge_mirror_property()
        self.graph = g
        return g

    def compute_tigs(
        self,
        tig_algorithm: int,
        k: int,
        threads: int | None = None,
        device: str = "cuda",
        engine: str = "auto",
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (tigs_edges, tigs_inserts, tigs_limits) flat arrays.

        ``threads`` reaches the matchtig variants' host search — the
        reference forwards its ``threads`` argument into the algorithm
        configurations the same way (clib.rs:280-410).  ``device`` and
        ``engine`` reach the matchtig variants' search stage
        (``GreedytigConfig``): by default the card, so the C ABI raises
        without one.
        """
        assert self.graph is not None, "call build_graph first"
        g = self.graph
        if tig_algorithm == 1:
            # unitig passthrough (clib.rs:351-361): one walk per biedge pair
            flat = np.arange(0, g.n_edges, 2, dtype=np.int64)
            limits = np.arange(1, len(flat) + 1, dtype=np.int64)
        else:
            if tig_algorithm == 2:
                tigs = compute_pathtigs(g)
            elif tig_algorithm == 3:
                tigs = compute_eulertigs(g, EulertigConfig(k=k))
            elif tig_algorithm == 4:
                tigs = compute_matchtigs(
                    g,
                    MatchtigConfig(
                        k=k, host_threads=threads, device=device, engine=engine
                    ),
                )
            elif tig_algorithm == 5:
                tigs = compute_greedytigs(
                    g,
                    GreedytigConfig(
                        k=k, host_threads=threads, device=device, engine=engine
                    ),
                )
            else:
                raise ValueError(
                    f"Unknown tigs algorithm identifier {tig_algorithm}"
                )
            flat = np.asarray(tigs.flat, dtype=np.int64)
            limits = np.asarray(tigs.offsets, dtype=np.int64)

        # Vectorized flattening (clib.rs:393-407 loop semantics): signed
        # unitig id per edge, dummy k-mer insert counts, prefix-sum limits.
        sign = np.where(np.asarray(g.forwards())[flat], 1, -1)
        edges = np.asarray(g.handles())[flat] * sign
        inserts = np.where(
            np.asarray(g.is_dummy())[flat], np.asarray(g.weights())[flat], 0
        )
        return (
            edges.astype(np.int64, copy=False),
            inserts.astype(np.int64, copy=False),
            limits,
        )
