"""matchtigs_tpu_torch: matchtigs on PyTorch + CUDA.

The port of ``matchtigs_tpu`` (JAX) to NVIDIA Hopper: the bounded
shortest-path search of greedy and optimal matchtigs runs as hand-written
CUDA kernels (``csrc/sssp_pool.cu``, ``csrc/sssp_wide.cu``,
``csrc/sssp_compact.cu``) in every single-device mode, and over a mesh of
devices and processes (``parallel/mesh.py``, with the acceptance sort in
``csrc/mesh_sort.cu``); pathtigs and eulertigs are host-only, as in the
JAX package, and ``capi.py`` with ``native/capi_embed.c`` is the C ABI.
The host layers (io, graph, matching, the blossom front end, Euler
decomposition, the native C++ library) are copies of the JAX package's,
so this package imports neither ``jax`` nor ``matchtigs_tpu``; they keep
no python fallbacks, so the port requires the native library, which the
first pass that needs it builds and loads (``native.load``).
"""

from .graph.bigraph import Bigraph
from .graph.build import (
    build_bigraph_from_links,
    build_bigraph_from_unitigs,
    compute_edge_weights,
)
from .io.sequence_store import SequenceStore
from .io.readers import load_unitigs, read_fasta, read_gfa
from .io.writers import (
    spell_walk,
    spelled_length,
    write_duplication_bitvector,
    write_walks_fasta,
    write_walks_gfa,
)
from .algos.pathtigs import compute_pathtigs
from .algos.eulertigs import EulertigConfig, compute_eulertigs
from .algos.greedytigs import GreedytigConfig, compute_greedytigs
from .algos.matchtigs import MatchtigConfig, compute_matchtigs
from .capi import TigGraphBuilder

__version__ = "0.1.0"
