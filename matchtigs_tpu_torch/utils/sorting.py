# Copied from matchtigs_tpu/utils/sorting.py; value_sort is the JAX package's algos/matchtigs.py:_value_sort; without its python fallbacks: the port requires the native library.
"""Shared sorting primitives backed by the native runtime.

``value_sort`` sorts the acceptance keys of greedy matchtigs.
``stable_order`` is the CSR-bucketing step used by the incremental CSR
(graph/bigraph.py) and the padded device adjacency (ops/device_graph.py):
numpy's single-threaded ``argsort(kind="stable")`` over 22.8M int32 edge
keys cost ~2.1s per full build at the 60M-base scale; the native
two-level MT counting sort (native/radix.cpp:stable_order_i32) is
bit-identical and ~10x faster.
"""

from __future__ import annotations

import numpy as np

_NATIVE_MIN = 1 << 16


def stable_order(keys: np.ndarray, n_keys: int) -> np.ndarray:
    """``np.argsort(keys, kind="stable").astype(np.int64)`` for int32
    keys in ``[0, n_keys)``; natively multithreaded at scale."""
    if len(keys) >= _NATIVE_MIN and keys.dtype == np.int32 and n_keys > 0:
        import os

        from .. import native

        keys = np.ascontiguousarray(keys)
        order = np.empty(len(keys), dtype=np.int64)
        native.load().stable_order_i32(
            len(keys),
            native.as_i32_ptr(keys),
            n_keys,
            native.as_ll_ptr(order),
            min(os.cpu_count() or 1, 16),
        )
        return order
    return np.argsort(keys, kind="stable").astype(np.int64)


def value_sort(keys: np.ndarray) -> bool:
    """In-place ascending value sort of non-negative int64 keys: the
    native MT radix sort at scale (native/radix.cpp:radix_sort_i64, its
    scratch of one key each malloc'd and freed within the call), np.sort
    otherwise (identical order).  True when the radix sort ran."""
    if len(keys) >= (1 << 20):
        import os

        from .. import native

        if native.load().radix_sort_i64(
            len(keys), native.as_ll_ptr(keys), min(os.cpu_count() or 1, 16)
        ) == 0:
            return True
    keys.sort()
    return False
